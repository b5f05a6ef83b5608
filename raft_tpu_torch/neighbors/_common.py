"""Shared helpers of the inverted-list indexes (subset port of
``raft_tpu/neighbors/_common.py``: ``chunk_layout`` :42, the device pack of
``_build.py:254`` ``pack_device``, ``expand_probes`` :340,
``scan_probe_lists`` :425, ``empty_result``, ``subsample_trainset``).

The chunk-table arithmetic is (n_lists,)-shaped numpy host work, the same
code as the JAX package's, so equal labels give equal layouts; per-row
data stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.matrix.select_k import merge_sorted_runs, select_k

#: width from which scan_probe_lists stacks the masked tiles and runs one
#: wide select instead of the running per-step merge
_SCAN_STACK_MIN_K = 24
#: chunk capacity: this quantile of the nonzero list sizes, rounded up to 8
_CAP_QUANTILE = 0.9


@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """Chunked-list layout derived from (n_lists,) counts alone."""

    cap: int                    # per-chunk capacity (multiple of 8)
    n_phys: int                 # real physical rows (block has n_phys + 1)
    counts: np.ndarray          # (n_lists,) int64 logical sizes
    chunk_table: np.ndarray     # (n_lists, max_chunks) int32, dummy-padded
    phys_sizes: np.ndarray      # (n_phys + 1,) int32


def chunk_layout(counts: np.ndarray) -> ChunkLayout:
    """Layout from logical list sizes: capacity is the 90th percentile of
    the nonzero sizes rounded up to 8; a list spans ceil(size / cap)
    physical rows (empty lists keep one); the last physical row is an
    empty dummy that padding entries of the chunk table point at."""
    counts = np.asarray(counts).astype(np.int64)
    n_lists = counts.shape[0]
    nz = counts[counts > 0]
    q = int(np.percentile(nz, _CAP_QUANTILE * 100)) if nz.size else 8
    cap = max(8, -(-q // 8) * 8)
    n_chunks = np.maximum(-(-counts // cap), 1)
    max_chunks = int(n_chunks.max()) if n_lists else 1
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(n_chunks, out=starts[1:])
    n_phys = int(starts[-1])
    dummy = n_phys

    owner = np.zeros(n_phys + 1, np.int32)
    owner[:n_phys] = np.repeat(np.arange(n_lists, dtype=np.int32), n_chunks)
    chunk_ord = np.arange(n_phys) - starts[owner[:n_phys]]
    phys_sizes = np.zeros(n_phys + 1, np.int32)
    phys_sizes[:n_phys] = np.minimum(
        cap, np.maximum(0, counts[owner[:n_phys]] - chunk_ord * cap))
    chunk_table = np.full((n_lists, max_chunks), dummy, np.int32)
    chunk_table[owner[:n_phys], chunk_ord] = np.arange(n_phys,
                                                       dtype=np.int32)
    return ChunkLayout(cap=cap, n_phys=n_phys, counts=counts,
                       chunk_table=chunk_table, phys_sizes=phys_sizes)


def ranks_within(labels: torch.Tensor, n_lists: int) -> torch.Tensor:
    """rank[i] = position of row i within its label's group (stable)."""
    n = labels.shape[0]
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    start = torch.searchsorted(
        sorted_labels, torch.arange(n_lists, device=labels.device,
                                    dtype=sorted_labels.dtype))
    rank = torch.empty(n, dtype=torch.int64, device=labels.device)
    rank[order] = torch.arange(n, device=labels.device) - start[sorted_labels]
    return rank


def pack_lists(payload: torch.Tensor, ids: torch.Tensor,
               labels: torch.Tensor, n_lists: int):
    """Scatter rows into chunked padded blocks (the device pack of a fresh
    index).  Returns (data (n_phys+1, cap, …), idx (n_phys+1, cap) int32
    −1-padded, phys_sizes, list_sizes, chunk_table); the (n_lists,) counts
    are the only per-list data that reach the host."""
    n = payload.shape[0]
    dev = payload.device
    labels = labels.long()
    counts = (torch.bincount(labels, minlength=n_lists).cpu().numpy()
              if n else np.zeros(n_lists, np.int64))
    lay = chunk_layout(counts)
    cap = lay.cap
    table = torch.as_tensor(lay.chunk_table, device=dev)
    rows = (lay.n_phys + 1) * cap
    data = torch.zeros((rows,) + tuple(payload.shape[1:]), dtype=payload.dtype,
                       device=dev)
    idx = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    if n:
        rank = ranks_within(labels, n_lists)
        flat = table[labels, rank // cap].long() * cap + rank % cap
        data[flat] = payload
        idx[flat] = ids.to(torch.int32)
    return (data.reshape((lay.n_phys + 1, cap) + tuple(payload.shape[1:])),
            idx.reshape(lay.n_phys + 1, cap),
            torch.as_tensor(lay.phys_sizes, device=dev),
            torch.as_tensor(lay.counts.astype(np.int32), device=dev), table)


def expand_probes(probe_ids: torch.Tensor, chunk_table: torch.Tensor,
                  n_rows: int, extra: Optional[int] = None) -> torch.Tensor:
    """(nq, n_probes) logical probes → (nq, budget) physical rows,
    chunk-major, with the dummy entries stably sorted to the back and the
    row list cut to the worst case one query can need
    (``n_probes + extra``, ``extra`` = continuation chunks of the index)."""
    nq, n_probes = probe_ids.shape
    n_lists = chunk_table.shape[0]
    dummy = n_rows - 1
    if extra is None:
        extra = max(0, (n_rows - 1) - n_lists)
    ph = chunk_table[probe_ids.long()]           # (nq, n_probes, max_chunks)
    flat = ph.transpose(1, 2).reshape(nq, -1)
    budget = max(1, min(flat.shape[1], n_probes + int(extra), n_rows - 1))
    if budget != flat.shape[1]:
        order = torch.argsort((flat == dummy).to(torch.int8), dim=1,
                              stable=True)[:, :budget]
        flat = torch.gather(flat, 1, order)
    return flat


def scan_probe_lists(probe_ids: torch.Tensor, score_tile: Callable,
                     list_indices: torch.Tensor, list_sizes: torch.Tensor,
                     k: int, select_min: bool, dtype: torch.dtype,
                     engine: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over each query's probed physical rows.

    ``score_tile(rows) -> (nq, cap)`` scores each query's gathered row;
    slots past the row's live size score the sentinel.  Each step selects
    the tile's best ``min(k, cap)`` (kernel B2 on the card) and merges them
    into the running run (run a wins ties, so earlier steps, then lower
    slots, win).  From ``k >= 24`` the masked tiles are stacked and one
    wide select runs instead — the same result in the same tie order.
    Returns (best_d (nq, k), best_i (nq, k) int32, −1 for empty slots)."""
    nq = probe_ids.shape[0]
    cap = list_indices.shape[1]
    dev = probe_ids.device
    sentinel = float("inf") if select_min else float("-inf")
    kk = min(k, cap)
    n_steps = probe_ids.shape[1]
    slots = torch.arange(cap, device=dev)

    def tile_scores(col):
        d = score_tile(col).to(dtype)
        live = slots[None, :] < list_sizes[col][:, None]
        return (torch.where(live, d, torch.full_like(d, sentinel)),
                list_indices[col])

    if k >= _SCAN_STACK_MIN_K and n_steps * cap >= k:
        tiles = [tile_scores(probe_ids[:, s]) for s in range(n_steps)]
        ds = torch.cat([t[0] for t in tiles], dim=1)
        ids = torch.cat([t[1] for t in tiles], dim=1)
        return select_k(ds, k, select_min, indices=ids, engine=engine)

    best_d = torch.full((nq, k), sentinel, dtype=dtype, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for s in range(n_steps):
        d, ids = tile_scores(probe_ids[:, s])
        tile_d, tile_i = select_k(d, kk, select_min, indices=ids,
                                  engine=engine)
        best_d, best_i = merge_sorted_runs(best_d, best_i, tile_d, tile_i,
                                           k=k, select_min=select_min)
    return best_d, best_i


def empty_result(nq: int, k: int, dtype: torch.dtype, device):
    """(nq, k) empty search output for zero-query batches."""
    return (torch.zeros((nq, k), dtype=dtype, device=device),
            torch.full((nq, k), -1, dtype=torch.int32, device=device))


def subsample_trainset(x: torch.Tensor, fraction: float, n_lists: int,
                       seed: int) -> torch.Tensor:
    """Host-drawn uniform trainset subsample — the JAX package's own numpy
    draw (``np.random.default_rng(seed)``), so both pick the same rows."""
    n = x.shape[0]
    if fraction >= 1.0 or n <= 1024:
        return x
    n_train = max(n_lists * 4, int(n * fraction))
    if n_train >= n:
        return x
    sel = np.sort(np.random.default_rng(seed).choice(
        n, size=n_train, replace=False))
    return x[torch.as_tensor(sel, device=x.device)]
