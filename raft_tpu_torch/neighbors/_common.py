"""Shared helpers of the inverted-list indexes (port of
``raft_tpu/neighbors/_common.py``: ``chunk_layout`` :42,
``remap_chunk_table`` :80, ``extend_layout`` :97, ``expand_probes`` :340,
``tombstone_hit`` :408, ``scan_probe_lists`` :425 with its per-step
``xs`` and tombstone mask, ``validate_new_ids`` :528, ``empty_result``,
``subsample_trainset``), and ``new_ids_of`` (the ids of added rows).
The pack and the append are ``_build``'s ``pack_device`` /
``extend_device``: the port has that one path, where the JAX package
also keeps a host-bookkept twin of it (``pack_lists_chunked`` /
``extend_lists_chunked``, its ``tiled=False``).

The chunk-table arithmetic is (n_lists,)-shaped numpy host work, the same
code as the JAX package's, so equal labels give equal layouts; per-row
data stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
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
    owner: np.ndarray           # (n_phys + 1,) int32 logical list per row


def chunk_layout(counts: np.ndarray) -> ChunkLayout:
    """Layout from logical list sizes: capacity is the 90th percentile of
    the nonzero sizes rounded up to 8; a list spans ceil(size / cap)
    physical rows (empty lists keep one); the last physical row is an
    empty dummy that padding entries of the chunk table point at."""
    # exempt(hot-path-host-transfer): host counts (numpy), no device read
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
                       chunk_table=chunk_table, phys_sizes=phys_sizes,
                       owner=owner)


def _pow2(n: int) -> int:
    """The smallest power of two >= *n* (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def ladder_layout(lay: ChunkLayout) -> ChunkLayout:
    """*lay* with its block's rows and its chunk table's width padded up
    the power-of-two ladder: the dummy moves to the last row, the spare
    rows before it hold no chunk (size 0, no table entry points at them),
    and the extra columns point at the dummy.  A layout that grows this
    way (:func:`extend_layout` with ``ladder``) changes shape O(log n)
    times over its life — the mutable index's delta."""
    rows = _pow2(lay.n_phys + 1)
    n_lists, width = lay.chunk_table.shape
    table = np.full((n_lists, _pow2(width)), rows - 1, np.int32)
    table[:, :width] = np.where(lay.chunk_table == lay.n_phys, rows - 1,
                                lay.chunk_table)
    phys_sizes = np.zeros(rows, np.int32)
    phys_sizes[:lay.n_phys] = lay.phys_sizes[:lay.n_phys]
    owner = np.zeros(rows, np.int32)
    owner[:lay.n_phys] = lay.owner[:lay.n_phys]
    return ChunkLayout(cap=lay.cap, n_phys=rows - 1, counts=lay.counts,
                       chunk_table=table, phys_sizes=phys_sizes, owner=owner)


def array_to_tensor(a, device) -> torch.Tensor:
    """A numpy array (or a JAX one, through ``np.asarray``) as a tensor on
    *device*.  Two-byte raw items — what ``np.savez`` keeps of a bfloat16
    array, and the dtype ``ml_dtypes`` gives it — are read as bfloat16
    bits."""
    # exempt(hot-path-host-transfer): a host array in, no device read
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        # exempt(hot-path-host-transfer): a host array in, no device read
        bits = np.array(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    # exempt(hot-path-host-transfer): a host array in, no device read
    return torch.as_tensor(np.array(a), device=device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`array_to_tensor`: bfloat16 goes out as its bits
    in two-byte raw items (``|V2``, the layout the JAX package's archives
    hold)."""
    if t.dtype == torch.bfloat16:
        # exempt(hot-path-host-transfer): export to numpy (archives, results)
        return t.view(torch.int16).cpu().numpy().view("V2")
    # exempt(hot-path-host-transfer): export to numpy (archives, results)
    return t.cpu().numpy()


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


def remap_chunk_table(chunk_table: np.ndarray, row_map: np.ndarray,
                      dummy: int) -> np.ndarray:
    """Map a logical→physical chunk table through a physical-row
    renumbering (host numpy): entry ``r`` becomes ``row_map[r]``, and rows
    the renumbering drops (``row_map[r] < 0``) fall to *dummy*, the target
    block's empty row, so probing a dropped list scores only masked
    slots."""
    # exempt(hot-path-host-transfer): host chunk tables (numpy), no device read
    out = np.asarray(row_map).astype(np.int64)[np.asarray(chunk_table)]
    return np.where(out < 0, np.int64(dummy), out).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ExtendLayout:
    """Table update of an extend (:func:`extend_layout`): the grown chunk
    table and the recomputed owner and size inverses.  ``m`` is the
    number of NEW physical chunks, ``grow`` the rows the block grows by
    (``m``, or on the ladder 0 while spare rows hold the new chunks);
    when it is 0 (and the table keeps its width) the rows append into the
    existing blocks."""

    m: int
    grow: int
    max_chunks2: int
    counts_total: np.ndarray     # (n_lists,) int64
    chunk_table: np.ndarray      # (n_lists, max_chunks2) int32
    owner: np.ndarray            # (n_phys + m + 1,) int32
    phys_sizes: np.ndarray       # (n_phys + m + 1,) int32


def extend_layout(counts_old: np.ndarray, added: np.ndarray, cap: int,
                  chunk_table: np.ndarray, n_phys: int,
                  ladder: bool = False) -> ExtendLayout:
    """Grow a chunked layout by per-list row additions — the one table
    arithmetic of an extend, the JAX package's: new rows fill each list's
    last chunk, overflow into new physical chunks appended before the
    dummy row (which moves to the end), and the owner / size inverses are
    recomputed from the table (a list's rows are no longer contiguous).
    All (n_lists,)-shaped host bookkeeping; *n_phys* is the old block's
    dummy row.  With *ladder* (a :func:`ladder_layout` block) the new
    chunks take the spare rows after the last chunk in use, and the block
    and the table's width grow only up the power-of-two ladder."""
    n_lists, max_chunks = chunk_table.shape
    # exempt(hot-path-host-transfer): host counts (numpy), no device read
    counts_old = np.asarray(counts_old).astype(np.int64)
    # exempt(hot-path-host-transfer): host counts (numpy), no device read
    counts_total = counts_old + np.asarray(added).astype(np.int64)
    chunks_old = np.maximum(-(-counts_old // cap), 1)
    chunks_total = np.maximum(-(-counts_total // cap), 1)
    added_chunks = chunks_total - chunks_old
    m = int(added_chunks.sum())
    dummy_old = int(n_phys)
    base, dummy_new = dummy_old, dummy_old + m
    width = max(max_chunks, int(chunks_total.max()) if n_lists else 1)
    if ladder:
        in_use = chunk_table[chunk_table != dummy_old]
        base = int(in_use.max()) + 1 if in_use.size else 0
        if base + m > dummy_old:
            dummy_new = _pow2(base + m + 1) - 1
        else:
            dummy_new = dummy_old
        width = _pow2(width)

    table2 = np.full((n_lists, width), dummy_new, np.int32)
    table2[:, :max_chunks] = np.where(chunk_table == dummy_old, dummy_new,
                                      chunk_table)
    if m:
        new_owner = np.repeat(np.arange(n_lists, dtype=np.int32),
                              added_chunks)
        starts_added = np.zeros(n_lists + 1, np.int64)
        np.cumsum(added_chunks, out=starts_added[1:])
        ord_within = np.arange(m) - starts_added[new_owner]
        table2[new_owner, chunks_old[new_owner] + ord_within] = (
            base + np.arange(m, dtype=np.int32))

    owner2 = np.zeros(dummy_new + 1, np.int32)
    phys_sizes2 = np.zeros(dummy_new + 1, np.int32)
    rows_l, ords = np.nonzero(table2 != dummy_new)
    phys_ids = table2[rows_l, ords]
    owner2[phys_ids] = rows_l.astype(np.int32)
    phys_sizes2[phys_ids] = np.minimum(
        cap, np.maximum(0, counts_total[rows_l] - ords * cap)).astype(np.int32)
    return ExtendLayout(m=m, grow=dummy_new - dummy_old, max_chunks2=width,
                        counts_total=counts_total,
                        chunk_table=table2, owner=owner2,
                        phys_sizes=phys_sizes2)


def expand_probes(probe_ids: torch.Tensor, chunk_table: torch.Tensor,
                  n_rows: int, extra: Optional[int] = None,
                  return_ord: bool = False):
    """(nq, n_probes) logical probes → (nq, budget) physical rows,
    chunk-major, with the dummy entries stably sorted to the back and the
    row list cut to the worst case one query can need
    (``n_probes + extra``, ``extra`` = continuation chunks of the index).
    With ``return_ord`` also the (nq, budget) probe ordinal of each row:
    which of the query's probes its chunk belongs to."""
    nq, n_probes = probe_ids.shape
    n_lists = chunk_table.shape[0]
    dummy = n_rows - 1
    if extra is None:
        extra = max(0, (n_rows - 1) - n_lists)
    ph = chunk_table[probe_ids.long()]           # (nq, n_probes, max_chunks)
    flat = ph.transpose(1, 2).reshape(nq, -1)
    # chunk-major flattening: position j holds probe ordinal j % n_probes
    ord_flat = (torch.arange(flat.shape[1], device=flat.device)
                % n_probes).expand(nq, -1)
    budget = max(1, min(flat.shape[1], n_probes + int(extra), n_rows - 1))
    if budget != flat.shape[1]:
        order = torch.argsort((flat == dummy).to(torch.int8), dim=1,
                              stable=True)[:, :budget]
        flat = torch.gather(flat, 1, order)
        ord_flat = torch.gather(ord_flat, 1, order)
    return (flat, ord_flat) if return_ord else flat


def tombstone_hit(ids: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Per-id membership in a packed tombstone bitmap: bit ``id % 32`` of
    word ``id // 32`` set means the row id is dead.  *words* is (n_words,)
    int32 or uint32 (the same bits).  The id is clamped into the bitmap:
    the writer grows the bitmap before any id past it can be tombstoned,
    so the clamp only rewrites the −1 ids of padding slots, which the
    live-size mask drops whatever bit they read."""
    safe = torch.clamp(ids.long(), 0, words.shape[0] * 32 - 1)
    word = words[safe >> 5].to(torch.int64)
    return ((word >> (safe & 31)) & 1).bool()


def scan_probe_lists(probe_ids: torch.Tensor, score_tile: Callable,
                     list_indices: torch.Tensor, list_sizes: torch.Tensor,
                     k: int, select_min: bool, dtype: torch.dtype,
                     engine: Optional[str] = None,
                     xs: Sequence[torch.Tensor] = (),
                     tombstones: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over each query's probed physical rows.

    ``score_tile(rows, *slices) -> (nq, cap)`` scores each query's
    gathered row; *xs* are per-step sequences with the scan axis leading
    (``probe_ids.shape[1]`` long), and step s passes each one's slice s.
    Slots past the row's live size score the sentinel, and so do slots
    whose id is set in *tombstones* (a packed bitmap, :func:`tombstone_hit`
    — the mutable index's deletes).  Each step selects
    the tile's best ``min(k, cap)`` (kernel B2 on the card) and merges them
    into the running run (run a wins ties, so earlier steps, then lower
    slots, win).  From ``k >= 24`` the masked tiles are stacked and one
    wide select runs instead — the same result in the same tie order; a
    dead slot's id is −1 there, so a deleted id never comes back even at
    the sentinel.
    Returns (best_d (nq, k), best_i (nq, k) int32, −1 for empty slots)."""
    nq = probe_ids.shape[0]
    cap = list_indices.shape[1]
    dev = probe_ids.device
    sentinel = float("inf") if select_min else float("-inf")
    kk = min(k, cap)
    n_steps = probe_ids.shape[1]
    slots = torch.arange(cap, device=dev)

    def tile_scores(s):
        col = probe_ids[:, s]
        d = score_tile(col, *(x[s] for x in xs)).to(dtype)
        ids = list_indices[col]
        live = slots[None, :] < list_sizes[col][:, None]
        if tombstones is not None:
            dead = tombstone_hit(ids, tombstones)
            live = live & ~dead
            ids = torch.where(dead, torch.full_like(ids, -1), ids)
        return torch.where(live, d, torch.full_like(d, sentinel)), ids

    if k >= _SCAN_STACK_MIN_K and n_steps * cap >= k:
        tiles = [tile_scores(s) for s in range(n_steps)]
        ds = torch.cat([t[0] for t in tiles], dim=1)
        ids = torch.cat([t[1] for t in tiles], dim=1)
        return select_k(ds, k, select_min, indices=ids, engine=engine)

    best_d = torch.full((nq, k), sentinel, dtype=dtype, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for s in range(n_steps):
        d, ids = tile_scores(s)
        tile_d, tile_i = select_k(d, kk, select_min, indices=ids,
                                  engine=engine)
        best_d, best_i = merge_sorted_runs(best_d, best_i, tile_d, tile_i,
                                           k=k, select_min=select_min)
    return best_d, best_i


def new_ids_of(index, new_ids, n: int) -> torch.Tensor:
    """The ids of *n* rows added to an IVF *index*: ``size, size + 1, …``
    by default; given ones must be new (:func:`validate_new_ids`)."""
    if new_ids is None:
        return torch.arange(index.size, index.size + n, dtype=torch.int32,
                            device=index.device)
    ids = torch.as_tensor(new_ids, device=index.device).to(torch.int32)
    expects(ids.shape == (n,), "ids must be (n_new,)")
    validate_new_ids(ids, index.list_indices, index.phys_sizes)
    return ids


def validate_new_ids(new_ids: torch.Tensor, list_indices: torch.Tensor,
                     phys_sizes: torch.Tensor) -> None:
    """Reject extend ids that collide — within the batch or with an id
    already live in the index — with ``ValueError``: a duplicate id would
    give two live rows for one key (and break the mutable index, whose id
    ↔ row map is 1:1).  Reads the id column to the host: the write path
    only, never the serve path."""
    # exempt(hot-path-host-transfer): an extend's id check: the write path, not a search
    ids_h = new_ids.cpu().numpy()
    uniq, counts = np.unique(ids_h, return_counts=True)
    if uniq.size != ids_h.size:
        raise ValueError(f"extend: duplicate ids within new_ids batch: "
                         # exempt(hot-path-host-transfer): numpy ids in an error message
                         f"{uniq[counts > 1][:8].tolist()}")
    # exempt(hot-path-host-transfer): an extend's id check: the write path, not a search
    idx_h = list_indices.cpu().numpy()
    # exempt(hot-path-host-transfer): an extend's id check: the write path, not a search
    psz_h = phys_sizes.cpu().numpy()
    live = idx_h[np.arange(idx_h.shape[1])[None, :] < psz_h[:, None]]
    clash = np.intersect1d(ids_h, live)
    if clash.size:
        raise ValueError(
            # exempt(hot-path-host-transfer): numpy ids in an error message
            f"extend: ids already live in the index: {clash[:8].tolist()} "
            "— a duplicate id would yield two live rows for one key; use "
            "neighbors.mutable.MutableIndex.upsert for replace semantics")


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
