"""Device-resident packing of the inverted lists (single-device port of
``raft_tpu/neighbors/_build.py``: ``_list_slots_impl`` :117,
``_scatter_new_impl`` :131, ``_scatter_append_impl`` :147, ``run_tiles``
:207, ``pack_device`` :254, ``extend_device`` :281).

Only the (n_lists,)-shaped chunk-table bookkeeping (``_common.chunk_layout``
/ ``_common.extend_layout``) runs on the host; the list counts are the
only per-list data that reach it, and the rows, ids and slots stay on the
device.  A fresh pack scatters into new blocks; an extend appends into
each list's free tail slots and grows only the lists that overflow.  With
``in_place=True`` and no overflow, the append writes into the index's own
tensors (O(n_new)); otherwise it writes into a copy, and the input index
is left as it was.

The three device steps are keyed programs (``core/aot.py``; reference
``_list_slots_aot``, ``_scatter_new_aot``, ``_scatter_append_aot`` /
``_scatter_append_dn_aot`` :164-175), so a second build or extend at the
same shapes makes no first call.  The reference keys two append programs,
one with its blocks donated; the port donates nothing (an eager scatter
writes in place by itself, ``in_place``), so one keyed append with
``in_place`` static stands for both.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.analysis.registry import audit_program
from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.neighbors._common import (chunk_layout, extend_layout,
                                              ladder_layout, ranks_within)

#: rows per tile of the populate loop (the JAX package's
#: ``DEFAULT_TILE_ROWS``): bounds IVF-PQ's (tile, pq_dim, 2^bits) encode
#: distances
DEFAULT_TILE_ROWS = 8192


def _counts(labels: torch.Tensor, n_lists: int) -> np.ndarray:
    """(n_lists,) list sizes, counted on the device."""
    if labels.shape[0] == 0:
        return np.zeros(n_lists, np.int64)
    # exempt(hot-path-host-transfer): (n_lists,) counts size the host chunk layout
    return torch.bincount(labels.long(), minlength=n_lists).cpu().numpy()


def list_slots(labels: torch.Tensor, fill0: torch.Tensor,
               table: torch.Tensor, cap: int, n_lists: int) -> torch.Tensor:
    """Flat slot of every row in the (n_rows, cap) physical block:
    ``rank = fill0[label] + rank within the label``, its chunk ``rank //
    cap`` resolved through the chunk table (``fill0`` is 0 for a fresh
    pack, the old list sizes for an extend)."""
    labels = labels.long()
    rank = fill0.long()[labels] + ranks_within(labels, n_lists)
    return table.long()[labels, rank // cap] * cap + rank % cap


def scatter_new(payloads: Tuple[torch.Tensor, ...], ids: torch.Tensor,
                flat: torch.Tensor, n_rows: int, cap: int):
    """Fresh (n_rows, cap, …) blocks holding each payload row at its flat
    slot, and the (n_rows, cap) ids, −1 at padding."""
    datas = []
    for p in payloads:
        d = p.new_zeros((n_rows * cap,) + tuple(p.shape[1:]))
        d[flat] = p
        datas.append(d.reshape((n_rows, cap) + tuple(p.shape[1:])))
    idx = torch.full((n_rows * cap,), -1, dtype=torch.int32,
                     device=ids.device)
    idx[flat] = ids.to(torch.int32)
    return tuple(datas), idx.reshape(n_rows, cap)


@audit_program(
    "build.scatter_append_in_place", transient_bytes=1 << 20,
    in_place=(0, 1),
    notes="the in-place extend's append scatter: the payload rows and ids "
          "land in the existing blocks, no O(index) copy")
def scatter_append(datas: Tuple[torch.Tensor, ...], idx: torch.Tensor,
                   payloads: Tuple[torch.Tensor, ...], ids: torch.Tensor,
                   flat: torch.Tensor, in_place: bool):
    """Payload rows and ids written at their flat slots of existing
    blocks: into the blocks themselves with *in_place*, else into
    copies."""
    out = []
    for d, p in zip(datas, payloads):
        d2 = d if in_place else d.clone()
        d2.view((-1,) + tuple(d.shape[2:]))[flat] = p.to(d.dtype)
        out.append(d2)
    idx2 = idx if in_place else idx.clone()
    idx2.view(-1)[flat] = ids.to(torch.int32)
    return tuple(out), idx2


_list_slots_aot = aot(list_slots, static_argnums=(3, 4))
_scatter_new_aot = aot(scatter_new, static_argnums=(3, 4))
_scatter_append_aot = aot(scatter_append, static_argnums=(5,))


def run_tiles(tile_fn: Callable, x: torch.Tensor, labels: torch.Tensor,
              tile_rows: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``tile_fn(x_t, labels_t)`` over the rows in tiles of *tile_rows*
    (a tuple of per-row outputs each), concatenated back to (n, …): the
    transients stay O(tile)."""
    n = x.shape[0]
    tile = max(8, min(int(tile_rows or DEFAULT_TILE_ROWS), max(n, 1)))
    outs = []
    for t0 in range(0, n, tile):
        res = tile_fn(x[t0:t0 + tile], labels[t0:t0 + tile])
        outs.append(res if isinstance(res, tuple) else (res,))
    if not outs:
        raise ValueError("run_tiles: empty dataset")
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def pack_device(payload, ids: torch.Tensor, labels: torch.Tensor,
                n_lists: int, ladder: bool = False):
    """Scatter rows into fresh chunked padded blocks.  *payload* is one
    (n, …) tensor or a tuple of them packed side by side.  Returns (data,
    idx (n_phys+1, cap) int32 −1-padded, phys_sizes, list_sizes,
    chunk_table, owner), data (n_phys+1, cap, …) per payload (a tuple
    when a tuple came in).  With *ladder* the block's rows and the
    table's width are padded up the power-of-two ladder
    (``_common.ladder_layout``)."""
    multi = isinstance(payload, (tuple, list))
    payloads = tuple(payload) if multi else (payload,)
    dev = payloads[0].device
    lay = chunk_layout(_counts(labels, n_lists))
    if ladder:
        lay = ladder_layout(lay)
    table = torch.as_tensor(lay.chunk_table, device=dev)
    flat = _list_slots_aot(labels, torch.zeros(n_lists, dtype=torch.int32,
                                               device=dev),
                           table, lay.cap, n_lists)
    datas, idx = _scatter_new_aot(payloads, ids, flat, lay.n_phys + 1,
                                  lay.cap)
    return (datas if multi else datas[0], idx,
            torch.as_tensor(lay.phys_sizes, device=dev),
            torch.as_tensor(lay.counts.astype(np.int32), device=dev), table,
            torch.as_tensor(lay.owner, device=dev))


def extend_device(data, idx: torch.Tensor, list_sizes: torch.Tensor,
                  chunk_table: torch.Tensor, payload_new,
                  ids_new: torch.Tensor, labels_new: torch.Tensor,
                  in_place: bool = False, ladder: bool = False):
    """Append rows into existing chunked blocks (same return contract as
    :func:`pack_device`): each new row goes to the next free slot of its
    list, lists that overflow grow chunks appended before the dummy row.
    When no list overflows the blocks keep their shape and, with
    *in_place*, the append writes into them (the caller's index then
    holds the new rows too); otherwise the old blocks are left as they
    were.  With *ladder* (blocks from ``pack_device(ladder=True)``) new
    chunks fill the spare rows first and the blocks grow up the
    power-of-two ladder."""
    multi = isinstance(data, (tuple, list))
    datas = tuple(data) if multi else (data,)
    payloads = tuple(payload_new) if multi else (payload_new,)
    dev = idx.device
    n_lists = chunk_table.shape[0]
    cap = datas[0].shape[1]
    n_phys = datas[0].shape[0] - 1
    # exempt(hot-path-host-transfer): (n_lists,) sizes lay out an extend on the host
    counts_old = list_sizes.cpu().numpy().astype(np.int64)
    # exempt(hot-path-host-transfer): the chunk table lays out an extend on the host
    table_old = chunk_table.cpu().numpy()
    lay = extend_layout(counts_old, _counts(labels_new, n_lists), cap,
                        table_old, n_phys, ladder)
    table = torch.as_tensor(lay.chunk_table, device=dev)
    if lay.grow:
        datas = tuple(torch.cat([d[:n_phys], d.new_zeros(
            (lay.grow + 1, cap) + tuple(d.shape[2:]))]) for d in datas)
        idx = torch.cat([idx[:n_phys], idx.new_full((lay.grow + 1, cap),
                                                    -1)])
        in_place = True           # the grown blocks are new tensors
    if payloads[0].shape[0]:
        flat = _list_slots_aot(labels_new,
                               torch.as_tensor(counts_old, device=dev),
                               # exempt(retrace-unbounded-static): one layout per index
                               table, cap, n_lists)
        datas, idx = _scatter_append_aot(datas, idx, payloads, ids_new, flat,
                                         in_place)
    return (datas if multi else datas[0], idx,
            torch.as_tensor(lay.phys_sizes, device=dev),
            torch.as_tensor(lay.counts_total.astype(np.int32), device=dev),
            table, torch.as_tensor(lay.owner, device=dev))
