"""What the IVF entries share: the metric's name, the kernels, the
serving engine and the read-out of chunked inverted lists."""

from __future__ import annotations

import math

import torch

def metric(name: str):
    from raft_tpu_torch.distance.distance_types import DistanceType

    return DistanceType[name]


def load_kernels(device) -> None:
    """Build (the first run in a checkout) or load every kernel library."""
    if device.type == "cuda":
        from raft_tpu_torch.kernels import native

        native.load_all()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatches(nq: int, batch: int = 1024) -> int:
    """Keyed dispatches of a ``search`` call of *nq* rows (the port's
    default query batch)."""
    return max(1, math.ceil(nq / batch))


class Server:
    """The open loop's server: a ``ServeEngine`` over the index, warmed
    on every bucket up to ``max_batch``."""

    def __init__(self, index, k: int, params, max_batch: int):
        from raft_tpu_torch.serve import ServeEngine

        self.engine = ServeEngine(index, k, params, max_batch=max_batch)
        self.engine.warmup()

    def submit(self, q):
        return self.engine.submit(q)

    def close(self) -> None:
        self.engine.close()


def owner_of_rows(chunk_table: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The logical list of each physical row (-1: the dummy row)."""
    dummy = n_rows - 1
    owner = torch.full((n_rows,), -1, dtype=torch.long,
                       device=chunk_table.device)
    lists = torch.arange(chunk_table.shape[0], device=chunk_table.device)
    lists = lists[:, None].expand_as(chunk_table)
    keep = chunk_table != dummy
    owner[chunk_table[keep].long()] = lists[keep]
    return owner


def by_id(list_indices: torch.Tensor, phys_sizes: torch.Tensor,
          owner: torch.Tensor, payload: torch.Tensor, n: int):
    """(labels (n,) with -1 for ids never stored, payload (n, ...) by id,
    number of ids stored more than once) of chunked padded lists."""
    cap = list_indices.shape[1]
    slot = torch.arange(cap, device=list_indices.device)[None]
    live = (list_indices >= 0) & (slot < phys_sizes[:, None])
    ids = list_indices[live].long()
    lists = owner[:, None].expand_as(list_indices)[live]
    rows = payload[live]
    ok = (ids >= 0) & (ids < n)
    ids, lists, rows = ids[ok], lists[ok], rows[ok]
    dup = int(ids.numel() - torch.unique(ids).numel())
    labels = torch.full((n,), -1, dtype=torch.long, device=ids.device)
    labels[ids] = lists
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    out[ids] = rows
    return labels, out, dup + int((~ok).sum())
