"""Distributed (OPG) exact brute-force kNN (port of
``raft_tpu/neighbors/knn_mnmg.py``): cuML's distributed ``brute_force_knn``
pattern driven through raft comms — each rank holds a block of index rows,
computes a local top-k, and the per-rank candidates are allgathered and
merged with ``knn_merge_parts`` (reference neighbors/brute_force.cuh:76,
144).  Every rank calls :func:`knn_mnmg` with the same global arguments.

Two topologies:

* ``partition="index"`` (default) — rows split, queries on every rank.
  Each rank scans its row block with the single-device tile loop
  (``brute_force._knn_scan_impl``: kernel B5 under L1 and the other
  accumulated metrics, B2 for every tile's select), offsets its ids by
  ``rank·rows_per``, and ONE allgather of the packed distances and ids
  feeds ``merge_sorted_parts`` (earlier ranks win ties).  The L2Sqrt root
  is deferred past the merge.
* ``partition="queries"`` — queries split, the index whole on every rank:
  each rank searches its slice with the unmodified single-device scan.
  The JAX package returns the slices as one sharded array with no
  collective; the port returns the whole (nq, k) result on every rank,
  which costs one allgather of the packed results.
  ``partition="auto"`` picks it when nq >= the index row count.

Bits: at world 1 both topologies are the single-device ``knn``.  Wider
worlds split the index into other tiles (a tile's width follows
``rows_per``), so the products under L2 / inner product may sum a pair in
another order: ids then equal the single-device ids except at near ties.
B5 sums every pair in one fixed order, so under L1 they are the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from raft_tpu_torch.comms.comms import as_comms
from raft_tpu_torch.core.buckets import bucket_dim
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import accum_dtype, as_float_tensor
from raft_tpu_torch.neighbors._common import empty_result
from raft_tpu_torch.neighbors.ann_mnmg import (_allgather_packed,
                                               _merge_one_allgather)
from raft_tpu_torch.neighbors.brute_force import (_knn_batched,
                                                  _resolve_metric)

_INT32_MAX = 2**31 - 1
#: index rows per scan step and query rows per batch (``knn``'s defaults)
_TILE = 16384
_QUERY_BATCH = 4096


def knn_mnmg(comms, index, queries, k: int,
             metric: Union[str, DistanceType] = DistanceType.L2SqrtExpanded,
             metric_arg: float = 2.0, partition: str = "index", *,
             device=None, engine: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of *queries* among the rows of *index* across the
    communicator's ranks: (distances [nq, k], global ids [nq, k] int32) on
    every rank.  *partition*: ``"index"``, ``"queries"`` or ``"auto"``
    (see the module doc).  *comms* may be a Comms or a Handle carrying
    one; *device* and *engine* as in ``brute_force.knn`` (``device=None``
    is the card)."""
    comms = as_comms(comms)
    # a split communicator's rank and size are group-local: the id
    # arithmetic below needs the whole world
    expects(getattr(comms, "groups", None) is None,
            "knn_mnmg needs a full (non-split) communicator")
    metric = _resolve_metric(metric)
    dev = resolve_device(device)
    x = as_float_tensor(index, dev)
    q = as_float_tensor(queries, dev).to(x.dtype)
    expects(x.ndim == 2 and q.ndim == 2, "inputs must be 2-d")
    expects(x.shape[1] == q.shape[1], "feature dim mismatch")
    expects(partition in ("index", "queries", "auto"),
            f"unknown partition {partition!r}")
    nranks, rank = comms.get_size(), comms.get_rank()
    n, nq = x.shape[0], q.shape[0]
    k = int(k)
    metric_arg = float(metric_arg)
    if partition == "auto":
        partition = "queries" if nq >= n else "index"
    if nq == 0:
        return empty_result(0, k, accum_dtype(q.dtype), dev)

    if partition == "queries":
        expects(1 <= k <= n, f"k={k} must be in [1, n_index={n}]")
        # equal bucketed slices, one per rank
        per = bucket_dim(-(-nq // nranks))
        if per * nranks != nq:
            q = torch.cat([q, q.new_zeros((per * nranks - nq, q.shape[1]))])
        d, i = _knn_batched(x, q[rank * per:(rank + 1) * per], k, metric,
                            metric_arg, min(_TILE, n), _QUERY_BATCH, engine)
        pd, pi = _allgather_packed(comms, d, i, k)
        return pd.reshape(-1, k)[:nq], pi.reshape(-1, k)[:nq]

    expects(n % nranks == 0,
            f"n ({n}) must be divisible by the number of ranks ({nranks}) — "
            "pad the index (OPG assumes equal parts)")
    rows_per = n // nranks
    expects(1 <= k <= rows_per,
            "k must not exceed rows per shard (each rank contributes k "
            "candidates)")
    expects(n - 1 <= _INT32_MAX,
            f"global id space ({n} rows) exceeds int32 — search parts "
            "explicitly via knn with global_id_offset")
    select_min = metric != DistanceType.InnerProduct
    defer = metric == DistanceType.L2SqrtExpanded
    scan_metric = DistanceType.L2Expanded if defer else metric
    d, i = _knn_batched(x[rank * rows_per:(rank + 1) * rows_per], q, k,
                        scan_metric, metric_arg, min(_TILE, rows_per),
                        _QUERY_BATCH, engine)
    d, i = _merge_one_allgather(comms, d, i + rank * rows_per, k, select_min)
    if defer:
        d = torch.sqrt(d)  # knn's deferred-root epilogue, post-merge
    return d, i
