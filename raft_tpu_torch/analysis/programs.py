"""The audit inputs of the declared hot programs (see
:mod:`raft_tpu_torch.analysis.registry`): one builder per program name,
imported only when the auditor runs.

A builder takes the device (and, for a ``comms=True`` entry, a world-1
:class:`~raft_tpu_torch.comms.Comms`) and returns ``{"args"[, "kwargs"]
[, "plain"]}``: the declared function runs on ``args`` / ``kwargs``
(a method takes its instance first), and ``plain`` — where the program
launches a kernel on the card — computes the same outputs through the
plain versions (``engine="torch"``) on the same inputs, so the audit
holds the kernels at the audit shapes (``program_audit.against_plain``).
Every input comes from a seeded generator on the host, then moves to the
device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from raft_tpu_torch.distance.distance_types import DistanceType

BUILDERS: Dict[str, Callable] = {}


def _builder(name: str):
    def deco(fn):
        BUILDERS[name] = fn
        return fn
    return deco


def _randn(g, shape, device):
    return torch.randn(shape, generator=g).to(device)


# -- kernels ----------------------------------------------------------------

@_builder("kernels.select_k")
def _select_k(device):
    from raft_tpu_torch.matrix.select_k import select_k_plain

    x = _randn(torch.Generator().manual_seed(0), (64, 4096), device)
    return dict(args=(x, 64, True), plain=lambda: select_k_plain(x, 64, True))


@_builder("kernels.fused_l2_nn")
def _fused_l2_nn(device):
    from raft_tpu_torch.distance.fused_l2_nn import (
        fused_l2_nn_partials_plain)

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (2048, 64), device)
    y = _randn(g, (64, 64), device)
    w = torch.rand((2048,), generator=g).to(device)
    return dict(args=(x, y, w),
                plain=lambda: fused_l2_nn_partials_plain(x, y, w))


@_builder("kernels.ivf_pq_lut")
def _ivf_pq_lut(device):
    from raft_tpu_torch.kernels.ivf_pq_lut import _lut_score_plain

    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 256, (64, 64, 8), generator=g,
                          dtype=torch.uint8).to(device)
    rows = torch.arange(64, dtype=torch.int32, device=device)
    lut = _randn(g, (64, 8 * 256), device)
    return dict(args=(codes, rows, lut, 8, 8, 256),
                plain=lambda: _lut_score_plain(codes[rows.long()], lut, 8, 8,
                                               256))


# -- k-means ----------------------------------------------------------------

@_builder("cluster.fused_em_step")
def _fused_em_step(device):
    from raft_tpu_torch.cluster.kmeans import fused_em_step

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (16384, 64), device)
    c = _randn(g, (64, 64), device)
    kw = dict(metric=DistanceType.L2Expanded)
    return dict(args=(x, c), kwargs=kw,
                plain=lambda: fused_em_step(x, c, engine="torch", **kw))


# -- single-device search ---------------------------------------------------

@_builder("brute_force.knn_scan")
def _knn_scan(device):
    from raft_tpu_torch.neighbors.brute_force import _knn_scan_impl

    g = torch.Generator().manual_seed(0)
    xs = _randn(g, (4096, 32), device)
    q = _randn(g, (64, 32), device)
    args = (xs, q, 8, DistanceType.L2SqrtExpanded, 2.0, 1024, True)
    return dict(args=args, plain=lambda: _knn_scan_impl(*args, "torch"))


def _flat_index(device, n_lists: int = 16):
    from raft_tpu_torch.neighbors import ivf_flat

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (2048, 32), device)
    q = _randn(g, (64, 32), device)
    return ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                          device=device), q


@_builder("ivf_flat.search_batch")
def _ivf_flat_search(device):
    from raft_tpu_torch.kernels.engine import resolve_engine
    from raft_tpu_torch.neighbors.ivf_flat import _search_batch_impl

    idx, q = _flat_index(device)
    return dict(args=(q, idx, 8, 4, True,
                      resolve_engine("select_k", idx.device)),
                plain=lambda: _search_batch_impl(q, idx, 8, 4, True,
                                                 "torch"))


def _pq_index(device):
    from raft_tpu_torch.neighbors import ivf_pq

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (2048, 32), device)
    q = _randn(g, (64, 32), device)
    return ivf_pq.build(ivf_pq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8),
                        x, device=device), q


def _pq_tile(device):
    idx, _ = _pq_index(device)
    g = torch.Generator().manual_seed(1)
    xt = _randn(g, (8192, 32), device)
    lt = torch.randint(0, 16, (8192,), generator=g).to(device)
    return idx, xt, lt


@_builder("ivf_pq.encode_tile")
def _encode_tile(device):
    return dict(args=_pq_tile(device))


@_builder("ivf_pq.csum_tile")
def _csum_tile(device):
    idx, _, lt = _pq_tile(device)
    g = torch.Generator().manual_seed(2)
    codes = torch.randint(0, 256, (8192, idx.pq_dim), generator=g,
                          dtype=torch.int32).to(device)
    return dict(args=(codes, lt, idx.rot_centers, idx.codebooks, False))


@_builder("ivf_pq.full_search")
def _ivf_pq_search(device):
    from raft_tpu_torch.neighbors.ivf_pq import (_full_search_impl,
                                                 _resolve_engines)

    idx, q = _pq_index(device)
    return dict(args=(q, idx, 8, 4, "float32", _resolve_engines(idx, None)),
                plain=lambda: _full_search_impl(
                    q, idx, 8, 4, "float32", _resolve_engines(idx, "torch")))


# -- build ------------------------------------------------------------------

@_builder("build.scatter_append_in_place")
def _scatter_append(device):
    g = torch.Generator().manual_seed(0)
    datas = (torch.zeros((64, 32, 8), device=device),)
    idx = torch.full((64, 32), -1, dtype=torch.int32, device=device)
    payloads = (_randn(g, (128, 8), device),)
    ids = torch.arange(128, dtype=torch.int32, device=device)
    flat = torch.randperm(64 * 32, generator=g)[:128].to(device)
    return dict(args=(datas, idx, payloads, ids, flat, True))


# -- mutable and tiered serving ---------------------------------------------

@_builder("mutable.delta_merged_search")
def _merged_search(device):
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.mutable import (MutableIndex,
                                                  _merged_search_impl)

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (2048, 32), device)
    p = ivf_flat.IndexParams(n_lists=16)
    m = MutableIndex(ivf_flat.build(p, x, device=device), x, build_params=p)
    m.upsert(_randn(g, (128, 32), device),
             np.arange(2048, 2176, dtype=np.int64))
    m.delete(np.arange(64, dtype=np.int64))
    s, sp = m.searcher(8), m.searcher(8, engine="torch")
    core, delta, tm, td = m._snapshot()
    q = _randn(g, (64, 32), device)
    head = (q, core.main, delta, tm, td, 8, 4)
    return dict(args=head + (s.lut_dtype, s.engines, s.pq_kw),
                plain=lambda: _merged_search_impl(
                    *head, sp.lut_dtype, sp.engines, sp.pq_kw))


def _tiered(device):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.tiering import tier

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (2048, 32), device)
    q = _randn(g, (64, 32), device)
    idx = ivf_pq.build(ivf_pq.IndexParams(n_lists=16, pq_dim=8, pq_bits=8),
                       x, device=device)
    return tier(idx, hot_fraction=0.5, tile_phys=8, dataset=x), q


@_builder("tiering.cold_scan")
def _cold_scan(device):
    from raft_tpu_torch.neighbors.tiering import TieredSearcher, _block

    t, q = _tiered(device)
    s, sp = t.searcher(8), t.searcher(8, engine="torch")
    probes, _, _ = s._hot_phase(q, torch.zeros_like(s._acc))
    blk = _block(s._hot, s.kind,
                 tuple(c.to(device) for c in s.tiered.cold_tiles[0]))
    rest = (q, probes, blk, s._cold_extra[0])
    return dict(args=(s,) + rest,
                plain=lambda: TieredSearcher._scan(sp, *rest))


@_builder("tiering.refine")
def _refine(device):
    from raft_tpu_torch.kernels.engine import resolve_engine
    from raft_tpu_torch.neighbors.tiering import _refine_impl

    g = torch.Generator().manual_seed(0)
    q = _randn(g, (64, 32), device)
    vecs = _randn(g, (64, 32, 32), device)
    ids = torch.randint(0, 4096, (64, 32), generator=g,
                        dtype=torch.int32).to(device)
    head = (q, vecs, ids, DistanceType.L2SqrtExpanded, 8)
    return dict(args=head + (resolve_engine("select_k", q.device),),
                plain=lambda: _refine_impl(*head, "torch"))


# -- sharded serving at world 1 ---------------------------------------------

def _sharded(device, comms, kind: str):
    """A world-1 sharded searcher over a (1,024, 16) set and one (64, 16)
    batch, k = 8; the plain searcher shares its shards."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.neighbors.ann_mnmg import (ShardedSearcher,
                                                   replicate,
                                                   shard_brute_force,
                                                   shard_ivf_flat,
                                                   shard_ivf_pq)

    g = torch.Generator().manual_seed(0)
    x = _randn(g, (1024, 16), device)
    q = _randn(g, (64, 16), device)
    if kind == "ivf_flat":
        sh = shard_ivf_flat(ivf_flat.build(ivf_flat.IndexParams(n_lists=8),
                                           x, device=device), comms)
    elif kind == "ivf_pq":
        sh = shard_ivf_pq(ivf_pq.build(ivf_pq.IndexParams(n_lists=8,
                                                          pq_dim=4), x,
                                       device=device), comms)
    elif kind == "replica":
        sh = replicate(ivf_flat.build(ivf_flat.IndexParams(n_lists=8), x,
                                      device=device), comms, 1).local
    else:
        sh = shard_brute_force(x, comms, device=device)
    plain = ShardedSearcher(sh, 8, engine="torch")
    return dict(args=(ShardedSearcher(sh, 8), q),
                plain=lambda: plain.dispatch(q))


for _kind, _name in (("ivf_flat", "ann_mnmg.ivf_flat_sharded"),
                     ("brute_force", "ann_mnmg.brute_force_sharded"),
                     ("ivf_pq", "ann_mnmg.ivf_pq_sharded"),
                     ("replica", "ann_mnmg.ivf_flat_replica_group")):
    BUILDERS[_name] = (lambda kind: lambda device, comms: _sharded(
        device, comms, kind))(_kind)
