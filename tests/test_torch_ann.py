"""The port's ``approx_knn_*`` surface against raft_tpu.

``approx_knn_search`` over an index ``approx_knn_build_index`` made equals
the family ``search`` of the index it holds, bit for bit (the dispatch
adds nothing).  Against the JAX package: IVF-SQ's int8 codes of the data
and of the queries equal its ``_sq_encode`` bit for bit; a JAX-built
IVF-SQ index carried into the port searches to rtol 1e-5 of the JAX
distances (back in the data's units) with ids equal wherever distances
are not tied; IVF-Flat and IVF-PQ builds through the surface reach recall
within 0.03 of the JAX package's; the refusals match.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.distance_types import DistanceType as JaxDT
from raft_tpu.neighbors import ann as jax_ann
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ann, ivf_flat, ivf_pq

K = 10


def _data(n=3000, d=32, nq=100, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (40, d))
    x = (c[rng.integers(0, 40, n)] + rng.standard_normal((n, d))
         ).astype(np.float32)
    q = (c[rng.integers(0, 40, nq)] + rng.standard_normal((nq, d))
         ).astype(np.float32)
    return x, q


def _recall(ids, x, q):
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.mean([len(set(a) & set(b)) / K
                    for a, b in zip(np.asarray(ids), truth)])


@pytest.mark.parametrize("params", [
    ann.IVFFlatParam(nlist=32, nprobe=8),
    ann.IVFPQParam(nlist=32, nprobe=8, M=8, n_bits=8),
    ann.IVFSQParam(nlist=32, nprobe=8)])
def test_search_equals_the_family_search(params):
    x, q = _data()
    idx = ann.approx_knn_build_index(params, x, device="cpu")
    d, i = ann.approx_knn_search(idx, q, K)
    assert d.shape == (len(q), K) and i.dtype == torch.int32
    if isinstance(params, ann.IVFPQParam):
        assert idx.ivf_pq_index.pq_dim == 8 and idx.ivf_flat_index is None
        rd, ri = ivf_pq.search(ivf_pq.SearchParams(n_probes=8),
                               idx.ivf_pq_index, q, K)
    elif isinstance(params, ann.IVFSQParam):
        assert idx.ivf_flat_index.list_data.dtype == torch.int8
        lo, scale = (torch.tensor(v) for v in idx.sq_scale)
        rd, ri = ivf_flat.search(ivf_flat.SearchParams(n_probes=8),
                                 idx.ivf_flat_index,
                                 ann._sq_encode(torch.from_numpy(q), lo,
                                                scale), K)
        rd = rd * (scale * scale)
    else:
        rd, ri = ivf_flat.search(ivf_flat.SearchParams(n_probes=8),
                                 idx.ivf_flat_index, q, K)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    # a sanity floor: 8 PQ subspaces of 4 dimensions cost recall
    pq = isinstance(params, ann.IVFPQParam)
    assert _recall(i.numpy(), x, q) >= (0.6 if pq else 0.8)


@pytest.mark.parametrize("param_cls", ["IVFFlatParam", "IVFPQParam"])
def test_build_recall_matches_jax(param_cls):
    x, q = _data(n=4000, seed=3)
    kw = dict(nlist=32, nprobe=8)
    if param_cls == "IVFPQParam":
        kw.update(M=16)
    jidx = jax_ann.approx_knn_build_index(getattr(jax_ann, param_cls)(**kw),
                                          jnp.asarray(x))
    tidx = ann.approx_knn_build_index(getattr(ann, param_cls)(**kw), x,
                                      device="cpu")
    _, ri = jax_ann.approx_knn_search(jidx, jnp.asarray(q), K)
    _, gi = ann.approx_knn_search(tidx, q, K)
    r_jax, r_port = _recall(np.asarray(ri), x, q), _recall(gi.numpy(), x, q)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded"])
def test_sq_codes_and_carried_search_match_jax(metric):
    x, q = _data(seed=5)
    jidx = jax_ann.approx_knn_build_index(
        jax_ann.IVFSQParam(nlist=32, nprobe=8), jnp.asarray(x),
        metric=JaxDT[metric])
    lo, scale = jidx.sq_scale
    tidx = ann.approx_knn_build_index(ann.IVFSQParam(nlist=32, nprobe=8), x,
                                      metric=DistanceType[metric],
                                      device="cpu")
    assert tidx.sq_scale == (lo, scale)
    lo_t, scale_t = (torch.tensor(v) for v in tidx.sq_scale)
    for v in (x, q):
        np.testing.assert_array_equal(
            ann._sq_encode(torch.from_numpy(v), lo_t, scale_t).numpy(),
            np.asarray(jax_ann._sq_encode(jnp.asarray(v), lo, scale)))
    # the JAX-built int8 index carried across: the same search
    jflat = jidx.ivf_flat_index
    carried = ivf_flat.index_from_arrays(
        {n: np.asarray(getattr(jflat, n)) for n in ivf_flat.ARRAY_FIELDS},
        int(jflat.metric), device="cpu")
    tcar = ann.KnnIndex(DistanceType[metric], 2.0, 8,
                        ivf_flat_index=carried, sq_scale=(lo, scale))
    gd, gi = ann.approx_knn_search(tcar, q, K)
    rd, ri = (np.asarray(a) for a in jax_ann.approx_knn_search(
        jidx, jnp.asarray(q), K))
    np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-5, atol=1e-5)
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi.numpy()[~tied], ri[~tied])


def test_refusals():
    x, _ = _data(n=500)
    with pytest.raises(Exception, match="storage mapping"):
        ann.approx_knn_build_index(
            ann.IVFSQParam(nlist=8, qtype=ann.QuantizerType.QT_4bit), x,
            device="cpu")
    with pytest.raises(Exception, match="IVF-SQ supports"):
        ann.approx_knn_build_index(ann.IVFSQParam(nlist=8), x,
                                   metric=DistanceType.InnerProduct,
                                   device="cpu")
    with pytest.raises(Exception, match="unknown param"):
        ann.approx_knn_build_index(object(), x, device="cpu")
    with pytest.raises(Exception, match="empty index"):
        ann.approx_knn_search(ann.KnnIndex(DistanceType.L2Expanded, 2.0, 8),
                              x[:2], K)
