"""Extend into a non-empty index, against raft_tpu.

An index the JAX package built over the first rows is carried into the
port (``index_from_arrays``); both packages then extend it with the same
rows and ids.  The layout tables (``list_sizes``, ``phys_sizes``,
``chunk_table``, the ids of every slot) must be equal — a row the two
assign to different lists is allowed only at a near tie (its two best
centres within 1e-5 relative), and such rows are counted; searches after
the extend match at the families' tolerances (distances rtol 1e-5, ids
equal wherever the distances are not tied).  ``in_place`` gives the
copying path's index; ``validate_new_ids`` raises on a duplicate in the
batch and on an id already live, as ``raft_tpu``'s does; adaptive centres
move as the JAX package's; int8, uint8 and bfloat16 IVF-Flat storage
searches and extends as the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import _common as jax_common
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch.neighbors import _common as tcommon
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tpq

_N, _DIM, _LISTS, _K = 1536, 24, 8, 8
_N0 = 1024


def _data(seed=0, n=_N):
    return np.random.default_rng(seed).random((n, _DIM)).astype(np.float32)


def _carry(fam, jidx):
    arrays = {name: np.asarray(getattr(jidx, name))
              for name in fam.ARRAY_FIELDS}
    if fam is tivf:
        return tivf.index_from_arrays(arrays, int(jidx.metric),
                                      jidx.adaptive_centers, device="cpu")
    return tpq.index_from_arrays(arrays, int(jidx.metric),
                                 int(jidx.codebook_kind), jidx.pq_bits,
                                 jidx.dataset_dtype, device="cpu")


def _labels_of(idx_arrays, owner, n):
    """List of every id from an index's tables (ids < n)."""
    ids = idx_arrays["list_indices"]
    lab = np.full(n, -1, np.int64)
    rows, slots = np.nonzero(ids >= 0)
    lab[ids[rows, slots]] = owner[rows]
    return lab


def _owner(chunk_table, n_rows):
    owner = np.zeros(n_rows, np.int64)
    lists, ords = np.nonzero(chunk_table != n_rows - 1)
    owner[chunk_table[lists, ords]] = lists
    return owner


def _near_tie(x, centers):
    d = ((x[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0]


def _assert_tables(got, ref, x, centers):
    """Equal layout tables, or differing assignments only at near ties."""
    g = {n: getattr(got, n).numpy() for n in ("list_indices", "list_sizes",
                                             "phys_sizes", "chunk_table")}
    r = {n: np.asarray(getattr(ref, n)) for n in g}
    n = x.shape[0]
    lg = _labels_of(g, _owner(g["chunk_table"], g["list_indices"].shape[0]),
                    n)
    lr = _labels_of(r, _owner(r["chunk_table"], r["list_indices"].shape[0]),
                    n)
    moved = np.nonzero(lg != lr)[0]
    assert _near_tie(x[moved], centers).all(), moved
    if moved.size == 0:
        for name in g:
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)
    return moved.size


def _assert_search_parity(got, ref):
    gd, gi = (t.numpy() for t in got)
    rd, ri = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    tied = np.zeros_like(rd, dtype=bool)
    close = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=1e-6)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    np.testing.assert_array_equal(gi[~tied], ri[~tied])


def _pair(kind, x0, ids0, **kw):
    if kind == "ivf_flat":
        jidx = jax_ivf.build(jax_ivf.IndexParams(
            n_lists=_LISTS, kmeans_n_iters=4, seed=1, **kw), jnp.asarray(x0),
            ids=jnp.asarray(ids0))
        return jax_ivf, tivf, jidx
    jidx = jax_pq.build(jax_pq.IndexParams(
        n_lists=_LISTS, pq_dim=8, kmeans_n_iters=4, seed=1, **kw),
        jnp.asarray(x0), ids=jnp.asarray(ids0))
    return jax_pq, tpq, jidx


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("n_new", [512, 40, 3000])
def test_extend_non_empty_matches_jax(kind, n_new):
    """Tables and search after an extend of 512 rows (some lists grow a
    chunk), 40 rows (none does) and 3,000 (the lists at least double)."""
    x = _data(0, _N0 + n_new)
    ids = np.random.default_rng(1).permutation(10 * x.shape[0])[
        :x.shape[0]].astype(np.int32)
    jfam, tfam, jidx = _pair(kind, x[:_N0], ids[:_N0])
    tidx = _carry(tfam, jidx)
    jext = jfam.extend(jidx, jnp.asarray(x[_N0:]), jnp.asarray(ids[_N0:]))
    text = tfam.extend(tidx, x[_N0:], ids[_N0:])
    assert text.size == _N0 + n_new
    full = np.zeros((ids.max() + 1, _DIM), np.float32)
    full[ids] = x
    moved = _assert_tables(text, jext, full, np.asarray(jidx.centers))
    assert moved <= 1
    if kind == "ivf_pq" and not moved:
        for name in ("list_codes", "owner"):
            np.testing.assert_array_equal(getattr(text, name).numpy(),
                                          np.asarray(getattr(jext, name)))
    q = _data(9, 40)
    sp_j = jfam.SearchParams(n_probes=4)
    sp_t = tfam.SearchParams(n_probes=4)
    _assert_search_parity(tfam.search(sp_t, text, q, _K),
                          jfam.search(sp_j, jext, jnp.asarray(q), _K))


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("n_new", [40, 700])
def test_in_place_equals_copying_extend(kind, n_new):
    """``in_place`` gives the copying path's index bit for bit; without
    overflow it writes into the input's own tensors, with overflow into
    new ones (the input keeps its rows)."""
    x = _data(2, _N0 + n_new)
    fam = tivf if kind == "ivf_flat" else tpq
    params = (tivf.IndexParams(n_lists=_LISTS, kmeans_n_iters=4)
              if kind == "ivf_flat"
              else tpq.IndexParams(n_lists=_LISTS, pq_dim=8,
                                   kmeans_n_iters=4))
    base = fam.build(params, x[:_N0], device="cpu")
    copy = fam.extend(base, x[_N0:])
    before = {n: getattr(base, n).clone() for n in fam.ARRAY_FIELDS}
    fresh = fam.build(params, x[:_N0], device="cpu")
    inplace = fam.extend(fresh, x[_N0:], in_place=True)
    for name in fam.ARRAY_FIELDS:
        assert torch.equal(getattr(copy, name), getattr(inplace, name)), name
        assert torch.equal(getattr(base, name), before[name]), name
    block = "list_data" if kind == "ivf_flat" else "list_codes"
    grew = getattr(copy, block).shape[0] != before[block].shape[0]
    assert (getattr(inplace, block).data_ptr()
            == getattr(fresh, block).data_ptr()) == (not grew)
    assert copy.size == _N0 + n_new


def test_validate_new_ids_raises_as_jax():
    x = _data(3, _N0)
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=_LISTS,
                                             kmeans_n_iters=2), jnp.asarray(x))
    tidx = _carry(tivf, jidx)
    for bad in (np.array([4000, 4001, 4000], np.int32),
                np.array([4000, 17], np.int32)):
        with pytest.raises(ValueError) as je:
            jax_common.validate_new_ids(jnp.asarray(bad), jidx.list_indices,
                                        jidx.phys_sizes)
        with pytest.raises(ValueError) as te:
            tcommon.validate_new_ids(torch.as_tensor(bad), tidx.list_indices,
                                     tidx.phys_sizes)
        assert str(te.value).split(":")[:2] == str(je.value).split(":")[:2]
    tcommon.validate_new_ids(torch.tensor([4000, 4001]), tidx.list_indices,
                             tidx.phys_sizes)
    for fam, idx in ((tivf, tidx),):
        with pytest.raises(ValueError, match="already live"):
            fam.extend(idx, x[:2], np.array([5, 9000], np.int32))
        with pytest.raises(ValueError, match="duplicate"):
            fam.extend(idx, x[:2], np.array([9000, 9000], np.int32))


def test_adaptive_centers_extend_matches_jax():
    x = _data(4, _N0 + 300)
    jfam, tfam, jidx = _pair("ivf_flat", x[:_N0],
                             np.arange(_N0, dtype=np.int32),
                             adaptive_centers=True)
    tidx = _carry(tfam, jidx)
    jext = jax_ivf.extend(jidx, jnp.asarray(x[_N0:]))
    text = tivf.extend(tidx, x[_N0:])
    np.testing.assert_allclose(text.centers.numpy(), np.asarray(jext.centers),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(text.centers.numpy(), np.asarray(jidx.centers))
    np.testing.assert_array_equal(text.list_indices.numpy(),
                                  np.asarray(jext.list_indices))


def _storage(dtype, x):
    if dtype == "int8":
        return np.round(x * 200 - 100).astype(np.int8)
    if dtype == "uint8":
        return np.round(x * 255).astype(np.uint8)
    return x


@pytest.mark.parametrize("dtype", ["int8", "uint8", "bfloat16"])
def test_storage_types_match_jax(dtype):
    """A JAX-built index over int8 / uint8 / bfloat16 rows, carried and
    searched with float32 queries, then extended, as the JAX package does
    it; the port's own build of such rows stores them in their type and
    equals its build of the rows widened to float32."""
    x = _storage(dtype, _data(5, _N0 + 256))
    jx = (jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16"
          else jnp.asarray(x))
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=_LISTS,
                                             kmeans_n_iters=4, seed=1),
                         jx[:_N0])
    tidx = _carry(tivf, jidx)
    tdt = {"int8": torch.int8, "uint8": torch.uint8,
           "bfloat16": torch.bfloat16}[dtype]
    assert tidx.list_data.dtype == tdt
    q = _storage(dtype, _data(6, 30)).astype(np.float32)
    sp_j, sp_t = jax_ivf.SearchParams(n_probes=4), tivf.SearchParams(4)
    _assert_search_parity(tivf.search(sp_t, tidx, q, _K),
                          jax_ivf.search(sp_j, jidx, jnp.asarray(q), _K))
    new = (torch.as_tensor(np.asarray(jx[_N0:], np.float32)).to(tdt)
           if dtype == "bfloat16" else x[_N0:])
    jext = jax_ivf.extend(jidx, jx[_N0:])
    text = tivf.extend(tidx, new)
    wide = np.asarray(jx, np.float32)
    moved = _assert_tables(text, jext, wide, np.asarray(jidx.centers,
                                                        np.float32))
    assert moved <= 1
    _assert_search_parity(tivf.search(sp_t, text, q, _K),
                          jax_ivf.search(sp_j, jext, jnp.asarray(q), _K))
    # the port's build: stored in its type, as the float32 build of the
    # widened rows
    own = tivf.build(tivf.IndexParams(n_lists=_LISTS, kmeans_n_iters=4),
                     torch.as_tensor(np.asarray(jx[:_N0], np.float32)
                                     ).to(tdt) if dtype == "bfloat16"
                     else x[:_N0], device="cpu")
    wide_idx = tivf.build(tivf.IndexParams(n_lists=_LISTS, kmeans_n_iters=4),
                          wide[:_N0], device="cpu")
    assert own.list_data.dtype == tdt
    assert torch.equal(own.list_indices, wide_idx.list_indices)
    assert torch.equal(own.list_data.float(), wide_idx.list_data)
    d0, i0 = tivf.search(sp_t, own, q, _K)
    d1, i1 = tivf.search(sp_t, wide_idx, q, _K)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


def test_extend_layout_and_remap_match_jax():
    """The table arithmetic itself, on random counts: every field of the
    grown layout, and a chunk-table remap, equal the JAX package's."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 60, 12)
    lay = tcommon.chunk_layout(counts)
    added = rng.integers(0, 40, 12)
    got = tcommon.extend_layout(counts, added, lay.cap, lay.chunk_table,
                                lay.n_phys)
    ref = jax_common.extend_layout(counts, added, lay.cap, lay.chunk_table,
                                   lay.n_phys)
    assert got.m == ref.m and got.max_chunks2 == ref.max_chunks2
    for name in ("counts_total", "chunk_table", "owner", "phys_sizes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    row_map = np.where(rng.random(lay.n_phys + 1) < 0.3, -1,
                       np.arange(lay.n_phys + 1))
    np.testing.assert_array_equal(
        tcommon.remap_chunk_table(lay.chunk_table, row_map, 99),
        jax_common.remap_chunk_table(lay.chunk_table, row_map, 99))
