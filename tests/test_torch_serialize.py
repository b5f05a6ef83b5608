"""The port reads the JAX package's IVF-PQ archives with numpy only.

A version 2 archive that ``raft_tpu`` writes loads with every array
as stored; a version 1 archive (no list-side ADC tables) loads with
``list_adc`` / ``list_csum`` recomputed to rtol 1e-5 of the JAX
package's tables.  A damaged archive raises ``CorruptionError``; another
index kind or an unknown version raises too.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
from raft_tpu_torch.core.error import CorruptionError
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import serialize as tser


@pytest.fixture(scope="module")
def jidx():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    return jax_pq.build(jax_pq.IndexParams(n_lists=10, pq_dim=8, pq_bits=5),
                        jnp.asarray(x))


def _write(path, arrays, aux, version, kind="ivf_pq"):
    arrays = dict(arrays)
    header = {"magic": "raft-tpu-index", "version": version, "kind": kind,
              "aux": aux, "checksums": jax_ser._checksums(arrays)}
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    np.savez(path, **arrays)


def test_v2_archive_loads_as_stored(jidx, tmp_path):
    path = tmp_path / "pq"
    jax_ser.save_ivf_pq(path, jidx)
    tidx = tser.load_ivf_pq(path, device="cpu")
    assert tidx.pq_bits == 5 and tidx.metric == int(jidx.metric)
    for name in tpq.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    q = np.random.default_rng(8).standard_normal((20, 16)).astype(np.float32)
    d, i = tpq.search(tpq.SearchParams(n_probes=4), tidx, q, 5)
    rd, ri = jax_pq.search(jax_pq.SearchParams(n_probes=4), jidx,
                           jnp.asarray(q), 5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def test_v1_archive_recomputes_the_list_tables(jidx, tmp_path):
    aux = {"metric": int(jidx.metric), "codebook_kind": 0, "pq_bits": 5,
           "dataset_dtype": "float32"}
    arrays = {n: np.asarray(getattr(jidx, n)) for n in tpq.ARRAY_FIELDS
              if n not in ("list_adc", "list_csum")}
    path = tmp_path / "v1.npz"
    _write(path, arrays, aux, version=1)
    tidx = tser.load_ivf_pq(path, device="cpu")
    ref = jax_ser.load_ivf_pq(path)
    np.testing.assert_allclose(tidx.list_adc.numpy(), np.asarray(ref.list_adc),
                               rtol=1e-5, atol=1e-4)
    live = (np.arange(tidx.capacity)[None, :]
            < tidx.phys_sizes.numpy()[:, None])
    stored = np.asarray(jidx.list_csum)
    np.testing.assert_allclose(tidx.list_csum.numpy()[live], stored[live],
                               rtol=1e-5, atol=1e-5 * np.abs(stored).max())


def test_damaged_or_foreign_archives_raise(jidx, tmp_path):
    aux = {"metric": int(jidx.metric), "codebook_kind": 0, "pq_bits": 5,
           "dataset_dtype": "float32"}
    arrays = {n: np.asarray(getattr(jidx, n)) for n in tpq.ARRAY_FIELDS}
    good = jax_ser._checksums(arrays)
    arrays["list_codes"] = arrays["list_codes"].copy()
    arrays["list_codes"].flat[3] ^= 1
    bad = tmp_path / "bad.npz"
    _write(bad, arrays, aux, version=2)
    # a manifest taken before the flip no longer matches
    with np.load(bad) as z:
        parts = {k: z[k] for k in z.files if k != "__header__"}
    header = {"magic": "raft-tpu-index", "version": 2, "kind": "ivf_pq",
              "aux": aux, "checksums": good}
    parts["__header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez(bad, **parts)
    with pytest.raises(CorruptionError, match="checksum"):
        tser.load_ivf_pq(bad, device="cpu")
    (tmp_path / "trunc.npz").write_bytes(b"PK\x03\x04 not a zip")
    with pytest.raises(CorruptionError):
        tser.load_ivf_pq(tmp_path / "trunc.npz", device="cpu")
    _write(tmp_path / "v9.npz", {}, aux, version=9)
    with pytest.raises(Exception, match="version"):
        tser.load_ivf_pq(tmp_path / "v9.npz", device="cpu")
    x = np.zeros((64, 4), np.float32)
    jax_ser.save_ivf_flat(tmp_path / "flat",
                          jax_ivf.build(jax_ivf.IndexParams(n_lists=4),
                                        jnp.asarray(x)))
    with pytest.raises(Exception, match="ivf_flat index"):
        tser.load_ivf_pq(tmp_path / "flat", device="cpu")
