"""Index archives move both ways between the port and the JAX package.

A version 2 archive that ``raft_tpu`` writes loads with every array
as stored; a version 1 archive (no list-side ADC tables) loads with
``list_adc`` / ``list_csum`` recomputed to rtol 1e-5 of the JAX
package's tables.  A damaged archive raises ``CorruptionError``; another
index kind or an unknown version raises too.  ``save_ivf_flat`` (float32,
int8, uint8) and ``save_ivf_pq`` archives of the port are read by
``raft_tpu.neighbors.serialize`` and the reverse, every array as stored
and the same search results; a bfloat16 IVF-Flat archive round-trips
through the port (the JAX package cannot read its own, ROADMAP §C); a
corrupt or truncated archive of each kind raises ``CorruptionError``;
a save leaves no temporary file behind.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import serialize as jax_ser
import torch

from raft_tpu_torch.core.error import CorruptionError
from raft_tpu_torch.neighbors import ivf_flat as tivf
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


def _flat_data(dtype, n=900, seed=3):
    x = np.random.default_rng(seed).random((n, 12)).astype(np.float32)
    if dtype == "int8":
        return np.round(x * 200 - 100).astype(np.int8)
    if dtype == "uint8":
        return np.round(x * 255).astype(np.uint8)
    return x


@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8"])
def test_ivf_flat_archives_move_both_ways(dtype, tmp_path):
    x = _flat_data(dtype)
    q = _flat_data(dtype, n=25, seed=4).astype(np.float32)
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=6), jnp.asarray(x))
    # JAX → port
    jax_ser.save_ivf_flat(tmp_path / "j", jidx)
    tidx = tser.load_ivf_flat(tmp_path / "j", device="cpu")
    for name in tivf.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tidx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    # port → JAX: the port's own build, extended
    own = tivf.extend(tivf.build(tivf.IndexParams(n_lists=6), x[:700],
                                 device="cpu"), x[700:])
    tser.save_ivf_flat(tmp_path / "t", own)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.npz", "t.npz"]
    back = jax_ser.load_ivf_flat(tmp_path / "t")
    for name in tivf.ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(own, name).numpy())
    assert back.metric == int(own.metric)
    d, i = tivf.search(tivf.SearchParams(3), own, q, 5)
    rd, ri = jax_ivf.search(jax_ivf.SearchParams(n_probes=3), back,
                            jnp.asarray(q), 5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    again = tser.load_ivf_flat(tmp_path / "t", device="cpu")
    d2, i2 = tivf.search(tivf.SearchParams(3), again, q, 5)
    assert torch.equal(d, d2) and torch.equal(i, i2)


def test_bf16_ivf_flat_archive_round_trips(tmp_path):
    x = torch.as_tensor(_flat_data("float32")).to(torch.bfloat16)
    own = tivf.build(tivf.IndexParams(n_lists=6), x, device="cpu")
    tser.save_ivf_flat(tmp_path / "b", own)
    with np.load(tmp_path / "b.npz") as z:
        assert z["list_data"].dtype == np.dtype("V2")
    back = tser.load_ivf_flat(tmp_path / "b", device="cpu")
    assert back.list_data.dtype == torch.bfloat16
    assert torch.equal(back.list_data.view(torch.int16),
                       own.list_data.view(torch.int16))
    # the JAX package writes the same layout and cannot read it back
    jidx = jax_ivf.build(jax_ivf.IndexParams(n_lists=6),
                         jnp.asarray(x.float().numpy(), jnp.bfloat16))
    jax_ser.save_ivf_flat(tmp_path / "jb", jidx)
    tj = tser.load_ivf_flat(tmp_path / "jb", device="cpu")
    assert tj.list_data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tj.list_data.view(torch.int16).numpy(),
        np.asarray(jidx.list_data).view(np.int16))
    with pytest.raises(TypeError):
        jax_ser.load_ivf_flat(tmp_path / "jb")


def test_ivf_pq_archive_port_to_jax(jidx, tmp_path):
    tidx = tser.load_ivf_pq(_saved(jidx, tmp_path), device="cpu")
    x = np.random.default_rng(11).standard_normal((300, 16)).astype(
        np.float32)
    ext = tpq.extend(tidx, x)
    tser.save_ivf_pq(tmp_path / "t", ext)
    back = jax_ser.load_ivf_pq(tmp_path / "t")
    for name in tpq.ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(ext, name).numpy())
    assert (back.pq_bits, back.dataset_dtype) == (5, "float32")
    q = np.random.default_rng(12).standard_normal((20, 16)).astype(
        np.float32)
    d, i = tpq.search(tpq.SearchParams(n_probes=4), ext, q, 5)
    rd, ri = jax_pq.search(jax_pq.SearchParams(n_probes=4), back,
                           jnp.asarray(q), 5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def _saved(jidx, tmp_path):
    jax_ser.save_ivf_pq(tmp_path / "j", jidx)
    return tmp_path / "j"


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_corrupt_or_truncated_port_archive_raises(jidx, kind, tmp_path):
    if kind == "ivf_flat":
        idx = tivf.build(tivf.IndexParams(n_lists=6), _flat_data("float32"),
                         device="cpu")
        save, load = tser.save_ivf_flat, tser.load_ivf_flat
    else:
        idx = tser.load_ivf_pq(_saved(jidx, tmp_path), device="cpu")
        save, load = tser.save_ivf_pq, tser.load_ivf_pq
    save(tmp_path / "a", idx)
    raw = (tmp_path / "a.npz").read_bytes()
    (tmp_path / "cut.npz").write_bytes(raw[:len(raw) // 2])
    with pytest.raises(CorruptionError):
        load(tmp_path / "cut", device="cpu")
    # a flipped byte in an array: the zip's own CRC or the manifest
    flipped = bytearray(raw)
    flipped[len(raw) // 3] ^= 0xFF
    (tmp_path / "flip.npz").write_bytes(bytes(flipped))
    with pytest.raises(CorruptionError):
        load(tmp_path / "flip", device="cpu")
    with pytest.raises(Exception, match="index"):
        (tser.load_ivf_pq if kind == "ivf_flat" else tser.load_ivf_flat)(
            tmp_path / "a", device="cpu")
