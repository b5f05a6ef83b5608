"""Parity of the port's select_k and merge_sorted_runs with raft_tpu.

The contract compares values and never sums them, so positions and values
must be BIT-IDENTICAL to the JAX package's XLA engine (and to its Pallas
kernel in interpret mode): best-first, ties at the lowest position, NaN
ranked as the worst value, values gathered from the raw input.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages' matrix/__init__ re-export the function select_k, which
# shadows the module of the same name on attribute import
jax_kernel = importlib.import_module("raft_tpu.kernels.select_k")
jax_sk = importlib.import_module("raft_tpu.matrix.select_k")
sk = importlib.import_module("raft_tpu_torch.matrix.select_k")


def _values(rows, n, seed, dtype=np.float32):
    """Rounded values (many exact ties) with NaN and ±inf sprinkled in."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-40, 40, (rows, n)) / 4.0).astype(dtype)
    flat = v.reshape(-1)
    spots = rng.choice(flat.size, size=max(3, flat.size // 50), replace=False)
    third = len(spots) // 3
    flat[spots[:third]] = np.nan
    flat[spots[third:2 * third]] = np.inf
    flat[spots[2 * third:]] = -np.inf
    return v


def _assert_same(port, ref):
    pv, pi = port
    rv, ri = ref
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.float().numpy(),
                                  np.asarray(rv).astype(np.float32))


_CASES = [(k, n) for k in (1, 10, 20, 24, 128) for n in (20, 257, 1024)
          if k <= n]


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k,n", _CASES)
def test_select_k_bit_identical(k, n, select_min):
    v = _values(6, n, seed=k * 1000 + n)
    port = sk.select_k(torch.from_numpy(v), k, select_min, engine="torch")
    ref = jax_sk.select_k(jnp.asarray(v, jnp.float32), k, select_min,
                          engine="xla")
    _assert_same(port, ref)


def test_select_k_payload_and_batch_dims():
    v = _values(2 * 3, 257, seed=7).reshape(2, 3, 257)
    ids = np.random.default_rng(8).permutation(257 * 6).astype(
        np.int32).reshape(2, 3, 257)
    port = sk.select_k(torch.from_numpy(v), 10, True,
                       indices=torch.from_numpy(ids), engine="torch")
    ref = jax_sk.select_k(jnp.asarray(v, jnp.float32), 10, True,
                          indices=jnp.asarray(ids, jnp.int32), engine="xla")
    _assert_same(port, ref)


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_bf16(select_min):
    v = _values(5, 300, seed=11)
    vt = torch.from_numpy(v).bfloat16()
    port = sk.select_k(vt, 20, select_min, engine="torch")
    ref = jax_sk.select_k(jnp.asarray(v).astype(jnp.bfloat16), 20,
                          select_min, engine="xla")
    assert port[0].dtype == torch.bfloat16
    _assert_same(port, ref)


def test_select_k_matches_pallas_interpret():
    """One tiny case through the TPU kernel itself (interpret mode)."""
    v = _values(8, 40, seed=3)
    ref = jax_kernel.select_k_blockwise(jnp.asarray(v, jnp.float32), 5,
                                        True, interpret=True)
    port = sk.select_k(torch.from_numpy(v), 5, True, engine="torch")
    _assert_same(port, ref)


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    from raft_tpu_torch.kernels import select_k as kernel

    v = torch.from_numpy(_values(4, 100, seed=5))
    a = kernel.select_k_blockwise(v, 10, False)
    b = sk.select_k_plain(v, 10, False)
    assert torch.equal(a[1], b[1])
    assert kernel.supports(128, 128, torch.float16)
    assert not kernel.supports(129, 1000, torch.float32)
    assert not kernel.supports(5, 100, torch.int32)
    assert not kernel.supports(5, 100, torch.float64)


def test_select_k_int_dtype_uses_plain():
    v = np.random.default_rng(2).integers(0, 20, (4, 64)).astype(np.int32)
    port = sk.select_k(torch.from_numpy(v), 8, True, engine="torch")
    ref = jax_sk.select_k(jnp.asarray(v, jnp.int32), 8, True, engine="xla")
    _assert_same(port, ref)


def _sorted_run(rows, kk, seed, select_min):
    v = _values(rows, 3 * kk, seed)
    vals, pos = jax_sk.select_k(jnp.asarray(v, jnp.float32), kk, select_min,
                                engine="xla")
    return np.array(vals), np.array(pos) + seed * 1000


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("ka,kb,k", [(5, 5, 5), (10, 10, 10), (10, 4, 12),
                                     (24, 24, 24), (32, 16, 32)])
def test_merge_sorted_runs_bit_identical(ka, kb, k, select_min):
    av, ai = _sorted_run(6, ka, 1, select_min)
    bv, bi = _sorted_run(6, kb, 2, select_min)
    port = sk.merge_sorted_runs(torch.from_numpy(av), torch.from_numpy(ai),
                                torch.from_numpy(bv), torch.from_numpy(bi),
                                k, select_min)
    ref = jax_sk.merge_sorted_runs(jnp.asarray(av), jnp.asarray(ai),
                                   jnp.asarray(bv), jnp.asarray(bi), k,
                                   select_min)
    _assert_same(port, ref)


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("in_k,k", [(6, 6), (6, 4), (6, 15)])
def test_merge_sorted_parts_bit_identical(in_k, k, select_min):
    """Three stacked parts folded from part 0; k > in_k pads part 0."""
    parts = [_sorted_run(5, in_k, seed, select_min) for seed in (1, 2, 3)]
    pv = np.stack([p[0] for p in parts])
    pi = np.stack([p[1] for p in parts])
    port = sk.merge_sorted_parts(torch.from_numpy(pv), torch.from_numpy(pi),
                                 k, select_min)
    ref = jax_sk.merge_sorted_parts(jnp.asarray(pv), jnp.asarray(pi), k,
                                    select_min)
    _assert_same(port, ref)


@pytest.mark.parametrize("select_min", [True, False])
def test_select_min_max_k(select_min):
    v = _values(4, 50, 9)
    fn = sk.select_min_k if select_min else sk.select_max_k
    port = fn(torch.from_numpy(v), 7)
    ref = (jax_sk.select_min_k if select_min else jax_sk.select_max_k)(
        jnp.asarray(v), 7)
    _assert_same(port, ref)
