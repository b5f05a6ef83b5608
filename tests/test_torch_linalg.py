"""The port's dense linalg surface against raft_tpu on the CPU: util,
linalg types, elementwise and matrix-vector operations, every reduction
and the BLAS layer, on the same seeded inputs.

Tolerances: float32 reductions and products to rtol 1e-5 (atol 1e-6 for
values near 0; a long sum of signed terms to 1e-5 of Σ|terms|): the two
packages sum in other orders; elementwise and
broadcast operations to rtol 1e-6 (one rounding each); integer, index
and exact operations (min, max, the fold of ``fmax``) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.linalg as jl
import raft_tpu.util as ju
import raft_tpu_torch.linalg as tl
import raft_tpu_torch.util as tu
from raft_tpu.linalg import Apply as JApply
from raft_tpu.linalg import NormType as JNorm
from raft_tpu_torch.linalg import Apply, NormType


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(16)
    return {"x": rng.standard_normal((37, 19)).astype(np.float32),
            "y": (rng.random((37, 19)) + 0.5).astype(np.float32),
            "z": rng.standard_normal((37, 19)).astype(np.float32),
            "rows": rng.standard_normal(37).astype(np.float32),
            "cols": rng.standard_normal(19).astype(np.float32),
            "a": rng.standard_normal((23, 31)).astype(np.float32),
            "b": rng.standard_normal((31, 17)).astype(np.float32),
            "c": rng.standard_normal((23, 17)).astype(np.float32),
            "v": rng.standard_normal(31).astype(np.float32),
            "w": rng.standard_normal(23).astype(np.float32)}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# -- util ---------------------------------------------------------------------

@pytest.mark.parametrize("a,b", [(0, 1), (1, 1), (7, 3), (128, 128),
                                 (129, 128), (1000, 7)])
def test_util_math(a, b):
    for name in ("ceildiv", "round_up_safe", "alignTo", "alignDown"):
        assert getattr(tu, name)(a, b) == getattr(ju, name)(a, b), name
    for v in (a, b):
        assert tu.is_pow2(v) == ju.is_pow2(v)
        assert tu.next_pow2(v) == ju.next_pow2(v)


@pytest.mark.parametrize("value", [1, 8, 128, 1024])
def test_util_pow2(value):
    tp, jp = tu.Pow2(value), ju.Pow2(value)
    for x in (0, 1, 7, 129, 1000, 4097):
        for m in ("round_down", "round_up", "div", "mod", "is_aligned"):
            assert getattr(tp, m)(x) == getattr(jp, m)(x), (m, x)
    with pytest.raises(ValueError):
        tu.Pow2(value + 3 if value > 1 else 3)


def test_util_seive_and_product():
    assert np.array_equal(tu.Seive(200).primes(), ju.Seive(200).primes())
    assert tu.Seive(97).is_prime(97) and not tu.Seive(97).is_prime(91)
    axes = dict(n=[1, 2], metric=["l2", "l1"], k=[3])
    assert tu.product_of(**axes) == ju.product_of(**axes)


@pytest.mark.parametrize("shape", [(5,), (3, 5), (9, 130), (2, 8, 128),
                                   (2, 3, 7)])
@pytest.mark.parametrize("np_dtype,t_dtype", [(np.float32, torch.float32),
                                              (np.float16, torch.float16),
                                              (np.int8, torch.int8)])
def test_util_tiling(shape, np_dtype, t_dtype):
    assert tu.min_tile(t_dtype) == ju.min_tile(np_dtype)
    assert (tu.LANE, tu.SUBLANE) == (ju.LANE, ju.SUBLANE)
    x = np.arange(int(np.prod(shape))).reshape(shape).astype(np_dtype)
    jp, jshape = ju.pad_to_tile(jnp.asarray(x), fill=3)
    tp, tshape = tu.pad_to_tile(T(x).to(t_dtype), fill=3)
    assert tuple(tshape) == tuple(jshape)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tu.unpad(tp, tshape).numpy(), x)
    assert tu.pad_dim(0, 8) == ju.pad_dim(0, 8) == 8


# -- types, elementwise, matrix-vector ---------------------------------------

def test_types():
    assert [a.value for a in Apply] == [a.value for a in JApply]
    assert [n.value for n in NormType] == [n.value for n in JNorm]
    for a, ja in zip(Apply, JApply):
        assert tl.axis_for(a) == jl.axis_for(ja)


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "power"])
def test_elementwise_binary(data, name):
    x, y = np.abs(data["x"]), data["y"]
    close(getattr(tl, name)(T(x), T(y)), getattr(jl, name)(x, y), rtol=1e-6)


@pytest.mark.parametrize("name", ["add_scalar", "subtract_scalar",
                                  "multiply_scalar", "divide_scalar",
                                  "power_scalar"])
def test_elementwise_scalar(data, name):
    y = data["y"]
    close(getattr(tl, name)(T(y), 1.7), getattr(jl, name)(y, 1.7),
          rtol=1e-6)


def test_elementwise_ops(data):
    x, y, z = data["x"], data["y"], data["z"]
    close(tl.sqrt(T(y)), jl.sqrt(y), rtol=1e-6)
    close(tl.unary_op(T(x), lambda a: a * 2 + 1),
          jl.unary_op(x, lambda a: a * 2 + 1), rtol=1e-6)
    close(tl.binary_op(T(x), T(y), lambda a, b: a * b - a),
          jl.binary_op(x, y, lambda a, b: a * b - a), rtol=1e-6)
    close(tl.ternary_op(T(x), T(y), T(z), lambda a, b, c: a + b * c),
          jl.ternary_op(x, y, z, lambda a, b, c: a + b * c), rtol=1e-6)
    close(tl.map_(lambda a, b: a - b, T(x), T(y)),
          jl.map_(lambda a, b: a - b, x, y), rtol=1e-6)
    got = tl.map_offset((4, 6), lambda i: i * 3 + 1, device="cpu")
    assert np.array_equal(got.numpy(),
                          np.asarray(jl.map_offset((4, 6),
                                                   lambda i: i * 3 + 1)))


@pytest.mark.parametrize("bcast_along_rows", [True, False])
@pytest.mark.parametrize("name", ["binary_mult", "binary_div", "binary_add",
                                  "binary_sub"])
def test_matrix_vector_named(data, name, bcast_along_rows):
    x = data["x"]
    vec = data["cols"] if bcast_along_rows else data["rows"]
    close(getattr(tl, name)(T(x), T(vec), bcast_along_rows),
          getattr(jl, name)(x, vec, bcast_along_rows), rtol=1e-6)


@pytest.mark.parametrize("bcast_along_rows", [True, False])
@pytest.mark.parametrize("return_zero", [True, False])
def test_binary_div_skip_zero(data, bcast_along_rows, return_zero):
    x = data["x"]
    vec = (data["cols"] if bcast_along_rows else data["rows"]).copy()
    vec[::3] = 0.0
    close(tl.binary_div_skip_zero(T(x), T(vec), bcast_along_rows,
                                  return_zero),
          jl.binary_div_skip_zero(x, vec, bcast_along_rows, return_zero),
          rtol=1e-6)


@pytest.mark.parametrize("bcast_along_rows", [True, False])
def test_matrix_vector_op(data, bcast_along_rows):
    x = data["x"]
    v1 = data["cols"] if bcast_along_rows else data["rows"]
    v2 = v1[::-1].copy()
    close(tl.matrix_vector_op(T(x), T(v1), lambda m, v: m * v + v,
                              bcast_along_rows),
          jl.matrix_vector_op(x, v1, lambda m, v: m * v + v,
                              bcast_along_rows), rtol=1e-6)
    close(tl.matrix_vector_op2(T(x), T(v1), T(v2),
                               lambda m, a, b: m * a - b, bcast_along_rows),
          jl.matrix_vector_op2(x, v1, v2, lambda m, a, b: m * a - b,
                               bcast_along_rows), rtol=1e-6)


# -- reductions ---------------------------------------------------------------

_FOLDS = {"add": (torch.add, jnp.add), "min": (torch.minimum, jnp.minimum),
          "max": (torch.maximum, jnp.maximum),
          "fmax": (torch.fmax, jnp.fmax),
          "mul": (lambda a, b: a * b, lambda a, b: a * b)}


@pytest.mark.parametrize("fold,init", [("add", None), ("add", 0.5),
                                       ("min", None), ("min", 0.5),
                                       ("max", 0.5), ("fmax", None),
                                       ("mul", None)])
@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_reduce(data, fold, apply, init):
    x = data["y"] if fold == "mul" else data["x"]
    if fold in ("fmax", "mul"):
        # the generic fold: the JAX package's associative_scan compiles
        # slowly, so a smaller block
        x = x[:8, :6].copy()
    t_op, j_op = _FOLDS[fold]
    got = tl.reduce(T(x), Apply[apply], init=init, main_op=lambda a: a * 1.5,
                    reduce_op=t_op, final_op=lambda a: a - 1,
                    inplace_add=T(np.float32(0.25)))
    want = jl.reduce(x, JApply[apply], init=init, main_op=lambda a: a * 1.5,
                     reduce_op=j_op, final_op=lambda a: a - 1,
                     inplace_add=np.float32(0.25))
    if fold in ("min", "max", "fmax"):
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_reduce_half_sums_in_float32(data, dtype):
    """Half inputs: the port sums in float32 and returns the input type,
    the JAX package's ``_acc_dtype`` rule; against the JAX package's sum
    to the half type's rounding."""
    x = data["y"]
    jx = jnp.asarray(x).astype(dtype)
    tx = T(x).to(getattr(torch, dtype))
    got = tl.reduce(tx)
    assert got.dtype == tx.dtype
    want = np.asarray(jl.reduce(jx)).astype(np.float32)
    tol = {"float32": 1e-5, "float16": 1e-3, "bfloat16": 8e-3}[dtype]
    close(got.float(), want, rtol=tol)


@pytest.mark.parametrize("name", ["coalesced_reduction",
                                  "strided_reduction"])
def test_coalesced_strided(data, name):
    x = data["x"]
    close(getattr(tl, name)(T(x), main_op=lambda a: a * a),
          getattr(jl, name)(x, main_op=lambda a: a * a))
    # the port's tree fold of fmax against the JAX package's max
    got = getattr(tl, name)(T(x), reduce_op=torch.fmax)
    assert np.array_equal(got.numpy(), np.asarray(
        getattr(jl, name)(x, reduce_op=jnp.maximum)))


@pytest.mark.parametrize("fold", ["add", "max", "mul"])
def test_map_then_reduce(data, fold):
    x, y = data["x"], data["y"]
    if fold != "add":                  # the generic fold, a smaller block
        x, y = x[:8, :6].copy(), y[:8, :6].copy()
    t_op, j_op = _FOLDS[fold]
    got = tl.map_then_reduce(lambda a, b: a * 0.5 + b, T(x), T(y),
                             reduce_op=t_op)
    want = jl.map_then_reduce(lambda a, b: a * 0.5 + b, x, y,
                              reduce_op=j_op)
    close(got, want, rtol=1e-4 if fold == "mul" else 1e-5)
    close(tl.map_reduce(lambda a: a * a, t_op, T(y)),
          jl.map_reduce(lambda a: a * a, j_op, y),
          rtol=1e-4 if fold == "mul" else 1e-5)


def test_mean_squared_error(data):
    x, z = data["x"], data["z"]
    close(tl.mean_squared_error(T(x), T(z), 0.5),
          jl.mean_squared_error(x, z, 0.5))


@pytest.mark.parametrize("norm", ["L1Norm", "L2Norm", "LinfNorm"])
@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_norms(data, norm, apply):
    x = data["x"]
    close(tl.norm(T(x), NormType[norm], Apply[apply], torch.sqrt),
          jl.norm(x, JNorm[norm], JApply[apply], jnp.sqrt))
    if apply == "ALONG_COLUMNS":
        close(tl.row_norm(T(x), NormType[norm]),
              jl.row_norm(x, JNorm[norm]))
    else:
        close(tl.col_norm(T(x), NormType[norm]),
              jl.col_norm(x, JNorm[norm]))


@pytest.mark.parametrize("norm", ["L1Norm", "L2Norm", "LinfNorm"])
@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_normalize(data, norm, apply):
    x = data["x"].copy()
    x[3] = 0.0                       # a zero row stays as it is
    x[:, 5] = 0.0
    close(tl.normalize(T(x), NormType[norm], 1e-8, Apply[apply]),
          jl.normalize(x, JNorm[norm], 1e-8, JApply[apply]))


@pytest.mark.parametrize("n_keys", [1, 7, 4096, 4097])
def test_use_one_hot_engine(n_keys):
    # the JAX package on the CPU never takes the one-hot engine
    assert tl.use_one_hot_engine(n_keys, "cpu") is False
    assert jl.use_one_hot_engine(n_keys) is False
    assert tl.use_one_hot_engine(n_keys, "cuda") is (n_keys <= 4096)


# -- BLAS ---------------------------------------------------------------------

@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.5, 0.0), (0.5, 1.5)])
def test_gemm(data, trans_a, trans_b, alpha, beta):
    a = data["a"].T.copy() if trans_a else data["a"]
    b = data["b"].T.copy() if trans_b else data["b"]
    c = data["c"]
    got = tl.gemm(T(a), T(b), alpha, beta, T(c) if beta else None, trans_a,
                  trans_b)
    want = jl.gemm(a, b, alpha, beta, c if beta else None, trans_a, trans_b,
                   precision="highest")
    close(got, want)


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.5, 0.5)])
def test_gemv(data, trans_a, alpha, beta):
    a = data["a"].T.copy() if trans_a else data["a"]
    v, w = data["v"], data["w"]
    got = tl.gemv(T(a), T(v), alpha, beta, T(w) if beta else None, trans_a)
    want = jl.gemv(a, v, alpha, beta, w if beta else None, trans_a,
                   precision="highest")
    close(got, want)


def test_axpy_dot_transpose(data):
    x, z = data["x"], data["z"]
    close(tl.axpy(0.75, T(x), T(z)), jl.axpy(0.75, x, z), rtol=1e-6)
    # a sum of signed terms: to 1e-5 of Σ|terms|
    close(tl.dot(T(x), T(z)), jl.dot(x, z),
          atol=1e-5 * float(np.abs(x * z).sum()))
    t = tl.transpose(T(x))
    assert t.is_contiguous()
    assert np.array_equal(t.numpy(), np.asarray(jl.transpose(x)))
