"""Pairwise distances (port of ``raft_tpu/distance/pairwise.py``; reference
distance/distance.cuh:62-417, runtime switch :305).

Two engines, as in the JAX package:

1. Inner-product metrics (the expanded L2 forms, cosine, correlation,
   inner product, Hellinger, RusselRao, KL) are an epilogue over
   ``x @ y.T`` (:func:`_mxu_dot`, a plain ``torch.matmul``, as the JAX
   package leaves the product to XLA).
2. Metrics with no inner-product form reduce elementwise terms over k.
   On the card, kernel B5 (:mod:`raft_tpu_torch.kernels.pairwise`)
   accumulates L1, L2Unexpanded, L2SqrtUnexpanded, Linf, Canberra,
   LpUnexpanded and HammingUnexpanded and the epilogue (sqrt, ^(1/p), /k)
   runs outside it (:func:`_try_kernel`); ``engine="torch"``, the CPU,
   BrayCurtis and JensenShannon take :func:`_blocked_reduce`, the JAX
   package's broadcast-reduce over fixed (128, 512) tiles.

A query row gets the same bits whatever the batch it rides in: products
run in fixed 1,024-row blocks (:func:`_dot_fixed_rows`), the tiles of
:func:`_blocked_reduce` have one shape, and B5 sums in k order.  bfloat16
and float16 inputs give float32 distances (:func:`accum_dtype`).  Float32
products run in full float32: the port never enables TF32
(``torch.backends.cuda.matmul.allow_tf32`` stays False), matching the JAX
package's "highest" precision.  :func:`pairwise_distance` runs through
``_distance_aot`` (:mod:`raft_tpu_torch.core.aot`), which keys its
signatures as the JAX file's AOT dispatch does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from raft_tpu_torch.core.aot import aot
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.core.handle import (auto_sync_handle, device_of,
                                       resolve_device)
from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    DistanceType)

_BM = 128   # row block of _blocked_reduce
_BN = 512   # column block of _blocked_reduce
#: the one row count of every product (see _dot_fixed_rows)
_GEMM_ROWS = 1024

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def accum_dtype(dt: torch.dtype) -> torch.dtype:
    """The accumulation and output type: float32 for bfloat16 and float16
    inputs, the input type otherwise."""
    return torch.float32 if dt in _HALF_DTYPES else dt


def _dot_fixed_rows(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``q @ c.T`` run in blocks of exactly :data:`_GEMM_ROWS` rows (the
    last one zero-padded).  cuBLAS picks its GEMM algorithm by shape, and
    at small row counts the one it picks sums in another order, so a query
    row's bits would depend on the size of the batch it rides in; one fixed
    shape gives every row the same bits in every batch — which the serving
    contract (coalesced result == solo result) rests on."""
    out = []
    for r in range(0, q.shape[0], _GEMM_ROWS):
        blk = q[r:r + _GEMM_ROWS]
        n = blk.shape[0]
        if n < _GEMM_ROWS:
            blk = torch.cat([blk, blk.new_zeros((_GEMM_ROWS - n,
                                                 blk.shape[1]))])
        out.append((blk @ c.T)[:n])
    if not out:
        return q.new_zeros((0, c.shape[0]))
    return out[0] if len(out) == 1 else torch.cat(out)


def _mxu_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T``; bfloat16 and float16 inputs are widened to float32
    (exact), so the products are exact and summed in float32, as the
    JAX package's ``preferred_element_type=float32``."""
    if x.dtype in _HALF_DTYPES:
        x, y = x.float(), y.float()
    return _dot_fixed_rows(x, y)


def _row_norms(x: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Per-row L2 norms (squared by default); half inputs accumulate in
    float32."""
    if x.dtype in _HALF_DTYPES:
        x = x.float()
    n = torch.sum(x * x, dim=1)
    return n if squared else torch.sqrt(n)


# ---------------------------------------------------------------------------
# inner-product metrics: epilogue(x @ f(y).T, row statistics); each takes
# its per-row statistics precomputed (metric_stats) or derives them
# ---------------------------------------------------------------------------

def _l2_expanded(x, y, sqrt: bool, xn=None, yn=None):
    # reference distance/detail/euclidean.cuh: ||x||² + ||y||² − 2 x·y ≥ 0
    if xn is None:
        xn = _row_norms(x)
    if yn is None:
        yn = _row_norms(y)
    d = torch.clamp_min(xn[:, None] + yn[None, :] - 2.0 * _mxu_dot(x, y),
                        0.0)
    return torch.sqrt(d) if sqrt else d


def _cosine(x, y, xn=None, yn=None):
    # reference distance/detail/cosine.cuh (xn, yn unsquared)
    if xn is None:
        xn = _row_norms(x, squared=False)
    if yn is None:
        yn = _row_norms(y, squared=False)
    denom = torch.clamp_min(xn[:, None] * yn[None, :], 1e-30)
    return 1.0 - _mxu_dot(x, y) / denom


def _corr_row_stats(x):
    """(Σx, Σx²) per row, in float32 for half inputs."""
    xf = x.float() if x.dtype in _HALF_DTYPES else x
    return torch.sum(xf, dim=1), _row_norms(x)


def _correlation(x, y, x_stats=None, y_stats=None):
    # reference distance/detail/correlation.cuh:124-128
    k = x.shape[1]
    xs, x2 = _corr_row_stats(x) if x_stats is None else x_stats
    ys, y2 = _corr_row_stats(y) if y_stats is None else y_stats
    numer = k * _mxu_dot(x, y) - xs[:, None] * ys[None, :]
    q = k * x2 - xs * xs
    r = k * y2 - ys * ys
    denom = torch.sqrt(torch.clamp_min(q[:, None] * r[None, :], 1e-30))
    return 1.0 - numer / denom


def _inner_product(x, y):
    return _mxu_dot(x, y)


def _hellinger(x, y):
    # reference distance/detail/hellinger.cuh: √(1 − Σ√(x·y)), rectified
    acc = _mxu_dot(torch.sqrt(torch.abs(x)), torch.sqrt(torch.abs(y)))
    return torch.sqrt(torch.clamp_min(1.0 - acc, 0.0))


def _russelrao(x, y):
    # reference distance/detail/russell_rao.cuh:91: (k − Σxy)/k
    k = x.shape[1]
    return (k - _mxu_dot(x, y)) * (1.0 / k)


def _kl_divergence(x, y):
    # reference distance/detail/kl_divergence.cuh:27,81-99:
    # 0.5·Σ x·(log x − log y), 0·log 0 := 0, log y := 0 where y == 0; the
    # Σ x·log x row term in float32 for half inputs
    xf = x.float() if x.dtype in _HALF_DTYPES else x
    x_log = torch.where(xf > 0, torch.log(torch.where(xf > 0, xf, 1.0)), 0.0)
    y_log = torch.where(y > 0, torch.log(torch.where(y > 0, y, 1.0)), 0.0)
    row_term = torch.sum(xf * x_log, dim=1)
    return 0.5 * (row_term[:, None] - _mxu_dot(x, y_log))


# ---------------------------------------------------------------------------
# elementwise engine: tiled broadcast-reduce over k
# ---------------------------------------------------------------------------

def _blocked_reduce(x, y, tile_fn):
    """out[i, j] = tile_fn(x[i], y[j]) over (_BM × _BN) tiles.

    tile_fn maps (bm, 1, k), (1, bn, k) → (bm, bn).  Both inputs are
    zero-padded to whole tiles, so every tile has one shape and a row's
    reduction never depends on the batch's size (the JAX package narrows
    bm to small m; the port does not).  Half inputs are widened to float32
    tile by tile."""
    m, k = x.shape
    n = y.shape[0]
    bm, bn = _BM, _BN
    if x.dtype in _HALF_DTYPES:
        inner = tile_fn
        tile_fn = lambda xi, yj: inner(xi.float(), yj.float())  # noqa: E731
    mp = -(-m // bm) * bm
    np_ = -(-n // bn) * bn
    xp = torch.cat([x, x.new_zeros((mp - m, k))]) if mp != m else x
    yp = torch.cat([y, y.new_zeros((np_ - n, k))]) if np_ != n else y
    out = torch.empty((m, n), dtype=accum_dtype(x.dtype), device=x.device)
    for r0 in range(0, m, bm):
        xi = xp[r0:r0 + bm, None, :]
        r1 = min(m, r0 + bm)
        for c0 in range(0, n, bn):
            c1 = min(n, c0 + bn)
            tile = tile_fn(xi, yp[None, c0:c0 + bn, :])
            out[r0:r1, c0:c1] = tile[:r1 - r0, :c1 - c0]
    return out


def _tile_l1(xi, yj):
    return torch.sum(torch.abs(xi - yj), dim=-1)


def _tile_l2(xi, yj):
    d = xi - yj
    return torch.sum(d * d, dim=-1)


def _tile_linf(xi, yj):
    return torch.amax(torch.abs(xi - yj), dim=-1)


def canberra_terms(x, y):
    # reference distance/detail/canberra.cuh: 0/0 → 0
    num = torch.abs(x - y)
    den = torch.abs(x) + torch.abs(y)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _tile_canberra(xi, yj):
    return torch.sum(canberra_terms(xi, yj), dim=-1)


def _tile_lp(p: float):
    def fn(xi, yj):
        return torch.pow(torch.sum(torch.pow(torch.abs(xi - yj), p), dim=-1),
                         1.0 / p)

    return fn


def _tile_hamming(xi, yj):
    # reference distance/detail/hamming.cuh: mean of (x != y)
    return torch.mean((xi != yj).to(xi.dtype), dim=-1)


def _tile_braycurtis(xi, yj):
    num = torch.sum(torch.abs(xi - yj), dim=-1)
    den = torch.sum(torch.abs(xi + yj), dim=-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def jensen_shannon_terms(x, y):
    # reference distance/detail/jensen_shannon.cuh: the per-feature
    # KL(x‖m) + KL(y‖m) terms, un-rooted
    m = 0.5 * (x + y)
    safe = m > 0

    def kl_part(a):
        ok = (a > 0) & safe
        return torch.where(ok, a * (torch.log(torch.where(a > 0, a, 1.0))
                                    - torch.log(torch.where(safe, m, 1.0))),
                           0.0)

    return kl_part(x) + kl_part(y)


def _tile_jensen_shannon(xi, yj):
    acc = torch.sum(jensen_shannon_terms(xi, yj), dim=-1)
    return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))


def _haversine(x, y):
    """Great-circle distance on (lat, lon) radian pairs (reference
    spatial/knn/detail/haversine_distance.cuh:152).  Half inputs give
    float32 distances (the JAX package returns the input type here, the
    one exception to its ``accum_dtype`` rule)."""
    expects(x.shape[1] == 2, "haversine requires k=2 (lat, lon)")
    if x.dtype in _HALF_DTYPES:
        x, y = x.float(), y.float()
    lat1, lon1 = x[:, 0][:, None], x[:, 1][:, None]
    lat2, lon2 = y[:, 0][None, :], y[:, 1][None, :]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = torch.sin(0.5 * (lon2 - lon1))
    a = sdlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sdlon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


# ---------------------------------------------------------------------------
# dispatch (reference distance.cuh:305 runtime switch)
# ---------------------------------------------------------------------------

#: metric → (B5 op, epilogue on the raw accumulation (acc, k, p))
_KERNEL_OPS = {
    DistanceType.L1: ("l1", None),
    DistanceType.L2Unexpanded: ("l2", None),
    DistanceType.L2SqrtUnexpanded: ("l2", lambda a, k, p: torch.sqrt(a)),
    DistanceType.Linf: ("linf", None),
    DistanceType.Canberra: ("canberra", None),
    DistanceType.LpUnexpanded: ("lp", lambda a, k, p: torch.pow(a, 1.0 / p)),
    DistanceType.HammingUnexpanded: ("hamming", lambda a, k, p: a / k),
}
#: the metrics kernel B5 accumulates: every metric with no inner-product
#: form except BrayCurtis and JensenShannon
ACCUMULATE_METRICS = tuple(_KERNEL_OPS)


def _try_kernel(x, y, metric: DistanceType, metric_arg: float,
                engine: Optional[str]):
    """Kernel B5 and the metric's epilogue where the engine policy
    (:func:`raft_tpu_torch.kernels.resolve_engine`, kind ``"pairwise"``)
    picks ``"cuda"``; None otherwise."""
    from raft_tpu_torch.kernels import pairwise as pk
    from raft_tpu_torch.kernels.engine import resolve_engine

    entry = _KERNEL_OPS.get(metric)
    if entry is None or resolve_engine("pairwise", x.device, metric,
                                       engine) != "cuda":
        return None
    op, epilogue = entry
    p = float(metric_arg)
    acc = pk.pairwise_accumulate(x, y, op, p)
    return acc if epilogue is None else epilogue(acc, x.shape[1], p)


def _dispatch(x, y, metric: DistanceType, metric_arg: float,
              engine: Optional[str] = None):
    out = _try_kernel(x, y, metric, metric_arg, engine)
    if out is not None:
        return out
    if metric == DistanceType.L2Expanded:
        return _l2_expanded(x, y, sqrt=False)
    if metric == DistanceType.L2SqrtExpanded:
        return _l2_expanded(x, y, sqrt=True)
    if metric == DistanceType.CosineExpanded:
        return _cosine(x, y)
    if metric == DistanceType.CorrelationExpanded:
        return _correlation(x, y)
    if metric == DistanceType.InnerProduct:
        return _inner_product(x, y)
    if metric == DistanceType.HellingerExpanded:
        return _hellinger(x, y)
    if metric == DistanceType.RusselRaoExpanded:
        return _russelrao(x, y)
    if metric == DistanceType.KLDivergence:
        return _kl_divergence(x, y)
    if metric == DistanceType.L1:
        return _blocked_reduce(x, y, _tile_l1)
    if metric == DistanceType.L2Unexpanded:
        return _blocked_reduce(x, y, _tile_l2)
    if metric == DistanceType.L2SqrtUnexpanded:
        return torch.sqrt(_blocked_reduce(x, y, _tile_l2))
    if metric == DistanceType.Linf:
        return _blocked_reduce(x, y, _tile_linf)
    if metric == DistanceType.Canberra:
        return _blocked_reduce(x, y, _tile_canberra)
    if metric == DistanceType.LpUnexpanded:
        return _blocked_reduce(x, y, _tile_lp(float(metric_arg)))
    if metric == DistanceType.HammingUnexpanded:
        return _blocked_reduce(x, y, _tile_hamming)
    if metric == DistanceType.BrayCurtis:
        return _blocked_reduce(x, y, _tile_braycurtis)
    if metric == DistanceType.JensenShannon:
        return _blocked_reduce(x, y, _tile_jensen_shannon)
    if metric == DistanceType.Haversine:
        return _haversine(x, y)
    raise LogicError(f"metric {metric.name} is not supported for dense inputs "
                     "(reference parity: JaccardExpanded/DiceExpanded are "
                     "sparse-only; Precomputed is a sentinel)")


# ---------------------------------------------------------------------------
# epilogue-level API: hoisted per-row statistics for tiled pipelines
# ---------------------------------------------------------------------------

#: metrics whose epilogue consumes hoistable per-row statistics
STATS_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                 DistanceType.CosineExpanded, DistanceType.CorrelationExpanded)


def metric_stats(x: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    """Per-row epilogue statistics of *x* for *metric*, (n, s): squared
    norms (s=1) for the L2 metrics, unsquared norms (s=1) for cosine,
    (Σx, Σx²) (s=2) for correlation, s=0 for every other metric.  Tiled
    callers (the brute-force scan) compute them once per query batch and
    once per index instead of once per tile."""
    metric = DistanceType(metric)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return _row_norms(x)[:, None]
    if metric == DistanceType.CosineExpanded:
        return _row_norms(x, squared=False)[:, None]
    if metric == DistanceType.CorrelationExpanded:
        xs, x2 = _corr_row_stats(x)
        return torch.stack([xs, x2], dim=1)
    return torch.zeros((x.shape[0], 0), dtype=accum_dtype(x.dtype),
                       device=x.device)


def distance_with_stats(x, y, metric: DistanceType, metric_arg: float = 2.0,
                        x_stats=None, y_stats=None,
                        engine: Optional[str] = None):
    """:func:`distance` taking :func:`metric_stats` outputs: the
    ``STATS_METRICS`` consume them instead of deriving them from the rows;
    every other metric (or None / width-0 stats) takes the full path."""
    metric = DistanceType(metric)

    def col(s, j):
        return None if s is None or s.shape[1] == 0 else s[:, j]

    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return _l2_expanded(x, y, sqrt=metric == DistanceType.L2SqrtExpanded,
                            xn=col(x_stats, 0), yn=col(y_stats, 0))
    if metric == DistanceType.CosineExpanded:
        return _cosine(x, y, xn=col(x_stats, 0), yn=col(y_stats, 0))
    if metric == DistanceType.CorrelationExpanded:
        xs = None if col(x_stats, 0) is None else (x_stats[:, 0],
                                                    x_stats[:, 1])
        ys = None if col(y_stats, 0) is None else (y_stats[:, 0],
                                                    y_stats[:, 1])
        return _correlation(x, y, x_stats=xs, y_stats=ys)
    return _dispatch(x, y, metric, float(metric_arg), engine)


def distance(x: torch.Tensor, y: torch.Tensor, metric: DistanceType,
             metric_arg: float = 2.0, engine: Optional[str] = None
             ) -> torch.Tensor:
    """Pairwise distances of two (·, k) tensors on one device (reference
    ``distance<DistanceType>``, distance/distance.cuh:62)."""
    _check_pair(x, y)
    return _dispatch(x, y, DistanceType(metric), float(metric_arg), engine)


def _check_pair(x: torch.Tensor, y: torch.Tensor) -> None:
    expects(x.ndim == 2 and y.ndim == 2, "x and y must be 2-d")
    expects(x.shape[1] == y.shape[1],
            "x and y must have the same number of columns")
    expects(x.dtype == y.dtype, f"x and y types differ: {x.dtype}, "
            f"{y.dtype}")


#: ``pairwise_distance``'s program, keyed per (shape, dtype, device,
#: metric, metric_arg, engine) signature (``raft_tpu/distance/
#: pairwise.py:439`` ``_distance_aot``; ``core/prewarm.py`` warms it)
_distance_aot = aot(_dispatch, static_argnums=(2, 3, 4))


def as_float_tensor(a, device: torch.device) -> torch.Tensor:
    """*a* (array or tensor) on *device*; float64 becomes float32, as the
    JAX package's arrays do with 64-bit types off."""
    t = torch.as_tensor(a, device=device)
    # exempt(dtype-drift): the check that turns a float64 input into float32
    return t.float() if t.dtype == torch.float64 else t


def as_input(a, device=None) -> torch.Tensor:
    """An entry point's input: a tensor stays where it is, anything else
    goes to *device* (``None``: the card) through :func:`as_float_tensor`."""
    if isinstance(a, torch.Tensor):
        return a
    return as_float_tensor(a, resolve_device(device))


@auto_sync_handle
def pairwise_distance(x, y, metric: Union[str, DistanceType] = "euclidean",
                      metric_arg: float = 2.0, p: Optional[float] = None,
                      handle=None, *, device=None,
                      engine: Optional[str] = None) -> torch.Tensor:
    """Runtime-dispatched pairwise distance (reference
    ``pairwise_distance``, distance/distance.cuh:293; pylibraft
    distance/pairwise_distance.pyx:95): (m, n) distances between the rows
    of *x* and *y*.  *metric* is a name of ``DISTANCE_TYPES`` or a
    :class:`DistanceType`; *p* (alias *metric_arg*) is the Minkowski
    exponent.  ``device=None`` runs on the card; ``engine`` picks kernel
    B5 (``"cuda"``) or the plain versions (``"torch"``).  *handle*: a
    :class:`~raft_tpu_torch.core.Handle` whose stream takes the work and
    whose device takes array inputs (``auto_sync_handle``)."""
    if isinstance(metric, str):
        m = DISTANCE_TYPES.get(metric.lower())
        if m is None:
            raise LogicError(f"metric {metric!r} is not supported")
        metric = m
    if p is not None:
        metric_arg = p
    dev = device_of(handle, device)
    xt, yt = as_float_tensor(x, dev), as_float_tensor(y, dev)
    _check_pair(xt, yt)
    return _distance_aot(xt, yt, DistanceType(metric), float(metric_arg),
                         engine)
