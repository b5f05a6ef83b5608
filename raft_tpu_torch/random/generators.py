"""Synthetic data generators (port of ``raft_tpu/random/generators.py``;
reference raft/random/{make_blobs,make_regression,multi_variable_gaussian,
rmat_rectangular_generator}.cuh).

Each takes ``rng`` first (an :class:`~raft_tpu_torch.random.rng.RngState`
or a ``torch.Generator``) and draws from one CPU generator in a fixed
order, then moves the result to ``device`` (``None``: the card).  The
JAX package splits its key four or five ways instead, so the two agree in
distribution, not in value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device
from raft_tpu_torch.random.rng import generator_of

#: the type host-side draws are made in before they are rounded once to
#: the output type (the JAX package's generator order)
# exempt(dtype-drift): draws, centres and R-MAT parameters are made on the host in float64
_HOST_FLOAT = torch.float64


def make_blobs(rng, n_samples: int, n_features: int, n_clusters: int = 3,
               cluster_std: float = 1.0, centers=None,
               center_box: Tuple[float, float] = (-10.0, 10.0),
               shuffle: bool = True, dtype=torch.float32, device=None):
    """Isotropic Gaussian blobs (reference random/make_blobs.cuh:63):
    ``(x (n_samples, n_features), labels (n_samples,) int32, centers)``.
    Labels are balanced (``arange % n_clusters``, the reference's default
    proportions), shuffled; centres uniform in *center_box* unless given
    (a tensor of centres sets the device)."""
    g = generator_of(rng)
    if centers is None:
        lo, hi = center_box
        centers = lo + (hi - lo) * torch.rand((n_clusters, n_features),
                                              generator=g,
                                              dtype=_HOST_FLOAT)
    else:
        if isinstance(centers, torch.Tensor):
            device = centers.device
        centers = torch.as_tensor(centers).detach().cpu().to(_HOST_FLOAT)
        n_clusters = centers.shape[0]
    labels = torch.arange(n_samples) % n_clusters
    if shuffle:
        labels = labels[torch.randperm(n_samples, generator=g)]
    noise = torch.randn((n_samples, n_features), generator=g,
                        dtype=(_HOST_FLOAT if dtype == _HOST_FLOAT
                               else torch.float32))
    dev = resolve_device(device)
    centers = centers.to(device=dev, dtype=dtype)
    labels = labels.to(device=dev, dtype=torch.int32)
    x = centers[labels] + cluster_std * noise.to(device=dev, dtype=dtype)
    return x, labels, centers


def make_regression(rng, n_samples: int, n_features: int,
                    n_informative: Optional[int] = None, n_targets: int = 1,
                    bias: float = 0.0, noise: float = 0.0,
                    effective_rank: Optional[int] = None,
                    tail_strength: float = 0.5, shuffle: bool = True,
                    coef: bool = False, dtype=torch.float32, device=None):
    """Linear-model regression problem (reference
    random/make_regression.cuh): ``(x, y[, w])`` with y = x·w + bias +
    N(0, noise²); with *effective_rank* x gets the low-rank-plus-tail
    singular profile."""
    if n_informative is None:
        n_informative = n_features
    n_informative = min(n_informative, n_features)
    g = generator_of(rng)
    dev = resolve_device(device)
    x = torch.randn((n_samples, n_features), generator=g,
                    dtype=_HOST_FLOAT)
    w_inf = 100.0 * torch.rand((n_informative, n_targets), generator=g,
                               dtype=_HOST_FLOAT)
    eps = torch.randn((n_samples, n_targets), generator=g,
                      dtype=_HOST_FLOAT)
    perm = torch.randperm(n_samples, generator=g)
    x = x.to(device=dev, dtype=dtype)
    if effective_rank is not None:
        n = min(n_samples, n_features)
        sing = torch.arange(n, dtype=dtype, device=dev)
        low = torch.exp(-(sing / effective_rank) ** 2)
        tail = torch.exp(-0.1 * sing / effective_rank)
        s = (1 - tail_strength) * low + tail_strength * tail
        u, _, vt = torch.linalg.svd(x, full_matrices=False)
        x = (u * s[None, :]) @ vt
    w = torch.zeros((n_features, n_targets), dtype=dtype, device=dev)
    w[:n_informative] = w_inf.to(device=dev, dtype=dtype)
    y = x @ w + bias
    if noise > 0:
        y = y + noise * eps.to(device=dev, dtype=dtype)
    if shuffle:
        perm = perm.to(dev)
        x, y = x[perm], y[perm]
    if n_targets == 1:
        y, w = y[:, 0], w[:, 0]
    return (x, y, w) if coef else (x, y)


def multi_variable_gaussian(rng, mean, cov, n_samples: int = 1,
                            method: str = "cholesky", device=None):
    """Samples of N(mean, cov) (reference
    random/multi_variable_gaussian.cuh): (n_samples, dim).  ``"cholesky"``
    factors cov; any other method its eigendecomposition (the reference's
    "jacobi").  A tensor *mean* sets the device."""
    if isinstance(mean, torch.Tensor):
        device = mean.device
    dev = resolve_device(device)
    mean = torch.as_tensor(mean, device=dev)
    cov = torch.as_tensor(cov, device=dev)
    dim = mean.shape[0]
    expects(tuple(cov.shape) == (dim, dim), "cov must be [dim, dim]")
    z = torch.randn((n_samples, dim), generator=generator_of(rng),
                    dtype=_HOST_FLOAT).to(device=dev, dtype=cov.dtype)
    if method == "cholesky":
        samples = z @ torch.linalg.cholesky(cov).T
    else:
        w, v = torch.linalg.eigh(cov)
        samples = z @ (v * torch.sqrt(torch.clamp_min(w, 0))[None, :]).T
    return mean[None, :] + samples


def rmat_rectangular_gen(rng, theta, r_scale: int, c_scale: int,
                         n_edges: int, clip_and_flip: bool = False,
                         handle=None, device=None):
    """R-MAT graph generator (reference
    random/rmat_rectangular_generator.cuh:75).  *theta* is the quadrant
    distribution (a, b, c, d) per level, [max(r_scale, c_scale), 4], or
    [4] for every level.  Returns ``(out (n_edges, 2), src, dst)`` int64,
    src in [0, 2^r_scale), dst in [0, 2^c_scale).  All (edge, level)
    quadrant choices come from one draw of uniforms, each compared with
    its level's cumulative distribution."""
    if handle is not None:
        device = handle.device
    dev = resolve_device(device)
    theta = torch.as_tensor(theta, dtype=_HOST_FLOAT).cpu()
    max_scale = max(r_scale, c_scale)
    if theta.ndim == 1:
        theta = theta[None, :].expand(max_scale, 4)
    expects(theta.shape[0] >= max_scale,
            "theta must cover max(r_scale, c_scale) levels")
    p = torch.clamp_min(theta[:max_scale], 0)
    cdf = torch.cumsum(p / p.sum(1, keepdim=True), 1)        # (L, 4)
    u = torch.rand((n_edges, max_scale), generator=generator_of(rng),
                   dtype=_HOST_FLOAT)
    quad = (u[..., None] >= cdf[None, :, :3]).sum(-1)       # 0..3
    row_bits = (quad >> 1) & 1
    col_bits = quad & 1
    lvl = torch.arange(max_scale)
    r_w = torch.where(lvl < r_scale,
                      1 << torch.clamp_min(r_scale - 1 - lvl, 0), 0)
    c_w = torch.where(lvl < c_scale,
                      1 << torch.clamp_min(c_scale - 1 - lvl, 0), 0)
    src = (row_bits * r_w[None, :]).sum(1).to(torch.int64)
    dst = (col_bits * c_w[None, :]).sum(1).to(torch.int64)
    if clip_and_flip:
        src, dst = torch.maximum(src, dst), torch.minimum(src, dst)
    src, dst = src.to(dev), dst.to(dev)
    return torch.stack([src, dst], dim=1), src, dst
