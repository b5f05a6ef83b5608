"""Summary statistics (port of ``raft_tpu/stats/summary.py``; reference
raft/stats/{mean,mean_center,meanvar,stddev,sum,cov,minmax,weighted_mean,
histogram}.cuh).  RAFT's convention: statistics are per column (the
reduction runs down the rows of the n_samples × n_features matrix);
``sample=True`` divides by n − 1.  Tensors stay where they are."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mean(data: torch.Tensor, sample: bool = False) -> torch.Tensor:
    """Column means (reference stats/mean.cuh); *sample* divides by n − 1,
    as the reference's flag does."""
    n = data.shape[0]
    return torch.sum(data, 0) / ((n - 1) if sample else n)


def mean_center(data: torch.Tensor, mu=None) -> torch.Tensor:
    """Subtract the column means (reference ``meanCenter``)."""
    if mu is None:
        mu = mean(data)
    return data - mu[None, :]


def mean_add(data: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mean_center` (reference ``meanAdd``)."""
    return data + mu[None, :]


def _centered_sq(data, mu, sample: bool):
    if mu is None:
        mu = torch.mean(data, 0)
    n = data.shape[0]
    c = data - mu[None, :]
    return torch.sum(c * c, 0) / ((n - 1) if sample else n)


def meanvar(data: torch.Tensor, sample: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column means and variances (reference stats/meanvar.cuh)."""
    mu = torch.mean(data, 0)
    return mu, _centered_sq(data, mu, sample)


def stddev(data: torch.Tensor, mu=None, sample: bool = True) -> torch.Tensor:
    """Column standard deviations (reference stats/stddev.cuh)."""
    return torch.sqrt(_centered_sq(data, mu, sample))


def vars_(data: torch.Tensor, mu=None, sample: bool = True) -> torch.Tensor:
    """Column variances (reference ``vars``)."""
    s = stddev(data, mu, sample)
    return s * s


def sum_(data: torch.Tensor) -> torch.Tensor:
    """Column sums (reference stats/sum.cuh)."""
    return torch.sum(data, 0)


def cov(data: torch.Tensor, mu=None, sample: bool = True,
        stable: bool = True) -> torch.Tensor:
    """Covariance of the columns (reference stats/cov.cuh): one product of
    the centred data with itself.  *stable* is the reference's flag; the
    centred product is the stable form either way."""
    if mu is None:
        mu = torch.mean(data, 0)
    c = data - mu[None, :]
    n = data.shape[0]
    return (c.T @ c) / ((n - 1) if sample else n)


def minmax(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max) (reference stats/minmax.cuh)."""
    return torch.amin(data, 0), torch.amax(data, 0)


def row_weighted_mean(data: torch.Tensor, weights) -> torch.Tensor:
    """Weighted mean of each row, weights along the columns (reference
    ``rowWeightedMean``)."""
    w = torch.as_tensor(weights, device=data.device, dtype=data.dtype)
    return torch.sum(data * w[None, :], 1) / torch.sum(w)


def col_weighted_mean(data: torch.Tensor, weights) -> torch.Tensor:
    """Weighted mean of each column (reference ``colWeightedMean``)."""
    w = torch.as_tensor(weights, device=data.device, dtype=data.dtype)
    return torch.sum(data * w[:, None], 0) / torch.sum(w)


def weighted_mean(data: torch.Tensor, weights,
                  along_rows: bool = True) -> torch.Tensor:
    """reference ``weightedMean`` dispatcher."""
    return (row_weighted_mean(data, weights) if along_rows
            else col_weighted_mean(data, weights))


def histogram(data: torch.Tensor, n_bins: int, lower: Optional[float] = None,
              upper: Optional[float] = None) -> torch.Tensor:
    """Per-column histogram, int32 (n_bins, n_features) (reference
    stats/histogram.cuh): n_bins uniform bins over [lower, upper) (default
    the data's range), values outside clamped into the edge bins."""
    if data.ndim == 1:
        data = data[:, None]
    lo = torch.amin(data) if lower is None else lower
    hi = torch.amax(data) if upper is None else upper
    width = (hi - lo) / n_bins
    idx = torch.clamp(((data - lo) / width).to(torch.int32), 0,
                      n_bins - 1).long()
    out = torch.zeros((n_bins, data.shape[1]), dtype=torch.int32,
                      device=data.device)
    # exempt(raw-segment-sum): histogram counts
    return out.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
