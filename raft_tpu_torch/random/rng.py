"""Random state and the distribution surface over ``torch.Generator`` (port
of ``raft_tpu/random/rng.py``; reference raft/random/rng.cuh and
rng_state.hpp:28-52).

Every draw takes ``rng`` first, as in the JAX package: an :class:`RngState`,
which hands out a fresh generator per call and advances its subsequence, or
a ``torch.Generator``, which is drawn from as it stands.  Generators are
made on the CPU, so a seed gives the same numbers whatever device the data
lives on; the numbers are then moved to the data's device (``device=None``:
the card).  The streams differ from ``jax.random``'s, so the JAX package
and the port agree on draws only in distribution.

Draws that depend on weights already on the device (:func:`discrete`,
weighted :func:`sample_without_replacement`) take only uniforms from the
CPU and finish on the weights' device, so the weights never come to the
host.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.handle import resolve_device

#: the type host-side draws are made in before they are rounded once to
#: the output type (the JAX package's generator order)
# exempt(dtype-drift): draws, moments and CDFs are made on the host in float64
_HOST_FLOAT = torch.float64


class GeneratorType(enum.Enum):
    """reference random/rng_state.hpp:28 — GenPhilox / GenPC.  Both map to
    PyTorch's CPU generator (a Mersenne Twister); the type is kept for the
    reference's signature."""

    GenPhilox = "philox"
    GenPC = "pc"


class RngState:
    """Mutable random state (reference rng_state.hpp:37-52): a seed plus a
    subsequence counter that every :meth:`next_generator` advances."""

    def __init__(self, seed: int = 0, base_subsequence: int = 0,
                 type: GeneratorType = GeneratorType.GenPhilox):
        self.seed = int(seed)
        self.base_subsequence = int(base_subsequence)
        self.type = type

    def advance(self, subsequences: int = 1) -> None:
        self.base_subsequence += int(subsequences)

    def generator(self) -> torch.Generator:
        g = torch.Generator(device="cpu")
        g.manual_seed((self.seed * 0x9E3779B1 + self.base_subsequence)
                      % (1 << 63))
        return g

    def next_generator(self) -> torch.Generator:
        g = self.generator()
        self.advance()
        return g


Rng = Union[RngState, torch.Generator]


def generator_of(rng: Rng) -> torch.Generator:
    """The generator a draw uses: a fresh one from an :class:`RngState`
    (which advances), or *rng* itself (the JAX package's ``_key_of``)."""
    if isinstance(rng, RngState):
        return rng.next_generator()
    expects(isinstance(rng, torch.Generator),
            f"rng must be an RngState or a torch.Generator, got {type(rng)}")
    return rng


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform01(rng: Rng, shape, open_low: bool = False) -> torch.Tensor:
    """float64 uniforms in [0, 1) on the CPU ((0, 1) with *open_low*)."""
    u = torch.rand(_shape(shape), generator=generator_of(rng),
                   dtype=_HOST_FLOAT)
    return u.clamp_min(1e-300) if open_low else u


def _out(t: torch.Tensor, dtype, device) -> torch.Tensor:
    return t.to(device=resolve_device(device), dtype=dtype)


# -- distributions (reference random/rng.cuh) --------------------------------

def uniform(rng: Rng, shape, low=0.0, high=1.0, dtype=torch.float32,
            device=None) -> torch.Tensor:
    u = _uniform01(rng, shape)
    return _out(low + (high - low) * u, dtype, device)


def uniform_int(rng: Rng, shape, low, high, dtype=torch.int32,
                device=None) -> torch.Tensor:
    t = torch.randint(int(low), int(high), _shape(shape),
                      generator=generator_of(rng), dtype=torch.int64)
    return _out(t, dtype, device)


def _std_normal(rng: Rng, shape) -> torch.Tensor:
    return torch.randn(_shape(shape), generator=generator_of(rng),
                       dtype=_HOST_FLOAT)


def normal(rng: Rng, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
           device=None) -> torch.Tensor:
    return _out(mu + sigma * _std_normal(rng, shape), dtype, device)


def normal_int(rng: Rng, shape, mu, sigma, dtype=torch.int32,
               device=None) -> torch.Tensor:
    return _out(torch.round(mu + sigma * _std_normal(rng, shape)), dtype,
                device)


def normal_table(rng: Rng, n_rows: int, mu_vec, sigma_vec=None,
                 sigma=1.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-column mean and standard deviation (reference ``normalTable``):
    (n_rows, len(mu_vec)).  A tensor *mu_vec* sets the device."""
    if isinstance(mu_vec, torch.Tensor):
        device = mu_vec.device
    mu = torch.as_tensor(mu_vec, dtype=_HOST_FLOAT).cpu()
    z = _std_normal(rng, (int(n_rows), mu.shape[0]))
    sig = (torch.as_tensor(sigma_vec, dtype=_HOST_FLOAT).cpu()[None, :]
           if sigma_vec is not None else sigma)
    return _out(mu[None, :] + z * sig, dtype, device)


def lognormal(rng: Rng, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    return _out(torch.exp(mu + sigma * _std_normal(rng, shape)), dtype,
                device)


def gumbel(rng: Rng, shape, mu=0.0, beta=1.0, dtype=torch.float32,
           device=None) -> torch.Tensor:
    u = _uniform01(rng, shape, open_low=True)
    return _out(mu - beta * torch.log(-torch.log(u)), dtype, device)


def logistic(rng: Rng, shape, mu=0.0, scale=1.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    u = _uniform01(rng, shape, open_low=True)
    return _out(mu + scale * torch.log(u / (1.0 - u)), dtype, device)


def exponential(rng: Rng, shape, lambda_=1.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    u = _uniform01(rng, shape)
    return _out(-torch.log1p(-u) / lambda_, dtype, device)


def rayleigh(rng: Rng, shape, sigma=1.0, dtype=torch.float32,
             device=None) -> torch.Tensor:
    u = _uniform01(rng, shape).clamp_min(1e-12)
    return _out(sigma * torch.sqrt(-2.0 * torch.log(u)), dtype, device)


def laplace(rng: Rng, shape, mu=0.0, scale=1.0, dtype=torch.float32,
            device=None) -> torch.Tensor:
    v = _uniform01(rng, shape) - 0.5
    return _out(mu - scale * torch.sign(v) * torch.log1p(-2.0 * v.abs()),
                dtype, device)


def bernoulli(rng: Rng, shape, prob=0.5, device=None) -> torch.Tensor:
    """bool, True with probability *prob*."""
    return _out(_uniform01(rng, shape) < prob, torch.bool, device)


def scaled_bernoulli(rng: Rng, shape, prob=0.5, scale=1.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """±scale with P(−scale) = prob (reference ``scaled_bernoulli``)."""
    b = _uniform01(rng, shape) < prob
    return _out(torch.where(b, -scale, scale), dtype, device)


def fill(rng: Rng, shape, value, dtype=torch.float32,
         device=None) -> torch.Tensor:
    """reference ``fill`` (lives in rng.cuh for historical reasons)."""
    return torch.full(_shape(shape), value, dtype=dtype,
                      device=resolve_device(device))


def inverse_cdf(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn ∝ *weights* (≥ 0, 1-d) for uniforms *u* in [0, 1), on
    the weights' device with no read to the host: the first slot whose
    cumulative weight exceeds u · total (float64 sums).  A slot of zero
    weight is never drawn while any weight is positive."""
    cdf = torch.cumsum(weights.to(_HOST_FLOAT), 0)
    total = cdf[-1:]
    idx = torch.searchsorted(cdf, u.to(cdf.device, _HOST_FLOAT) * total,
                             right=True)
    # u · total may round up to total: the last slot of positive weight
    return torch.minimum(idx, torch.searchsorted(cdf, total))


def discrete(rng: Rng, shape, weights, dtype=torch.int32,
             device=None) -> torch.Tensor:
    """Indices drawn ∝ *weights* (reference ``discrete``); a tensor of
    weights sets the device."""
    if not isinstance(weights, torch.Tensor):
        weights = torch.as_tensor(weights, device=resolve_device(device))
    u = _uniform01(rng, shape)
    idx = inverse_cdf(torch.clamp_min(weights, 0), u.reshape(-1))
    return idx.reshape(u.shape).to(dtype)


def sample_without_replacement(rng: Rng, items: torch.Tensor, n_samples: int,
                               weights: Optional[torch.Tensor] = None,
                               return_indices: bool = False):
    """Weighted sampling without replacement by the Gumbel-top-k trick
    (reference ``sampleWithoutReplacement``; one sort, no rejection loop):
    the rows of *items* with the *n_samples* largest ``gumbel +
    log(weight)`` keys.  The Gumbel noise comes from the CPU; with
    *weights* the keys are formed and sorted on the weights' device, so
    weights on the card never come to the host."""
    n = items.shape[0]
    expects(0 < n_samples <= n, "sampledLen must be in (0, len]")
    u = torch.rand(n, generator=generator_of(rng), dtype=_HOST_FLOAT)
    idx = gumbel_top_k(u, n_samples, weights).to(items.device)
    out = items[idx]
    return (out, idx) if return_indices else out


def gumbel_top_k(u: torch.Tensor, n_samples: int,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The positions of the *n_samples* largest keys ``gumbel(u) +
    log(weight)`` for float64 uniforms *u* (one per item), ties to the
    lower position: a draw without replacement ∝ *weights*.  The keys are
    formed where the weights lie (else where *u* lies)."""
    g = -torch.log(-torch.log(u.clamp(1e-300, 1.0 - 1e-16)))
    if weights is not None:
        g = g.to(weights.device) + torch.log(
            torch.clamp_min(weights.to(_HOST_FLOAT), 1e-37))
    _, idx = torch.sort(g, descending=True, stable=True)
    return idx[:n_samples]


def permute(rng: Rng, in_array: Optional[torch.Tensor] = None,
            n: Optional[int] = None, return_perm: bool = True, device=None):
    """Random permutation of rows (reference random/permute.cuh): the
    permutation alone without *in_array*, else ``(rows, perm)`` (or the
    rows alone when not *return_perm*)."""
    if in_array is not None:
        n = in_array.shape[0]
        device = in_array.device
    expects(n is not None, "permute needs in_array or n")
    perm = torch.randperm(int(n), generator=generator_of(rng)).to(
        resolve_device(device))
    if in_array is None:
        return perm
    out = in_array[perm]
    return (out, perm) if return_perm else out
