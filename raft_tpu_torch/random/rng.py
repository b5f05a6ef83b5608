"""Random state over ``torch.Generator`` (port of ``raft_tpu/random/rng.py``
``RngState`` and ``sample_without_replacement``).

Every draw takes an explicit generator.  Generators are made on the CPU,
so a seed gives the same numbers whatever device the data lives on; the
streams differ from ``jax.random``'s, so the JAX package and the port agree
on such draws only in distribution.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects


class RngState:
    """Mutable random state (reference rng_state.hpp:37-52): a seed plus a
    subsequence counter that every :meth:`next_generator` advances."""

    def __init__(self, seed: int = 0, base_subsequence: int = 0):
        self.seed = int(seed)
        self.base_subsequence = int(base_subsequence)

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


def sample_without_replacement(gen: torch.Generator, items: torch.Tensor,
                               n_samples: int,
                               weights: Optional[torch.Tensor] = None,
                               return_indices: bool = False):
    """Weighted sampling without replacement by the Gumbel-top-k trick
    (one sort, no rejection loop): the rows of *items* with the
    *n_samples* largest ``gumbel + log(weight)`` keys."""
    n = items.shape[0]
    expects(0 < n_samples <= n, "sampledLen must be in (0, len]")
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    g = -torch.log(-torch.log(u.clamp(1e-300, 1.0 - 1e-16)))
    if weights is not None:
        g = g + torch.log(torch.clamp_min(weights.double().cpu(), 1e-37))
    _, idx = torch.sort(g, descending=True, stable=True)
    idx = idx[:n_samples].to(items.device)
    out = items[idx]
    return (out, idx) if return_indices else out
