"""Sieve of Eratosthenes (port of ``raft_tpu/util/seive.py``; reference
util/seive.hpp, whose spelling is kept)."""

from __future__ import annotations

import numpy as np


class Seive:
    def __init__(self, n: int):
        self.n = n
        sieve = np.ones(n + 1, dtype=bool)
        sieve[:2] = False
        for p in range(2, int(n**0.5) + 1):
            if sieve[p]:
                sieve[p * p :: p] = False
        self._sieve = sieve

    def is_prime(self, k: int) -> bool:
        return bool(self._sieve[k])

    def primes(self) -> np.ndarray:
        return np.nonzero(self._sieve)[0]
