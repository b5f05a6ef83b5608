"""Traffic from a mix's data file and the run's seed.

A mix is ``traffic/<name>.json`` with a ``kind`` that one generator here
reads:

``batch``
    A closed loop: one caller sends ``queries_per_call`` query rows a
    call, back to back.  The rows are the query pool's, in pool
    order when the call takes the whole pool, else a seeded sample.
``open_poisson``
    An open loop: requests whose sizes follow the size ``plan`` arrive as
    a Poisson process offering ``rate_qps`` query rows a second.  The
    schedule — each request's size and the exponential gap before it,
    scaled so that the window offers ``rate_qps`` — is drawn once from
    ``sizes_seed``, so every run offers the same work with the same
    bursts; the run's seed starts the schedule at another request (a
    rotation: the same sizes and gaps in another order) and picks each
    request's rows from the pool.

The size plan is a frozen copy of the port's traffic-plan DSL
(``raft_tpu_torch/serve/traffic.py``: ``parse_traffic_plan`` and the size
draw of ``traffic_requests``): directives separated by ``;``, fields by
``:``.  Each request consumes one ``random()``, one ``integers()`` and
one payload draw of the seeded generator, so a seed replays the same
size stream as the port's generator does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

#: 85% interactive (1-16 queries), 10% medium (17-128), 5% bulk (129-700)
HEAVY_TAIL_PLAN = ("band:p=0.85:lo=1:hi=17;band:p=0.10:lo=17:hi=129;"
                   "band:p=0.05:lo=129:hi=701")


def parse_plan(spec: str) -> Tuple[List[Tuple[float, int, int]],
                                   List[Tuple[str, Dict[str, float]]]]:
    """Parse a plan string into (bands, modifiers); raises ``ValueError``
    on an unknown directive or a malformed field."""
    bands, mods = [], []
    for raw in str(spec).split(";"):
        raw = raw.strip()
        if not raw:
            continue
        fields = [f.strip() for f in raw.split(":")]
        kind, kv = fields[0], {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(f"traffic plan field {f!r} is not k=v "
                                 f"(directive {raw!r})")
            key, val = f.split("=", 1)
            kv[key.strip()] = float(val)
        if kind == "band":
            bands.append((kv.get("p", 1.0), int(kv["lo"]), int(kv["hi"])))
        elif kind in ("diurnal", "burst"):
            mods.append((kind, kv))
        else:
            raise ValueError(f"unknown traffic directive {kind!r} "
                             f"(want band/diurnal/burst)")
    if not bands:
        raise ValueError("traffic plan needs at least one band directive")
    return bands, mods


def plan_sizes(spec: str, seed: int, n_requests: int,
               dim: int) -> List[int]:
    """The sizes of *n_requests* requests of the seeded plan (the sizes
    the port's ``traffic_requests(spec, seed, n_requests, dim)`` gives)."""
    bands, mods = parse_plan(spec)
    rng = np.random.default_rng(seed)
    sizes = []
    for j in range(n_requests):
        u = rng.random()
        lo, hi = bands[-1][1], bands[-1][2]   # last band catches the tail
        cum = 0.0
        for p, b_lo, b_hi in bands:
            cum += p
            if u < cum:
                lo, hi = b_lo, b_hi
                break
        scale = 1.0
        for kind, kv in mods:
            if kind == "burst":
                at, ln = int(kv["at"]), int(kv["len"])
                if at <= j < at + ln:
                    lo, hi = int(kv["lo"]), int(kv["hi"])
            else:   # diurnal: index-deterministic size envelope
                floor = float(kv.get("floor", 0.25))
                period = max(1.0, float(kv.get("period", 64)))
                scale *= (floor + (1.0 - floor)
                          * 0.5 * (1.0 + math.sin(2 * math.pi * j / period)))
        s = int(rng.integers(lo, hi))
        s = max(1, int(round(s * scale)))
        rng.random((s, dim))   # the payload draw, kept for the stream
        sizes.append(s)
    return sizes


@dataclasses.dataclass
class BatchTraffic:
    """A closed loop: every call sends the pool rows ``rows``."""

    rows: np.ndarray


@dataclasses.dataclass
class OpenTraffic:
    """An open loop: request j arrives ``arrivals[j]`` seconds into the
    window with the pool rows ``rows[j]``."""

    arrivals: np.ndarray
    rows: List[np.ndarray]
    rate_qps: float

    @property
    def sizes(self) -> List[int]:
        return [len(r) for r in self.rows]


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), salt])


def make(mix: dict, seed: int, seconds: float, pool_size: int, dim: int):
    """The traffic of one run: a :class:`BatchTraffic` or an
    :class:`OpenTraffic` for a window of *seconds*."""
    kind = mix["kind"]
    if kind == "batch":
        n = int(mix["queries_per_call"])
        if n > pool_size:
            raise ValueError(f"queries_per_call {n} > pool {pool_size}")
        rows = (np.arange(n) if n == pool_size
                else np.sort(_rng(seed, 1).choice(pool_size, n,
                                                  replace=False)))
        return BatchTraffic(rows=rows)
    if kind == "open_poisson":
        rate = float(mix["rate_qps"])
        offered = rate * float(seconds)
        # draw the plan's sizes in rounds until they offer the window's rows
        sizes: List[int] = []
        n = max(16, int(offered / 30))
        while sum(sizes) < offered:
            sizes = plan_sizes(mix["plan"], int(mix["sizes_seed"]), n, dim)
            n *= 2
        total = np.cumsum(sizes)
        sizes = sizes[:int(np.searchsorted(total, offered)) + 1]
        n = len(sizes)
        gaps = np.random.default_rng([int(mix["sizes_seed"]), 1]) \
            .exponential(1.0, n)
        gaps *= (sum(sizes) / rate) / gaps.sum()
        start = int(_rng(seed, 2).integers(n))
        order = np.roll(np.arange(n), -start)
        arrivals = np.cumsum(gaps[order]) - gaps[order][0]
        pick = _rng(seed, 4)
        rows = [pick.integers(0, pool_size, sizes[j]) for j in order]
        return OpenTraffic(arrivals=arrivals, rows=rows, rate_qps=rate)
    raise ValueError(f"unknown traffic kind {kind!r}")
