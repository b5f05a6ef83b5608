"""The traffic-plan DSL (port of ``bench/common.py:360-470``:
``parse_traffic_plan``, ``traffic_requests`` and the named plans), the
autotuner's synthetic shadow traffic (``AutoTuner(shadow_plan="band:…")``).

A plan is directives separated by ``;``, fields by ``:``, the first field
naming the directive::

    band:p=0.85:lo=1:hi=17        # size band: with prob p, size ~ U[lo,hi)
    diurnal:period=64:floor=0.25  # day curve: scale sizes by a sinusoid
    burst:at=100:len=16:lo=129:hi=701   # requests at..at+len-1 go bulk

Bands are matched in directive order by cumulative probability (the last
band catches the remainder).  Every request consumes exactly one
``random()``, one ``integers()`` and one payload draw from the seeded
numpy generator whatever the modifiers, so the same seed replays the same
stream as the JAX package's bench does.  ``diurnal`` is index-
deterministic: request j's size scales by floor + (1-floor)·(1+sin(2πj/
period))/2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

#: 85% interactive (1-16 queries), 10% medium (17-128), 5% bulk (129-700)
HEAVY_TAIL_PLAN = ("band:p=0.85:lo=1:hi=17;band:p=0.10:lo=17:hi=129;"
                   "band:p=0.05:lo=129:hi=701")

#: the heavy-tail mix under a sinusoidal load envelope (trough at 25% of
#: the drawn size)
DIURNAL_PLAN = HEAVY_TAIL_PLAN + ";diurnal:period=64:floor=0.25"

#: heavy-tail steady state with one 16-request bulk squall at request 100
BURST_PLAN = HEAVY_TAIL_PLAN + ";burst:at=100:len=16:lo=129:hi=701"


def parse_traffic_plan(spec: str
                       ) -> Tuple[List[Tuple[float, int, int]],
                                  List[Tuple[str, Dict[str, float]]]]:
    """Parse a plan string → (bands, modifiers); raises ``ValueError`` on
    an unknown directive or a malformed field."""
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


def traffic_requests(spec: str, seed: int, n_requests: int, dim: int,
                     dtype="float32") -> List[np.ndarray]:
    """*n_requests* query batches from the seeded plan: a list of
    (size_j, dim) arrays of *dtype*, values ~ U[0,1)."""
    bands, mods = parse_traffic_plan(spec)
    rng = np.random.default_rng(seed)
    reqs = []
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
        reqs.append(rng.random((s, dim)).astype(dtype))
    return reqs
