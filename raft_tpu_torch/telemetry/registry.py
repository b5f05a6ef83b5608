"""The metrics registry (port of ``raft_tpu/telemetry/registry.py``):
labeled counters, gauges and fixed-memory log-bucketed histograms behind
ONE process-wide lock.

* **One lock.**  Every mutation takes :data:`_LOCK`; bulk reads copy
  under it, so snapshot and export stay consistent.
* **Fixed-memory histograms.**  :class:`Histogram` buckets observations
  into ``HIST_BUCKETS`` (64) log-spaced bins spanning 1 µs – 100 s (values
  outside clamp into the edge bins).  Quantiles interpolate within the hit
  bucket and are clamped to the observed min/max, so an estimate lies
  within one bucket ratio (~×1.33) of the exact sample quantile.
* **Bounded reservoirs.**  :class:`Reservoir` keeps a uniform sample of at
  most ``cap`` observations (Vitter's algorithm R, deterministic LCG).
* **Disable gate.**  ``RAFT_TPU_TELEMETRY=0`` (the reference's variable,
  so one setting governs both packages) turns histogram, gauge and
  reservoir recording and span tracing into no-ops.  COUNTERS STAY LIVE:
  the serving engine's ``stats`` are counters, and a counter bump is a few
  arithmetic operations.

Bucket geometry, the quantile rule, the reservoir's replacement stream
and the exporters' text are the reference's exactly, so the same
observation stream gives the same numbers in both packages.
"""

from __future__ import annotations

import math
import os
import threading
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# the global enable gate

_ENABLED = os.environ.get("RAFT_TPU_TELEMETRY", "1") != "0"


def enabled() -> bool:
    """True unless telemetry is globally disabled (``RAFT_TPU_TELEMETRY=0``
    at import, or :func:`set_enabled`).  Gates spans, histogram/gauge/
    reservoir recording and the JSONL sink; counters stay live (see module
    docstring)."""
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Flip the global gate at runtime (the bench's telemetry-off A/B side
    and the disabled-mode identity tests use this).  Returns the previous
    value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


#: THE registry lock — one per process, shared by every metric, so
#: concurrent ``ServeEngine`` callers never lose an increment.
_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# histograms: fixed-memory log-bucketed latency distributions

#: bucket geometry: HIST_BUCKETS log-spaced bins spanning [HIST_MIN, HIST_MAX]
#: seconds; values outside clamp into the edge bins.
HIST_MIN = 1e-6
HIST_MAX = 100.0
HIST_BUCKETS = 64
_LOG_MIN = math.log(HIST_MIN)
_LOG_STEP = (math.log(HIST_MAX) - _LOG_MIN) / HIST_BUCKETS


def bucket_index(value: float) -> int:
    """The bucket a (seconds) observation lands in — pure arithmetic, no
    allocation (the hot-path cost of one histogram observation is this plus
    three adds under the lock)."""
    if value <= HIST_MIN:
        return 0
    if value >= HIST_MAX:
        return HIST_BUCKETS - 1
    return int((math.log(value) - _LOG_MIN) / _LOG_STEP)


def bucket_upper(i: int) -> float:
    """Upper edge (seconds) of bucket *i*."""
    return math.exp(_LOG_MIN + (i + 1) * _LOG_STEP)


def quantile_from_counts(counts: Sequence[int], total: int, lo: float,
                         hi: float, q: float) -> Optional[float]:
    """THE bucket-quantile rule — interpolate within the hit bucket, clamp
    to the observed [lo, hi] — over a raw bucket-count vector.  The ONE
    implementation behind both :meth:`Histogram.quantile` and the fleet
    merge's re-estimated p50/p99 (the reference's ``telemetry/aggregate.py``), so
    a rollup's quantiles can never silently diverge from per-host ones.
    None when *total* is zero."""
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    for i, n in enumerate(counts):
        if n == 0:
            continue
        if acc + n >= target:
            # linear interpolation within the (log-spaced) bucket
            lower = HIST_MIN if i == 0 else bucket_upper(i - 1)
            frac = (target - acc) / n
            est = lower + frac * (bucket_upper(i) - lower)
            return min(max(est, lo), hi)
        acc += n
    return hi


class Reservoir:
    """Bounded uniform sample (Vitter's algorithm R) — the exact-sample
    companion of a histogram: at most *cap* floats no matter how many
    observations arrive.  Deterministic LCG replacement stream, so tests
    are reproducible without the global ``random`` state."""

    __slots__ = ("cap", "samples", "seen", "_lcg")

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self.samples: List[float] = []
        self.seen = 0
        self._lcg = 0x9E3779B9

    def add(self, value: float) -> None:
        # caller holds _LOCK (metric-internal) or owns the instance
        self.seen += 1
        if len(self.samples) < self.cap:
            self.samples.append(value)
            return
        # LCG step (numerical recipes constants); uniform slot in [0, seen)
        self._lcg = (self._lcg * 1664525 + 1013904223) & 0xFFFFFFFF
        slot = self._lcg % self.seen
        if slot < self.cap:
            self.samples[slot] = value


class _HistState:
    """Per-label-tuple histogram cell: 64 bucket counts + count/sum/min/max."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Metric:
    """Base: a named metric with a fixed label-name tuple.  Values are
    keyed by label-VALUE tuples (strings), matching prometheus's model."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Tuple[str, ...]) -> Tuple[str, ...]:
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name}: got {len(labels)} label values for "
                f"labelnames {self.labelnames}")
        return tuple(str(v) for v in labels)


class Counter(Metric):
    """Monotonic labeled counter.  ``inc`` is atomic under the registry
    lock — the thread-safe replacement for ``Counter[k] += 1``."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, labels: Tuple[str, ...] = ()) -> None:
        key = self._key(labels)
        with _LOCK:
            self._values[key] = self._values.get(key, 0) + amount

    def set(self, value: float, labels: Tuple[str, ...] = ()) -> None:
        """Absolute set — exists for the legacy Counter views' item
        assignment compat (``view[k] = 0`` snapshots); not part of the
        prometheus counter contract."""
        with _LOCK:
            self._values[self._key(labels)] = value

    def get(self, labels: Tuple[str, ...] = ()) -> float:
        with _LOCK:
            return self._values.get(self._key(labels), 0)

    def remove(self, labels: Tuple[str, ...]) -> None:
        """Drop the series of *labels* (a retired engine's, say)."""
        with _LOCK:
            self._values.pop(self._key(labels), None)

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        with _LOCK:
            return list(self._values.items())


class Gauge(Metric):
    """Labeled point-in-time value.  Recording is gated by
    :func:`enabled` (a gauge is telemetry, not contract bookkeeping)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, labels: Tuple[str, ...] = ()) -> None:
        if not _ENABLED:
            return
        with _LOCK:
            self._values[self._key(labels)] = value

    def get(self, labels: Tuple[str, ...] = ()) -> float:
        with _LOCK:
            return self._values.get(self._key(labels), 0)

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        with _LOCK:
            return list(self._values.items())


class Histogram(Metric):
    """Labeled log-bucketed histogram (fixed memory per label set; see
    module docstring for the bucket geometry).  ``observe`` is gated by
    :func:`enabled`."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 reservoir: int = 0):
        super().__init__(name, help, labelnames)
        self._cells: Dict[Tuple[str, ...], _HistState] = {}
        self._reservoir_cap = int(reservoir)
        self._reservoirs: Dict[Tuple[str, ...], Reservoir] = {}

    def observe(self, value: float, labels: Tuple[str, ...] = ()) -> None:
        if not _ENABLED:
            return
        value = float(value)
        i = bucket_index(value)
        key = self._key(labels)
        with _LOCK:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistState()
            cell.counts[i] += 1
            cell.count += 1
            cell.sum += value
            if value < cell.min:
                cell.min = value
            if value > cell.max:
                cell.max = value
            if self._reservoir_cap:
                r = self._reservoirs.get(key)
                if r is None:
                    r = self._reservoirs[key] = Reservoir(self._reservoir_cap)
                r.add(value)

    def cell(self, labels: Tuple[str, ...] = ()) -> Optional[_HistState]:
        with _LOCK:
            return self._cells.get(self._key(labels))

    def reservoir(self, labels: Tuple[str, ...] = ()) -> List[float]:
        with _LOCK:
            r = self._reservoirs.get(self._key(labels))
            return list(r.samples) if r is not None else []

    def count(self, labels: Tuple[str, ...] = ()) -> int:
        c = self.cell(labels)
        return c.count if c is not None else 0

    def quantile(self, q: float, labels: Tuple[str, ...] = ()
                 ) -> Optional[float]:
        """Bucket-interpolated quantile estimate, clamped to the observed
        [min, max] — within one bucket ratio (~×1.33) of the exact sample
        quantile.  None when the cell is empty."""
        with _LOCK:
            cell = self._cells.get(self._key(labels))
            if cell is None or cell.count == 0:
                return None
            counts = list(cell.counts)
            total, lo, hi = cell.count, cell.min, cell.max
        return quantile_from_counts(counts, total, lo, hi, q)

    def items(self) -> List[Tuple[Tuple[str, ...], _HistState]]:
        with _LOCK:
            return list(self._cells.items())


def merged_quantile(hist: "Histogram", q: float,
                    prefix: Tuple[str, ...]) -> Optional[float]:
    """Quantile estimate over the UNION of every cell whose label tuple
    starts with *prefix* — folded bucket-wise on the shared fixed log
    geometry, then interpolated by the ONE :func:`quantile_from_counts`
    rule.

    This is how a per-(fn, sig) histogram (e.g.
    ``raft_tpu_aot_dispatch_seconds``) answers a per-fn question: merge
    all of *fn*'s signature rows rather than privileging one.  Both the
    serve admission cost model and the continuous-batching scheduler
    seed their estimates through here.  None when nothing matched."""
    counts: Optional[List[int]] = None
    total, lo, hi = 0, float("inf"), float("-inf")
    for labels, cell in hist.items():
        if labels[:len(prefix)] != tuple(prefix) or cell.count == 0:
            continue
        if counts is None:
            counts = [0] * len(cell.counts)
        for i, n in enumerate(cell.counts):
            counts[i] += n
        total += cell.count
        lo, hi = min(lo, cell.min), max(hi, cell.max)
    if counts is None or not total:
        return None
    return quantile_from_counts(counts, total, lo, hi, q)


# ---------------------------------------------------------------------------
# the registry


class Registry:
    """Name → metric.  ``counter``/``gauge``/``histogram`` are get-or-create
    (idempotent re-registration with the same kind/labelnames returns the
    existing metric, so module reloads don't crash); a kind or labelname
    mismatch raises."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Any:
        with _LOCK:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}")
                return m
            m = cls(name, help, tuple(labelnames), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  reservoir: int = 0) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   reservoir=reservoir)

    def metrics(self) -> List[Metric]:
        with _LOCK:
            return [m for _, m in sorted(self._metrics.items())]

    def get(self, name: str) -> Optional[Metric]:
        with _LOCK:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every metric — for a registry a test made itself.  A
        ``LegacyCounterView`` keeps the metric it was made over, so after
        a reset of a live registry it counts into one no exporter sees."""
        with _LOCK:
            self._metrics.clear()


#: the process-wide default registry (the exporters and the module-level
#: convenience constructors in :mod:`raft_tpu_torch.telemetry` all use it)
REGISTRY = Registry()


# ---------------------------------------------------------------------------
# legacy Counter-shaped views


class LegacyCounterView(Mapping):
    """``collections.Counter``-shaped READ surface over one labeled
    registry counter — how ``ServeEngine.stats`` keeps the plain dict's
    read API while the registry is the store.

    The view fixes every label except the last (``key``): each engine
    holds a view with ``fixed=("3",)`` over
    ``raft_tpu_serve_engine_stats{engine,key}``, so ``engine.stats`` reads
    as a private per-instance mapping while the registry (and every
    exporter) sees all instances.

    Reads: ``view[k]`` (missing → 0, the Counter contract), iteration,
    ``len``, ``.get``, ``.items``, ``dict(view)``.  Writes:
    ``view.inc(k, n)`` is the ATOMIC increment; ``view[k] = v`` is an
    absolute set under the lock (only ``inc`` is atomic across
    threads)."""

    def __init__(self, metric: Counter, fixed: Tuple[str, ...] = ()):
        self._metric = metric
        self._fixed = tuple(str(v) for v in fixed)
        if len(self._fixed) + 1 != len(metric.labelnames):
            raise ValueError(
                f"view over {metric.name}{metric.labelnames} needs "
                f"{len(metric.labelnames) - 1} fixed label(s)")

    @property
    def fixed_labels(self) -> Tuple[str, ...]:
        """The pinned label prefix (e.g. this instance's ordinal) — lets a
        holder locate its own rows in a snapshot/fleet rollup, where keys
        render as ``"label=value,...,key=<k>"``."""
        return self._fixed

    # -- writes ----------------------------------------------------------
    def inc(self, key: str, amount: float = 1) -> None:
        """Atomic increment (the thread-safe ``c[k] += 1``)."""
        self._metric.inc(amount, self._fixed + (key,))

    def __setitem__(self, key: str, value: float) -> None:
        self._metric.set(value, self._fixed + (key,))

    # -- Counter-shaped reads -------------------------------------------
    def __getitem__(self, key: str) -> float:
        v = self._metric.get(self._fixed + (key,))
        return int(v) if float(v).is_integer() else v

    def get(self, key: str, default: float = 0) -> float:
        v = self[key]
        return v if key in self else default

    def _keys(self) -> List[str]:
        n = len(self._fixed)
        return sorted(labels[n] for labels, _ in self._metric.items()
                      if labels[:n] == self._fixed)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def __contains__(self, key: object) -> bool:
        return key in self._keys()

    def __repr__(self) -> str:
        return f"LegacyCounterView({dict(self)})"
