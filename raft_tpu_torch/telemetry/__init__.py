"""Runtime telemetry: metrics registry, span tracing, exporters (port of
``raft_tpu/telemetry``).

ONE process-wide registry of labeled counters, gauges and fixed-memory
log-bucketed histograms (:mod:`.registry`), nested host-side spans that
also open ``torch.profiler`` ranges while a trace runs (:mod:`.spans`),
exporters — plain-dict :func:`snapshot`, Prometheus text
:func:`prometheus_text`, an opt-in JSONL span sink — sampled device time
per serving program (:mod:`.device`) and the live scrape surface
(:mod:`.http`, lazy import; ``ServeEngine.serve_http`` wires it).

Global off switch: ``RAFT_TPU_TELEMETRY=0`` (or :func:`set_enabled`) turns
spans, histograms, gauges, reservoirs, device sampling and the JSONL sink
into no-ops; counters stay live.

Fleet aggregation (:mod:`.aggregate`): :func:`merge` folds snapshots
exactly, :func:`gather` collects every rank's over a communicator's host
plane.  :func:`program_costs` is dropped: it reads XLA's cost analysis,
which PyTorch has no counterpart of.

Quick tour::

    from raft_tpu_torch import telemetry

    with telemetry.span("serve.dispatch"):
        ...                                   # timed, nested, profiled
    telemetry.snapshot()                      # plain dict, JSON-safe
    print(telemetry.prometheus_text())        # Prometheus scrape body
"""

from __future__ import annotations

from raft_tpu_torch.telemetry import device as _device
from raft_tpu_torch.telemetry.aggregate import gather, merge  # noqa: F401
from raft_tpu_torch.telemetry.device import (  # noqa: F401
    program_costs,
    sample_every,
    set_sample_every,
)
from raft_tpu_torch.telemetry.export import (  # noqa: F401
    prometheus_text,
    snapshot,
)
from raft_tpu_torch.telemetry.registry import (  # noqa: F401
    HIST_BUCKETS,
    HIST_MAX,
    HIST_MIN,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    LegacyCounterView,
    Registry,
    Reservoir,
    bucket_index,
    bucket_upper,
    enabled,
    merged_quantile,
    set_enabled,
)
from raft_tpu_torch.telemetry.spans import (  # noqa: F401
    Span,
    collect_spans,
    current_span,
    now,
    set_jsonl_sink,
    span,
)


def __getattr__(name):
    # the scrape-surface module pulls in stdlib http.server — loaded
    # lazily so importing the package stays cheap
    if name == "http":
        import importlib

        return importlib.import_module("raft_tpu_torch.telemetry.http")
    raise AttributeError(f"module 'raft_tpu_torch.telemetry' has no "
                         f"attribute {name!r}")


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    """Get-or-create a labeled counter on the default registry."""
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    """Get-or-create a labeled gauge on the default registry."""
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              reservoir: int = 0) -> Histogram:
    """Get-or-create a labeled log-bucketed histogram on the default
    registry (optional bounded uniform *reservoir* per label set)."""
    return REGISTRY.histogram(name, help, labelnames, reservoir=reservoir)


def legacy_counter(name: str, help: str = "", labelnames=("key",),
                   fixed=()) -> LegacyCounterView:
    """A :class:`LegacyCounterView` over ``name{*labelnames}``.
    *labelnames* must end in ``"key"`` (the view's mapping key); *fixed*
    pins every label before it (e.g. a per-engine ordinal)."""
    metric = REGISTRY.counter(name, help, tuple(labelnames))
    return LegacyCounterView(metric, tuple(str(v) for v in fixed))


# ---------------------------------------------------------------------------
# instruments of the serving dispatch path (the reference records these in
# its AOT dispatcher; the port's engine records them per super-batch)

_dispatch_total = None
_dispatch_seconds = None


def _dispatch_metrics():
    global _dispatch_total, _dispatch_seconds
    if _dispatch_total is None:
        _dispatch_total = REGISTRY.counter(
            "raft_tpu_aot_dispatch_total",
            "serving dispatches by function and warm/cold state",
            labelnames=("fn", "temp"))
        _dispatch_seconds = REGISTRY.histogram(
            "raft_tpu_aot_dispatch_seconds",
            "host-side dispatch latency per function and signature",
            labelnames=("fn", "sig"))
    return _dispatch_total, _dispatch_seconds


def record_dispatch(fn: str, sig: str, cold: bool, seconds: float) -> None:
    """One dispatch: bump the per-function warm/cold count (live under
    ``RAFT_TPU_TELEMETRY=0``) and record the host-side dispatch latency
    under the (fn, sig) pair.  On the card that latency is the enqueue
    only; :func:`record_device_sample` carries the device's time."""
    total, hist = _dispatch_metrics()
    total.inc(1, (fn, "cold" if cold else "warm"))
    hist.observe(seconds, (fn, sig))


def device_sample_due(fn: str) -> bool:
    """Dispatch-time gate: True when this warm dispatch of *fn* should be
    timed on the device (every ``RAFT_TPU_DEVICE_SAMPLE``-th; default
    1/64, the first warm dispatch always).  False with telemetry
    disabled."""
    return _device.sample_due(fn)


def record_device_sample(fn: str, sig: str, seconds: float) -> None:
    """Record one device-time sample of *fn* at dispatch signature *sig*
    into ``raft_tpu_device_seconds{fn}`` and
    ``raft_tpu_device_signature_seconds{fn,sig}``."""
    _device.record_sample(fn, sig, seconds)
