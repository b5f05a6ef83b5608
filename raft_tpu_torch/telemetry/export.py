"""Exporters: plain-dict snapshot and Prometheus text exposition (port of
``raft_tpu/telemetry/export.py``; the same text for the same registry).

Both walk the default registry read-only; value lists are copied under
the registry lock per metric (a scrape racing live traffic may observe a
histogram mid-observation — counts torn by at most the in-flight sample,
never a crash).  Both work with telemetry disabled — they render whatever
the live counters accumulated (recording gates live at the instrument,
not the exporter)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from raft_tpu_torch.telemetry.registry import (
    HIST_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    bucket_upper,
)


def _label_key(labelnames: Tuple[str, ...], labels: Tuple[str, ...]) -> str:
    """One flat, JSON-safe key per label-value tuple (`k=v,k2=v2`, or ""
    for the unlabeled cell) — keeps :func:`snapshot` round-trippable
    through ``json.dumps``/``loads`` (dict keys must be strings)."""
    return ",".join(f"{k}={v}" for k, v in zip(labelnames, labels))


def snapshot(registry=None) -> Dict[str, dict]:
    """The whole registry as one plain, JSON-serializable dict.

    ``{metric_name: {"type", "help", "labelnames", "values"}}`` where
    ``values`` maps the flat label key (:func:`_label_key`) to either a
    number (counter/gauge) or, for histograms, a dict with ``count``,
    ``sum``, ``min``, ``max``, the non-empty ``buckets`` as
    ``[[upper_bound_s, count], ...]`` and convenience ``p50``/``p99``
    estimates.  ``json.loads(json.dumps(snapshot()))`` reproduces it
    exactly.  *registry* defaults to the process-wide one; passing another
    :class:`~raft_tpu_torch.telemetry.Registry` snapshots that instead."""
    out: Dict[str, dict] = {}
    for m in (REGISTRY if registry is None else registry).metrics():
        entry = {"type": m.kind, "help": m.help,
                 "labelnames": list(m.labelnames)}
        values: Dict[str, object] = {}
        if isinstance(m, (Counter, Gauge)):
            for labels, v in m.items():
                values[_label_key(m.labelnames, labels)] = v
        elif isinstance(m, Histogram):
            for labels, cell in m.items():
                buckets = [[round(bucket_upper(i), 9), n]
                           for i, n in enumerate(cell.counts) if n]
                values[_label_key(m.labelnames, labels)] = {
                    "count": cell.count, "sum": cell.sum,
                    "min": cell.min, "max": cell.max,
                    "buckets": buckets,
                    "p50": m.quantile(0.5, labels),
                    "p99": m.quantile(0.99, labels),
                }
        entry["values"] = values
        out[m.name] = entry
    return out


def _prom_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


def _prom_label_str(labelnames: Tuple[str, ...], labels: Tuple[str, ...],
                    extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(labelnames, labels)) + list(extra)
    if not pairs:
        return ""
    def esc(v: str) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text() -> str:
    """The registry in Prometheus text exposition format (one scrape body).

    Counters/gauges render as single samples; histograms render the
    standard triplet — cumulative ``_bucket{le=...}`` series ending at
    ``le="+Inf"``, plus ``_sum`` and ``_count``.  ``/metrics`` of
    :meth:`ServeEngine.serve_http` serves it."""
    lines: List[str] = []
    for m in REGISTRY.metrics():
        name = _prom_name(m.name)
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            for labels, v in sorted(m.items()):
                lines.append(
                    f"{name}{_prom_label_str(m.labelnames, labels)} "
                    f"{_fmt(v)}")
        elif isinstance(m, Histogram):
            for labels, cell in sorted(m.items()):
                cum = 0
                for i in range(HIST_BUCKETS):
                    cum += cell.counts[i]
                    if cell.counts[i]:  # sparse: emit buckets that moved
                        le = f"{bucket_upper(i):.9g}"
                        lines.append(
                            f"{name}_bucket"
                            f"{_prom_label_str(m.labelnames, labels, (('le', le),))}"
                            f" {cum}")
                lines.append(
                    f"{name}_bucket"
                    f"{_prom_label_str(m.labelnames, labels, (('le', '+Inf'),))}"
                    f" {cell.count}")
                lines.append(
                    f"{name}_sum{_prom_label_str(m.labelnames, labels)} "
                    f"{repr(float(cell.sum))}")
                lines.append(
                    f"{name}_count{_prom_label_str(m.labelnames, labels)} "
                    f"{cell.count}")
    return "\n".join(lines) + "\n"
