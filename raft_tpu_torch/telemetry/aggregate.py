"""Fleet-wide telemetry aggregation: merge snapshots, gather a fleet view
(port of ``raft_tpu/telemetry/aggregate.py``).

A sharded deployment is one logical system serving one traffic stream —
operators need ONE snapshot for it, not a per-process Python dict apiece
(docs/observability.md §fleet aggregation).  Two pieces:

* :func:`merge` folds any number of :func:`raft_tpu_torch.telemetry.snapshot`
  dicts into one, in the snapshot schema.  Counters sum.  Histograms merge
  EXACTLY: every histogram in the process shares the one fixed log-bucket
  geometry (:data:`~raft_tpu_torch.telemetry.registry.HIST_BUCKETS` bins over
  [HIST_MIN, HIST_MAX]), so merging is bucket-wise integer addition —
  bit-equal to having observed the union stream into one histogram, by
  construction (the property tests pin this).  ``count`` adds, ``sum``
  adds, ``min``/``max`` fold, and the convenience ``p50``/``p99`` are
  re-estimated from the merged buckets through the SAME
  :func:`~raft_tpu_torch.telemetry.registry.quantile_from_counts` implementation
  :meth:`~raft_tpu_torch.telemetry.registry.Histogram.quantile` calls.
  Gauges fold with ``max`` — the shipped gauges are static per-program
  costs (identical on every host, max = identity) and latest achieved
  rates (max = best-achieved across the fleet); a per-host read is always
  available in the ``hosts`` section of a gathered view.

* :func:`gather` collects per-host snapshots over a communicator's host
  p2p plane (the tagged isend/irecv mailbox every :class:`Comms` carries)
  and returns ``{"world", "hosts": {rank: snapshot}, "rollup": merged}``
  — per-host views preserved, plus the summed rollup, on EVERY host
  (symmetric all-to-all exchange, so any host can serve the fleet view
  from its scrape endpoint).  In the port every rank is a process, so a
  world of one gathers trivially: the local snapshot is the fleet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

from raft_tpu_torch.telemetry.export import snapshot
from raft_tpu_torch.telemetry.registry import (
    HIST_BUCKETS,
    bucket_upper,
    quantile_from_counts,
)

#: snapshot() rounds bucket upper bounds to 9 decimals; the same rounding
#: here makes the upper-bound → bucket-index lookup exact (float equality
#: on identical round() outputs), which is what keeps the merge bucket-wise
#: exact instead of nearest-match fuzzy.
_BUCKET_INDEX = {round(bucket_upper(i), 9): i for i in range(HIST_BUCKETS)}


def _counts_from_cell(cell: dict) -> List[int]:
    counts = [0] * HIST_BUCKETS
    for upper, n in cell["buckets"]:
        i = _BUCKET_INDEX.get(upper)
        if i is None:
            raise ValueError(
                f"histogram bucket upper bound {upper!r} is not on the "
                "shared log-bucket grid — snapshots from a build with a "
                "different HIST geometry cannot merge exactly")
        counts[i] += int(n)
    return counts


def _merge_hist_cells(cells: Sequence[dict]) -> dict:
    counts = [0] * HIST_BUCKETS
    total, vsum = 0, 0.0
    lo, hi = math.inf, -math.inf
    for cell in cells:
        for i, n in enumerate(_counts_from_cell(cell)):
            counts[i] += n
        total += int(cell["count"])
        vsum += float(cell["sum"])
        lo = min(lo, float(cell["min"]))
        hi = max(hi, float(cell["max"]))
    return {
        "count": total, "sum": vsum, "min": lo, "max": hi,
        "buckets": [[round(bucket_upper(i), 9), n]
                    for i, n in enumerate(counts) if n],
        "p50": quantile_from_counts(counts, total, lo, hi, 0.5),
        "p99": quantile_from_counts(counts, total, lo, hi, 0.99),
    }


def merge(snapshots: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """Fold snapshot dicts into one (same schema as
    :func:`raft_tpu_torch.telemetry.snapshot`).  Counters sum, gauges fold with
    max, histograms merge bucket-wise exactly (see module docstring).  A
    metric name appearing with conflicting type/labelnames across inputs
    raises — that is a deployment mixing incompatible builds, not
    something to paper over."""
    out: Dict[str, dict] = {}
    for snap in snapshots:
        for name, entry in snap.items():
            prior = out.get(name)
            if prior is None:
                out[name] = {
                    "type": entry["type"], "help": entry["help"],
                    "labelnames": list(entry["labelnames"]),
                    "values": {k: (dict(v) if isinstance(v, dict) else v)
                               for k, v in entry["values"].items()},
                }
                continue
            if (prior["type"] != entry["type"]
                    or list(prior["labelnames"]) != list(entry["labelnames"])):
                raise ValueError(
                    f"metric {name!r} disagrees across snapshots: "
                    f"{prior['type']}{prior['labelnames']} vs "
                    f"{entry['type']}{entry['labelnames']}")
            values = prior["values"]
            for key, v in entry["values"].items():
                cur = values.get(key)
                if cur is None:
                    values[key] = dict(v) if isinstance(v, dict) else v
                elif entry["type"] == "histogram":
                    values[key] = _merge_hist_cells([cur, v])
                elif entry["type"] == "gauge":
                    values[key] = max(cur, v)
                else:  # counter (and untyped): additive
                    values[key] = cur + v
    return out


#: host p2p tag reserved for the snapshot exchange (outside the small-int
#: tag space library algorithms use)
_GATHER_TAG = 0x7E1E


def gather(comms, timeout: float = 60.0, *,
           strict: bool = False) -> Dict[str, object]:
    """Collect every host process's :func:`snapshot` over *comms*' host
    p2p plane and return the fleet view on EVERY host::

        {"world": n_host_processes,
         "hosts": {"0": snapshot, "1": snapshot, ...},   # rank-keyed
         "rollup": merge(all collected host snapshots),
         "partial": False, "missing_ranks": []}

    Should be called collectively by every host process of the
    communicator (a symmetric all-to-all exchange of JSON-safe dicts;
    *timeout* bounds each pending receive).  On a world of one this
    returns immediately with the local snapshot as both the only host
    view and the rollup.

    **Degradation contract**: a dead or slow host must not turn the fleet
    rollup into a timeout for every OTHER rank — an unreachable peer is
    recorded in ``missing_ranks`` (and ``partial: true``), its row is
    absent from ``hosts``, and the rollup merges whatever arrived.  A
    failed telemetry exchange is deliberately NOT treated as a broken
    data-plane clique: the communicator's aborted flag is restored to its
    prior value (the observability plane must never poison the compute
    plane).  ``strict=True`` restores the raise-on-first-failure
    behavior for callers that prefer a loud error to a partial view."""
    local = snapshot()
    world = int(getattr(comms, "_host_world", 1) or 1)
    rank = int(getattr(comms, "_host_rank", 0) or 0)
    hosts: Dict[str, dict] = {str(rank): local}
    missing: List[int] = []
    if world > 1:
        peers = [r for r in range(world) if r != rank]
        prior_aborted = bool(getattr(comms, "_aborted", False))
        for r in peers:
            try:
                comms.isend(local, dst=r, tag=_GATHER_TAG)
            except Exception:
                if strict:
                    raise
                # the peer will learn of us (or not) on its own recv; our
                # collection below decides whether IT is reachable
                comms._aborted = prior_aborted
        for r in peers:
            try:
                hosts[str(r)] = comms.waitall(
                    [comms.irecv(src=r, tag=_GATHER_TAG)],
                    timeout=timeout)[0]
            except Exception:
                if strict:
                    raise
                missing.append(r)
                comms._aborted = prior_aborted
    rollup = merge([hosts[k] for k in sorted(hosts, key=int)])
    return {"world": world, "hosts": hosts, "rollup": rollup,
            "partial": bool(missing), "missing_ranks": missing}
