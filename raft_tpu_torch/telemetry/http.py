"""Live scrape surface: /metrics, /healthz, /varz, /debug/slow (port of
``raft_tpu/telemetry/http.py``).

Stdlib only (``http.server.ThreadingHTTPServer``).  Endpoints:

* ``/metrics``    — :func:`raft_tpu_torch.telemetry.prometheus_text`
  (text exposition, content type ``text/plain; version=0.0.4``).
* ``/healthz``    — JSON readiness from the installed health callback
  (``ServeEngine.serve_http`` wires engine readiness: warmed buckets
  present, no refresh in flight).  HTTP 200 when ``ready``, 503 when not.
* ``/varz``       — the full :func:`raft_tpu_torch.telemetry.snapshot` as
  JSON.
* ``/debug/slow`` — the flight recorder: a BOUNDED ring of span trees for
  requests that breached a latency threshold, newest last.

Every handler renders under the registry's own read locks, so a scrape
racing live traffic is torn by at most the in-flight observation.
"""

from __future__ import annotations

import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.telemetry import export as _export

#: default /debug/slow latency threshold (seconds) and ring capacity
DEFAULT_SLOW_THRESHOLD_S = 0.25
DEFAULT_SLOW_CAP = 64


def _span_tree(events: List[dict]) -> List[dict]:
    """Nest a completion-ordered event list (children complete before
    parents — the collector/JSONL order) into trees.  Events are grouped
    per thread first (each thread's span stack nests independently); a
    parent at depth d adopts every pending subtree at depth d+1."""
    roots: List[dict] = []
    by_thread: Dict[int, List[dict]] = {}
    for e in events:
        by_thread.setdefault(e.get("thread", 0), []).append(e)
    for tevents in by_thread.values():
        pending: Dict[int, List[dict]] = {}
        for e in tevents:
            d = int(e.get("depth", 0))
            node = dict(e)
            node["children"] = pending.pop(d + 1, [])
            pending.setdefault(d, []).append(node)
        # depth-0 spans are proper roots; anything left at a deeper depth
        # means the collector opened mid-nesting — surface it, don't drop
        for d in sorted(pending):
            roots.extend(pending[d])
    return roots


class FlightRecorder:
    """Bounded ring of slow-request span trees (the /debug/slow body).

    ``record(events, **meta)`` nests the collected span events
    (:class:`raft_tpu_torch.telemetry.collect_spans` order) into a tree and
    appends one entry; the deque drops the oldest beyond *cap*, so a
    pathological traffic pattern costs a constant ~cap trees of memory no
    matter how long it lasts.  ``seen`` counts every recorded entry
    (including since-evicted ones), so "how often are we slow" survives
    the ring wrapping."""

    def __init__(self, threshold_s: float = DEFAULT_SLOW_THRESHOLD_S,
                 cap: int = DEFAULT_SLOW_CAP):
        self.threshold_s = float(threshold_s)
        self.cap = int(cap)
        self.seen = 0
        self._ring = collections.deque(maxlen=self.cap)
        self._lock = threading.Lock()

    def record(self, events: List[dict], **meta) -> None:
        entry = dict(meta)
        entry["spans"] = _span_tree(events)
        with self._lock:
            self.seen += 1
            entry["seq"] = self.seen
            self._ring.append(entry)

    def entries(self) -> List[dict]:
        """The ring's entries, oldest first."""
        with self._lock:
            return list(self._ring)

    def view(self) -> dict:
        """The /debug/slow JSON body."""
        with self._lock:
            return {"threshold_s": self.threshold_s, "cap": self.cap,
                    "recorded": self.seen, "entries": list(self._ring)}


class TelemetryServer:
    """The scrape server.  ``port=0`` binds an ephemeral port (read it
    back from ``.port``); ``start()`` serves on a daemon thread and
    returns self; ``close()`` shuts down and joins.  *health* and *varz*
    are zero-arg callables returning JSON-safe dicts (/varz defaults to
    the registry's snapshot); *recorder* supplies /debug/slow."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 health: Optional[Callable[[], dict]] = None,
                 varz: Optional[Callable[[], dict]] = None,
                 recorder: Optional[FlightRecorder] = None):
        self._health = health
        self._varz = varz
        self.recorder = recorder
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr line per scrape
                pass

            def do_GET(self):
                try:
                    body, ctype, code = outer._route(self.path)
                except Exception as e:  # a handler bug must not kill serving
                    body = json.dumps({"error": repr(e)}).encode()
                    ctype, code = "application/json", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def _route(self, path: str):
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return (_export.prometheus_text().encode(),
                    "text/plain; version=0.0.4; charset=utf-8", 200)
        if path == "/healthz":
            health = self._health() if self._health is not None else {
                "ready": True}
            code = 200 if health.get("ready", True) else 503
            return json.dumps(health).encode(), "application/json", code
        if path == "/varz":
            varz = (self._varz() if self._varz is not None
                    else _export.snapshot())
            return json.dumps(varz).encode(), "application/json", 200
        if path == "/debug/slow":
            view = (self.recorder.view() if self.recorder is not None
                    else {"threshold_s": None, "cap": 0, "recorded": 0,
                          "entries": []})
            return json.dumps(view).encode(), "application/json", 200
        return (json.dumps({
            "error": "not found",
            "endpoints": ["/metrics", "/healthz", "/varz", "/debug/slow"],
        }).encode(), "application/json", 404)

    def start(self) -> "TelemetryServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name=f"raft-tpu-torch-telemetry-http-{self.port}", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def serve(port: int = 0, host: str = "127.0.0.1", *,
          health: Optional[Callable[[], dict]] = None,
          varz: Optional[Callable[[], dict]] = None,
          recorder: Optional[FlightRecorder] = None) -> TelemetryServer:
    """Start a standalone scrape server over the process-wide registry
    (``ServeEngine.serve_http`` is the engine-wired form); the caller owns
    ``close()``."""
    return TelemetryServer(port, host, health=health, varz=varz,
                           recorder=recorder).start()
