"""Thread-safe counter/gauge/histogram registry with Prometheus text
exposition.

The port's own copy of ``fedml_tpu/obs/telemetry.py`` (stdlib only): the
transports, actors, admission screens and folds cache their metric
handles from it, with the same ``fedml_*`` names as the JAX package.

Design:

* **Null-object default** — ``get_registry()`` returns a `NullRegistry`
  until `enable()` is called.  Instrumented code caches metric handles at
  construction time, so a disabled run pays one ``is-enabled`` branch per
  hot-path event and allocates nothing per message.
* **naming contract** — every metric name must match
  ``fedml_[a-z0-9_]+`` and end in a unit suffix ``_total`` / ``_seconds``
  / ``_bytes`` / ``_ratio`` / ``_value`` (enforced at registration;
  linted by tests/test_metric_naming.py) so dashboards never chase
  renames.  ``_ratio`` exists for non-monotonic rate gauges and
  ``_value`` for non-monotonic unitless point-in-time gauges (update
  norms, delta norms) — Prometheus tooling treats ``*_total`` as
  counter-by-convention, so a gauge holding a measurement that goes up
  AND down must not wear it (count-valued state gauges like
  ``fedml_robust_quarantined_total`` keep ``_total`` by repo
  precedent).
* **exposition** — ``render_prometheus()`` emits the text format; an
  optional ``start_http_server(port)`` serves it at ``/metrics`` from a
  stdlib ThreadingHTTPServer daemon thread; ``snapshot()``/``save()``
  give the JSON form `obs/report.py` merges with metrics.jsonl.
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import re
import threading
import time
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

NAME_RE = re.compile(
    r"^fedml_[a-z0-9_]+(_total|_seconds|_bytes|_ratio|_value)$")

# wall-clock-latency buckets (seconds); callers pass their own for
# count-valued histograms (quorum size, staleness)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _NullMetric:
    """Shared no-op handle: every method is a pass, so disabled
    instrumentation costs one cached attribute call."""
    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    @property
    def value(self):
        return 0.0


NULL_METRIC = _NullMetric()


class NullRegistry:
    """Disabled-mode registry: hands out the shared no-op metric."""
    enabled = False

    def counter(self, name: str, help: str = "", **labels):
        return NULL_METRIC

    def gauge(self, name: str, help: str = "", **labels):
        return NULL_METRIC

    def histogram(self, name: str, help: str = "", buckets=None, **labels):
        return NULL_METRIC

    def names(self):
        return []

    def snapshot(self) -> dict:
        return {}

    def render_prometheus(self) -> str:
        return ""

    def save(self, path: str) -> None:
        pass


class Counter:
    """Monotonic counter.  ``inc`` only (Prometheus contract)."""
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value: set / inc / dec."""
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Fixed-bucket histogram (per-bucket counts + sum + count + min/max)."""
    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, lock: threading.Lock, buckets=DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly increasing, "
                             f"got {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None

    def observe(self, v) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def stats(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "mean": (self.sum / self.count) if self.count else None,
                    "buckets": {str(b): c for b, c in
                                zip(self.buckets, self.counts)} |
                               {"+Inf": self.counts[-1]}}


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class TelemetryRegistry:
    """Get-or-create metric families keyed by (name, labels).

    One lock serializes registration AND all metric mutation — federated
    hot paths are message-rate, not instruction-rate, so contention is
    negligible and the invariants are trivially safe under the actor
    threads (event loops, heartbeats, chaos timers, resilient senders).
    """
    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], object] = {}
        self._kinds: Dict[str, str] = {}    # family name -> kind

    def _get(self, kind: str, name: str, labels: dict, factory):
        if not NAME_RE.match(name):
            raise ValueError(
                f"telemetry metric {name!r} violates the naming contract "
                f"fedml_[a-z0-9_]+ with a _total/_seconds/_bytes/_ratio "
                f"suffix")
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            have = self._kinds.get(name)
            if have is not None and have != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{have}, not {kind}")
            self._kinds[name] = kind
            metric = self._metrics.get(key)
            if metric is None:
                metric = factory()
                self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, labels,
                         lambda: Counter(self._lock))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(self._lock))

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda: Histogram(self._lock, buckets or DEFAULT_BUCKETS))

    # -- export --------------------------------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._kinds)

    def snapshot(self) -> dict:
        """JSON-able dump: {counters, gauges, histograms} keyed by the
        Prometheus series name (labels included)."""
        with self._lock:
            items = list(self._metrics.items())
            kinds = dict(self._kinds)
        out = {"ts": time.time(), "counters": {}, "gauges": {},
               "histograms": {}}
        for (name, labels), metric in sorted(items):
            series = name + _label_str(dict(labels))
            kind = kinds[name]
            if kind == "histogram":
                out["histograms"][series] = metric.stats()
            else:
                out[kind + "s"][series] = metric.value
        return out

    def render_prometheus(self) -> str:
        lines = []
        last_family = None
        # hold the registry lock for the WHOLE render: metric fields are
        # read directly (never via stats(), which would re-acquire), so a
        # concurrent observe() cannot produce a scrape whose buckets
        # disagree with its _sum/_count
        with self._lock:
            for (name, labels), metric in sorted(self._metrics.items()):
                kind = self._kinds[name]
                if name != last_family:
                    lines.append(f"# TYPE {name} {kind}")
                    last_family = name
                labels = dict(labels)
                if kind == "histogram":
                    cum = 0
                    for b, c in zip(metric.buckets + (float("inf"),),
                                    metric.counts):
                        cum += c
                        le = "+Inf" if b == float("inf") else repr(b)
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str(labels | {'le': le})} {cum}")
                    lines.append(f"{name}_sum{_label_str(labels)} "
                                 f"{metric.sum}")
                    lines.append(f"{name}_count{_label_str(labels)} "
                                 f"{metric.count}")
                else:
                    lines.append(f"{name}{_label_str(labels)} "
                                 f"{metric.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def save(self, path: str) -> None:
        """Atomic JSON snapshot (tmp + os.replace — a crashed run still
        leaves the previous readable snapshot, never a torn file)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)


def link_counter(registry, cache: dict, name: str, src, dst):
    """Get-or-create a per-link counter through a caller-held cache: one
    dict lookup per message instead of registry-lock + label-string
    formatting.  The shared hot-path idiom for every transport flavor
    (send/recv/bytes in `Transport`, wire bytes in `LocalHub`)."""
    key = (name, src, dst)
    counter = cache.get(key)
    if counter is None:
        counter = registry.counter(name, link=f"{src}->{dst}")
        cache[key] = counter
    return counter


# -- process-global registry -------------------------------------------------

_registry = NullRegistry()


def get_registry():
    """The process registry: a `NullRegistry` until `enable()` runs.
    Instrumented constructors cache handles from this — enable telemetry
    BEFORE building transports/actors."""
    return _registry


def enable(registry: Optional[TelemetryRegistry] = None) -> TelemetryRegistry:
    global _registry
    if not isinstance(_registry, TelemetryRegistry):
        _registry = registry if registry is not None else TelemetryRegistry()
    return _registry


def disable() -> None:
    global _registry
    _registry = NullRegistry()


def start_http_server(port: int, registry=None, host: str = ""):
    """Serve ``GET /metrics`` (Prometheus text) and ``GET /healthz`` on
    ``port`` from a daemon thread.  Returns the server — or **None when
    the bind fails** (port already taken by a sibling run): a training
    job must never crash over its scrape endpoint, so the failure warns
    and the run continues unexported.  Call ``.shutdown()`` to stop it."""
    import http.server

    reg = registry if registry is not None else get_registry()
    if isinstance(reg, NullRegistry):
        # fail loud, not silent: a scrape endpoint over the Null registry
        # would serve an empty exposition forever and every dashboard
        # would read "healthy, no traffic" — the exact lie --metrics_port
        # exists to prevent.  Callers must enable() first.
        raise ValueError(
            "start_http_server needs a live telemetry registry, but "
            "telemetry is disabled (NullRegistry): call "
            "telemetry.enable() first (--telemetry / --metrics_port "
            "imply it in the experiment runner)")

    class _Handler(http.server.BaseHTTPRequestHandler):
        # socket read timeout (StreamRequestHandler applies it to the
        # connection): a scraper that connects and then never sends its
        # request line times out and closes instead of pinning a
        # handler thread forever
        timeout = 5

        def do_GET(self):
            # drop query strings: probes append cache-busters
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/healthz":
                body = b'{"status": "ok"}'
                ctype = "application/json"
            elif path in ("", "/metrics"):
                body = reg.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: no per-scrape stderr spam
            pass

    try:
        server = http.server.ThreadingHTTPServer((host, port), _Handler)
    except OSError as e:
        log.warning("telemetry: cannot serve /metrics on port %d (%s) — "
                    "continuing without the HTTP endpoint", port, e)
        return None
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"telemetry-http-{port}")
    thread.start()
    return server
