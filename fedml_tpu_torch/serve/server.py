"""HTTP serving frontend: ThreadingHTTPServer over the micro-batcher
(port of ``fedml_tpu/serve/server.py``, stdlib only).

* ``POST /predict`` — body ``{"x": [...], "deadline_ms": 50,
  "tier": "interactive"}``; the answer carries the model version that
  produced it: ``{"y": [...], "version": 12}``.  Shed requests answer
  **429** (deadline/queue_full/slo_degraded), no model yet **503**.  The
  deadline (body field or ``X-Deadline-Ms``) propagates into the
  batcher; the tier (body field or ``X-Tier``) picks who sheds first.
* ``GET /healthz`` — 200 with ``{"status": "ok", "version", "queue_depth"}``
  once a model is live, 503 before.  ``/healthz?deep=1`` also runs the
  `obs.perf.SloEvaluator`: 200 while every SLO holds, **503 with the
  per-SLO verdict** on breach (and the health observatory's last verdict
  when one is attached).
* ``GET /version`` — the live and pinned versions, the history and the
  pending canaries.
* ``GET /metrics`` — Prometheus text from the process telemetry registry.

With tracing on, each /predict records a ``serve_request`` span, the
batcher's queue and batch spans hang under it.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

import numpy as np

from fedml_tpu_torch.obs import telemetry, trace
from fedml_tpu_torch.serve.batcher import (TIERS, BadInstanceError,
                                           MicroBatcher, ShedError)
from fedml_tpu_torch.serve.registry import ModelRegistry

log = logging.getLogger(__name__)


class ServeFrontend:
    """Own the HTTP server lifecycle around a (registry, batcher) pair.

    ``port=0`` binds an ephemeral port (tests); read ``.port`` after
    ``start()``.  ``stop()`` closes the listener, then drains the
    batcher — in-flight requests still answer."""

    def __init__(self, registry: ModelRegistry, batcher: MicroBatcher,
                 port: int = 0, host: str = "127.0.0.1", slo=None,
                 health=None):
        """``slo``: an `obs.perf.SloEvaluator`; when set,
        ``/healthz?deep=1`` evaluates it (deep probes without one answer
        the shallow payload plus ``"deep": "unconfigured"``).

        ``health``: an `obs.health.HealthAccumulator`; when
        set, deep probes also carry the last round's learning-health
        verdict (`HealthAccumulator.healthz` — round, drift alarms,
        upload accounting) so an operator reading a 503 sees WHICH
        alarm tripped, not just that one did."""
        self.registry = registry
        self.batcher = batcher
        self.slo = slo
        self.health = health
        self._host = host
        self._requested_port = port
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        if self._server is None:
            return self._requested_port
        return self._server.server_address[1]

    def start(self) -> "ServeFrontend":
        if self._server is not None:
            return self
        handler = _make_handler(self.registry, self.batcher, self.slo,
                                self.health)
        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._requested_port), handler)
        self._server.daemon_threads = True
        self.batcher.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"serve-http-{self.port}")
        self._thread.start()
        log.info("serving /predict on %s:%d", self._host, self.port)
        return self

    def stop(self, drain: bool = True) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
        self.batcher.stop(drain=drain)


def _make_handler(registry: ModelRegistry, batcher: MicroBatcher,
                  slo=None, health=None, pool=None,
                  worker_id: Optional[int] = None):
    """``pool``/``worker_id``: set by `ServeWorkerPool` — health
    payloads then carry the answering worker's id and every worker's
    queue depth, so one probe through any worker sees the whole pool."""
    class _Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive: the load generator
        # reuses connections, without this every request pays a TCP dial
        disable_nagle_algorithm = True  # headers+body go out as separate
        # small writes; with Nagle on, loopback keep-alive traffic stalls
        # on the peer's ~40ms delayed ACK and p50 jumps 10x

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # split the query off before matching: LB health probes
            # commonly append cache-busting params (/healthz?probe=1);
            # the one query parameter that IS meaningful is healthz's
            # deep=1
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/healthz":
                m = registry.current()
                if m is None:
                    self._reply(503, {"status": "no_model"})
                    return
                body = {"status": "ok", "version": m.version,
                        "queue_depth": batcher.depth()}
                if pool is not None:
                    body["worker"] = worker_id
                    body["workers"] = pool.workers
                    body["queue_depths"] = pool.queue_depths()
                deep = "deep=1" in query.split("&")
                if deep and slo is None:
                    body["deep"] = "unconfigured"
                elif deep:
                    # query path: read the objectives without ticking the
                    # breach counters — those count once per round (the
                    # runner's evaluate()), not once per LB probe
                    results = slo.evaluate(count_breaches=False)
                    ok = all(v["ok"] for v in results.values())
                    body["slo"] = results
                    if health is not None:
                        # the learning-health verdict beside the SLO
                        # numbers: which drift alarm tripped, last round
                        verdict = health.healthz()
                        if verdict is not None:
                            body["health"] = verdict
                    if not ok:
                        body["status"] = "slo_breach"
                        self._reply(503, body)
                        return
                self._reply(200, body)
            elif path == "/version":
                body = {"version": registry.version,
                        "pinned": registry.pinned,
                        "history": registry.versions()}
                canaries = getattr(registry, "canaries", None)
                if canaries is not None:
                    # release-gated registries: name what is in shadow
                    # evaluation so an operator sees the pending canary
                    body["canaries"] = canaries()
                self._reply(200, body)
            elif path == "/metrics":
                body = telemetry.get_registry().render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "not_found", "path": self.path})

        def do_POST(self):
            # ALWAYS consume the body first: on HTTP/1.1 keep-alive an
            # unread body would be parsed as the NEXT request line and
            # desync the connection
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            body = self.rfile.read(n)
            if self.path.split("?", 1)[0].rstrip("/") != "/predict":
                self._reply(404, {"error": "not_found", "path": self.path})
                return
            try:
                req = json.loads(body or b"{}")
                x = np.asarray(req["x"], dtype=np.float32)
                deadline_ms = req.get("deadline_ms",
                                      self.headers.get("X-Deadline-Ms"))
                deadline_s = (float(deadline_ms) / 1e3
                              if deadline_ms is not None else None)
                tier = req.get("tier", self.headers.get("X-Tier",
                                                        "interactive"))
                if tier not in TIERS:
                    raise ValueError(f"unknown tier {tier!r}; expected "
                                     f"one of {TIERS}")
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": "bad_request", "detail": str(e)})
                return
            # the context-manager form makes the request span the
            # thread's CURRENT span, so the batcher's submit sees it and
            # the queue/batch/respond spans hang under this request
            tracer = trace.get_tracer()
            ctx = (tracer.span("serve_request", parent=None,
                               version=registry.version)
                   if tracer is not None else trace.NULL_CONTEXT)
            with ctx as span:
                try:
                    result = batcher.predict(x, deadline_s=deadline_s,
                                             tier=tier)
                    t_resp = time.perf_counter()
                    self._reply(200,
                                {"y": np.asarray(result.y).tolist(),
                                 "version": result.version})
                    if tracer is not None:
                        tracer.record_span(
                            "serve_respond",
                            time.perf_counter() - t_resp, parent=span)
                except ShedError as e:
                    self._reply(503 if e.reason == "no_model" else 429,
                                {"error": "shed", "reason": e.reason,
                                 "tier": tier})
                except FuturesTimeout:
                    # the batcher never answered: a server-side stall,
                    # not a client error — 503 so LBs retry/fail over
                    # instead of blaming the request
                    self._reply(503, {"error": "timeout"})
                except BadInstanceError as e:
                    # the one prediction failure that IS the client's
                    # fault
                    self._reply(400, {"error": "bad_instance",
                                      "detail": str(e)})
                except Exception as e:  # noqa: BLE001 — model/params
                    # fault: a 4xx here would stop LBs retrying a
                    # broken instance
                    self._reply(500, {"error": "predict_failed",
                                      "detail": str(e)})

        def log_message(self, *args):  # no per-request stderr spam
            pass

    return _Handler
