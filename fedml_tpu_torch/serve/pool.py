"""Multi-worker HTTP serving: N accept loops over ONE model registry
(port of ``fedml_tpu/serve/pool.py``).

N workers, each a full (listener, `MicroBatcher`) pair, all bound to the
SAME port with ``SO_REUSEPORT`` — the kernel balances connections across
the listening sockets, and every worker batches against the one shared
`ModelRegistry`, so hot-swap, pin and rollback are exactly the single
frontend's.  Without ``SO_REUSEPORT`` (or ``reuseport=False``) the
workers share ONE non-blocking listening socket (``accept`` is
thread-safe).

Telemetry is worker-labeled (``fedml_serve_*{worker="i"}``); ``/healthz``
carries the answering worker's id and every worker's queue depth, and
``/healthz?deep=1`` runs the shared `SloEvaluator`, whose
``serve_queue_utilization_ratio`` objective reads the WORST worker.
"""

from __future__ import annotations

import http.server
import logging
import socket
import threading
from typing import Callable, List, Optional

from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.serve.batcher import MicroBatcher, TierGate
from fedml_tpu_torch.serve.registry import ModelRegistry
from fedml_tpu_torch.serve.server import _make_handler

log = logging.getLogger(__name__)


def _reuseport_available() -> bool:
    return hasattr(socket, "SO_REUSEPORT")


def _bind_listener(host: str, port: int, reuseport: bool) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        if reuseport:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(128)
    except BaseException:
        s.close()
        raise
    return s


class _WorkerServer(http.server.ThreadingHTTPServer):
    """An HTTPServer over a PRE-BOUND socket (ours came from
    `_bind_listener`, possibly shared between workers)."""

    def __init__(self, sock: socket.socket, handler, owns_socket: bool):
        # bind_and_activate=False: the listener already exists
        super().__init__(sock.getsockname(), handler,
                         bind_and_activate=False)
        self.socket.close()          # the placeholder from __init__
        self.socket = sock
        self.server_address = sock.getsockname()
        self._owns_socket = owns_socket
        self.daemon_threads = True

    def server_close(self):
        if self._owns_socket:
            super().server_close()
        # a SHARED socket is closed once, by the pool


class ServeWorkerPool:
    """N HTTP workers × 1 registry: the production serving frontend.

    ``batcher_factory(worker_idx) -> MicroBatcher`` builds each worker's
    batcher (default: `MicroBatcher` over ``registry`` with
    ``batcher_kw``, worker-labeled).  ``slo``/``health`` back deep
    health checks exactly as on `ServeFrontend`; the pool wraps ``slo``
    in ONE shared `TierGate` so all workers' tiered admission reads one
    cached verdict.  ``port=0`` binds an ephemeral port (tests); read
    ``.port`` after ``start()``.
    """

    def __init__(self, registry: ModelRegistry, port: int = 0,
                 host: str = "127.0.0.1", workers: int = 2,
                 batcher_factory: Optional[Callable[[int],
                                                    MicroBatcher]] = None,
                 slo=None, health=None, reuseport: Optional[bool] = None,
                 **batcher_kw):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.registry = registry
        self.workers = workers
        self.slo = slo
        self.health = health
        self._host = host
        self._requested_port = port
        self._reuseport = (_reuseport_available() if reuseport is None
                           else bool(reuseport))
        gate = TierGate(slo) if slo is not None else None
        if batcher_factory is None:
            def batcher_factory(i: int) -> MicroBatcher:
                return MicroBatcher(registry, worker=str(i), slo=gate,
                                    **batcher_kw)
        else:
            if slo is not None:
                # fail loudly: the pool cannot inject the gate into a
                # caller-built batcher, and silently dropping it would
                # let deep-healthz answer 503 while best-effort traffic
                # is never shed — the exact shedding/health disagreement
                # the design forbids.  Wire TierGate(slo) (or the
                # evaluator itself) into the factory's batchers instead.
                raise ValueError(
                    "slo= and batcher_factory= together: pass the "
                    "SloEvaluator (or a shared TierGate) to the "
                    "factory's own MicroBatcher(slo=...) so tiered "
                    "shedding reads the same verdicts as deep-healthz")
            if batcher_kw:
                raise ValueError("pass batcher options through the "
                                 "factory when batcher_factory is "
                                 "given, not as extra kwargs "
                                 f"{sorted(batcher_kw)}")
        self._factory = batcher_factory
        self.batchers: List[MicroBatcher] = []
        self._servers: List[_WorkerServer] = []
        self._threads: List[threading.Thread] = []
        self._sockets: List[socket.socket] = []
        reg = telemetry.get_registry()
        self._g_workers = reg.gauge("fedml_serve_workers_value")

    @property
    def port(self) -> int:
        if not self._sockets:
            return self._requested_port
        return self._sockets[0].getsockname()[1]

    def queue_depths(self) -> List[int]:
        return [b.depth() for b in self.batchers]

    def start(self) -> "ServeWorkerPool":
        if self._servers:
            return self
        first = _bind_listener(self._host, self._requested_port,
                               self._reuseport)
        self._sockets.append(first)
        port = first.getsockname()[1]
        if self._reuseport:
            # one listener per worker, kernel-balanced
            for _ in range(1, self.workers):
                self._sockets.append(
                    _bind_listener(self._host, port, True))
            per_worker = self._sockets
            owns = [True] * self.workers
        else:
            # shared-accept fallback: every worker accepts from the one
            # listener; the pool owns (and closes) it once.  The socket
            # must be NON-BLOCKING: every worker's selector wakes on one
            # incoming connection and all of them race to accept() — the
            # losers must get BlockingIOError (socketserver swallows it)
            # instead of parking in accept() forever, which would wedge
            # serve_forever past shutdown().  Accepted connections come
            # back blocking (CPython restores default blocking-ness), so
            # request handling is unchanged.
            first.setblocking(False)
            per_worker = [first] * self.workers
            owns = [False] * self.workers
        for i in range(self.workers):
            batcher = self._factory(i)
            batcher.start()
            self.batchers.append(batcher)
            handler = _make_handler(self.registry, batcher, self.slo,
                                    self.health, pool=self, worker_id=i)
            server = _WorkerServer(per_worker[i], handler, owns[i])
            self._servers.append(server)
            t = threading.Thread(target=server.serve_forever, daemon=True,
                                 name=f"serve-worker-{i}-{port}")
            t.start()
            self._threads.append(t)
        self._g_workers.set(self.workers)
        log.info("serve pool: %d workers on %s:%d (%s)", self.workers,
                 self._host, port,
                 "SO_REUSEPORT" if self._reuseport else "shared accept")
        return self

    def warmup(self, sample_x) -> int:
        """Run every bucket once on every worker's batcher.  Returns the
        total buckets warmed."""
        return sum(b.warmup(sample_x) for b in self.batchers)

    def stop(self, drain: bool = True) -> None:
        for server in self._servers:
            server.shutdown()
            server.server_close()
        if not self._reuseport and self._sockets:
            self._sockets[0].close()
        self._servers = []
        self._threads = []
        self._sockets = []
        for b in self.batchers:
            b.stop(drain=drain)
        self.batchers = []
