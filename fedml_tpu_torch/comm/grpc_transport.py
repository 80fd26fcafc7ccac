"""gRPC transport for cross-silo federation over real hosts.

The port's copy of ``fedml_tpu/comm/grpc_transport.py``: one gRPC server
per node at ``base_port + node_id``, peers from a rank→IP table
(`load_ip_table`), each message one unary call of grpc's generic bytes
handler (no codegen; the service name is the JAX package's, so the
frames and the method path are the same).  ``grpc`` is imported in
``GrpcTransport.__init__``, never when this module is imported.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

_SERVICE = "fedml_tpu.Comm"
_METHOD = "Send"
_STOP = object()


def _ident(x: bytes) -> bytes:
    return x


class GrpcTransport(Transport):
    """One endpoint of a full gRPC mesh (every node runs a server)."""

    def __init__(self, node_id: int, ip_table: Dict[int, str],
                 base_port: int = 50000, max_message_mb: int = 1000,
                 send_timeout_s: float = 120.0,
                 idle_timeout_s: float = 0.0,
                 workers: int = 4):
        """``send_timeout_s`` bounds each unary send; sends also set
        ``wait_for_ready`` so a broadcast to a peer that is still booting
        blocks until its server binds instead of failing UNAVAILABLE (the
        reference has the same race and papers over it with sleep-ordered
        launches).  ``idle_timeout_s`` > 0 makes ``run()`` return after that
        long with no traffic — without it a silo whose server died leaks
        forever in the receive loop.  ``workers`` sizes the inbound RPC
        thread pool (the server node of a wide federation should raise it
        with the cohort — ``--grpc_workers``); ``max_message_mb`` is the
        reference's 100 MB cap made configurable (``--grpc_max_message_mb``),
        and sends log a loud warning at 80% of it instead of surfacing a
        bare RESOURCE_EXHAUSTED from deep inside the channel."""
        super().__init__()
        try:
            import grpc  # deferred: optional at import time of the package
        except ImportError as e:
            raise ImportError(
                "the gRPC transport (--silo_backend grpc) needs grpcio, "
                "which is not installed here; install grpcio or use "
                "--silo_backend local") from e
        self._grpc = grpc
        self.node_id = node_id
        self.ip_table = dict(ip_table)
        self.base_port = base_port
        self._inbox: "queue.Queue" = queue.Queue()
        self._channels: Dict[int, object] = {}
        self._max_message_bytes = max_message_mb * 1024 * 1024
        self._warned_large = False
        reg = telemetry.get_registry()
        self._m_torn = reg.counter("fedml_wire_torn_frames_total")

        opts = [("grpc.max_send_message_length", self._max_message_bytes),
                ("grpc.max_receive_message_length", self._max_message_bytes)]
        inbox = self._inbox
        torn = self._m_torn

        def _handle_send(request: bytes, context) -> bytes:
            try:
                msg = Message.from_bytes(request)
            except ValueError as exc:
                # a torn/corrupt frame is dropped like a lost packet — it
                # must never kill the receive path (the sender's retry or
                # the round's straggler policy owns recovery)
                torn.inc()
                log.warning("node %d: dropping undecodable %d-byte frame: "
                            "%s", node_id, len(request), exc)
                return b""
            inbox.put(msg)
            return b""

        rpc = grpc.unary_unary_rpc_method_handler(
            _handle_send, request_deserializer=_ident,
            response_serializer=_ident)
        handler = grpc.method_handlers_generic_handler(_SERVICE, {_METHOD: rpc})
        import concurrent.futures
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=workers),
            handlers=(handler,), options=opts)
        self._port = self._server.add_insecure_port(
            f"[::]:{base_port + node_id}")
        if self._port == 0:
            raise RuntimeError(
                f"grpc transport node {node_id}: failed to bind port "
                f"{base_port + node_id} (already in use?)")
        self._opts = opts
        self._send_timeout_s = send_timeout_s
        self._idle_timeout_s = idle_timeout_s
        self._lock = threading.Lock()
        self._stopped = False
        self._server.start()
        log.info("grpc transport node %d listening on :%d", node_id, self._port)

    def _stub(self, receiver_id: int):
        with self._lock:
            if self._stopped:
                # a send racing stop() must not repopulate the channel
                # cache stop() just closed — that channel would leak
                raise RuntimeError(
                    f"grpc transport node {self.node_id} is stopped")
            if receiver_id not in self._channels:
                addr = (f"{self.ip_table[receiver_id]}:"
                        f"{self.base_port + receiver_id}")
                channel = self._grpc.insecure_channel(addr, options=self._opts)
                call = channel.unary_unary(
                    f"/{_SERVICE}/{_METHOD}", request_serializer=_ident,
                    response_deserializer=_ident)
                self._channels[receiver_id] = (channel, call)
            return self._channels[receiver_id][1]

    def send_message(self, msg: Message) -> None:
        # to_bytes reuses the fan-out's shared block when one is attached
        # (send_many): per receiver this is one small header encode + one
        # memcpy, never a re-serialization of the model bytes
        data = msg.to_bytes()
        if len(data) > 0.8 * self._max_message_bytes \
                and not self._warned_large:
            self._warned_large = True  # once per transport, not per silo
            log.warning(
                "node %d: encoded frame is %.1f MB — over 80%% of the "
                "%.0f MB gRPC message limit; raise --grpc_max_message_mb "
                "before this surfaces as RESOURCE_EXHAUSTED",
                self.node_id, len(data) / 1e6,
                self._max_message_bytes / 1e6)
        self._obs_send(msg, len(data))
        self._stub(msg.receiver_id)(
            data, wait_for_ready=True,
            timeout=self._send_timeout_s or None)

    def reconnect(self) -> None:
        """Drop every cached client channel so the next send dials fresh.

        The reconnection hook `ResilientTransport` calls between retry
        attempts: a peer that restarted (new process, same address) gets a
        clean channel instead of a channel wedged in TRANSIENT_FAILURE."""
        with self._lock:
            channels, self._channels = dict(self._channels), {}
        for channel, _ in channels.values():
            channel.close()

    def run(self) -> None:
        while True:
            try:
                item = self._inbox.get(
                    timeout=self._idle_timeout_s or None)
            except queue.Empty:
                log.warning("grpc transport node %d: no traffic for %.0fs; "
                            "shutting down receive loop", self.node_id,
                            self._idle_timeout_s)
                # release the port and client channels now rather than at
                # interpreter shutdown (stop() also enqueues _STOP, which
                # is harmless — this loop is already returning)
                self.stop()
                return
            if item is _STOP:
                return
            self._notify(item)

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return  # idempotent: run()'s idle path and callers both stop
            self._stopped = True
            channels, self._channels = dict(self._channels), {}
        self._inbox.put(_STOP)
        for channel, _ in channels.values():
            channel.close()
        self._server.stop(grace=None)


def load_ip_table(csv_path: str) -> Dict[int, str]:
    """Parse the reference's rank→IP CSV (``grpc_ipconfig.csv``; parser at
    fedml_api/distributed/utils/ip_config_utils.py:4-14)."""
    table: Dict[int, str] = {}
    with open(csv_path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or (i == 0 and not line.split(",")[0].isdigit()):
                continue  # header row
            rank, ip = line.split(",")[:2]
            table[int(rank)] = ip.strip()
    return table
