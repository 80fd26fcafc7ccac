"""In-process transport: a `LocalHub` routes messages between
`LocalTransport` endpoints through per-node queues.

The port's copy of ``fedml_tpu/comm/local.py``.  Two drive modes:

- **threaded** (`transport.run()` per node thread);
- **synchronous pump** (`hub.pump()`): delivers queued messages one at a
  time on the caller's thread — deterministic, no sleeps.  The cross-silo
  runner drives the federation this way.

``codec_roundtrip=True`` puts every message through the binary codec, so
the in-process federation pays exactly the wire's encode and decode.
Do not mix the two modes on one hub.
"""

from __future__ import annotations

import queue
from typing import Dict

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry

_STOP = object()


class LocalHub:
    """Routes messages between in-process transports by receiver_id."""

    def __init__(self, codec_roundtrip: bool = False):
        # codec_roundtrip=True forces every message through the binary codec,
        # so tests also exercise serialization exactly as a wire transport
        # would
        self.codec_roundtrip = codec_roundtrip
        self._endpoints: Dict[int, "LocalTransport"] = {}
        self._reg = telemetry.get_registry()
        self._link_bytes: Dict[tuple, object] = {}

    def transport(self, node_id: int) -> "LocalTransport":
        t = LocalTransport(self, node_id)
        self._endpoints[node_id] = t
        return t

    def route(self, msg: Message) -> None:
        if self.codec_roundtrip:
            # encode-once fan-out (send_many): the shared payload was
            # serialized once for the whole broadcast — roundtrip this
            # receiver's frame from its PARTS (small header + a view of
            # the shared block) so the hub neither re-encodes nor even
            # assembles a contiguous copy per receiver
            parts = msg.frame_parts()
            nbytes = sum(len(p) if isinstance(p, (bytes, bytearray))
                         else p.nbytes for p in parts)
            if self._reg.enabled:
                # the codec roundtrip IS this hub's wire: report its frame
                # size like a real transport reports socket bytes
                telemetry.link_counter(
                    self._reg, self._link_bytes,
                    "fedml_comm_wire_bytes_total",
                    msg.sender_id, msg.receiver_id).inc(nbytes)
            msg = Message.from_frame_parts(parts)
        target = self._endpoints.get(msg.receiver_id)
        if target is None:
            raise KeyError(f"no endpoint for receiver {msg.receiver_id}")
        target._inbox.put(msg)

    # -- synchronous drive mode ---------------------------------------------
    def pump(self, max_messages: int = 100_000, idle_hook=None) -> int:
        """Deliver queued messages on this thread until quiescent.

        Round-robins over endpoints in node-id order; each delivery may
        enqueue more messages (a handler that replies), so pumping repeats
        until every inbox is empty.  Returns the number delivered.

        ``idle_hook``: called when a pass over every inbox made no
        progress; a truthy return means it produced work (the ingest
        pipeline drained queued folds whose round close enqueued
        broadcasts) and the pump keeps going.  Delivery order stays the
        round robin, and the drain is the only cross-thread rendezvous.
        """
        delivered = 0
        progress = True
        while progress and delivered < max_messages:
            progress = False
            for node_id in sorted(self._endpoints):
                endpoint = self._endpoints[node_id]
                try:
                    msg = endpoint._inbox.get_nowait()
                except queue.Empty:
                    continue
                if msg is _STOP:  # a finish() in pump mode is just a no-op,
                    progress = True  # but consuming it IS progress: messages
                    continue         # queued behind it must still deliver
                endpoint._notify(msg)
                delivered += 1
                progress = True
            if not progress and idle_hook is not None:
                progress = bool(idle_hook())
        return delivered


class LocalTransport(Transport):
    def __init__(self, hub: LocalHub, node_id: int):
        super().__init__()
        self.hub = hub
        self.node_id = node_id
        self._inbox: "queue.Queue" = queue.Queue()
        self._stopped = False

    def send_message(self, msg: Message) -> None:
        self._obs_send(msg)
        self.hub.route(msg)

    def run(self) -> None:
        while True:
            item = self._inbox.get()
            if item is _STOP:
                return
            self._notify(item)

    def stop(self) -> None:
        if self._stopped:
            return  # idempotent: a second _STOP would strand a future run()
        self._stopped = True
        self._inbox.put(_STOP)
