"""Transport SPI — the seam between the actors' choreography and the wire.

The port's copy of ``fedml_tpu/comm/transport.py`` (the reference's
``BaseCommunicationManager`` and ``Observer``): ``run()`` blocks
dispatching inbound messages to observers, ``send_message`` delivers one
message, ``send_many`` a fan-out built by `message.build_fanout`.  Every
concrete transport inherits per-link send/recv counters.
"""

from __future__ import annotations

import abc
from typing import Protocol, runtime_checkable

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import telemetry


@runtime_checkable
class Observer(Protocol):
    def receive_message(self, msg_type, msg: Message) -> None: ...


class Transport(abc.ABC):
    """Abstract p2p transport: deliver Messages between numbered nodes.

    Telemetry: every concrete transport inherits per-link send/recv
    counters (``fedml_comm_{send,recv,send_bytes}_total``, labeled
    ``link="src->dst"``).  Handles come from the process registry at
    construction; with telemetry disabled the registry is the null
    object and each hot-path site pays one branch (``_reg.enabled``),
    no allocations.  Subclasses call ``_obs_send(msg[, nbytes])`` where
    they serialize/send; recv is counted centrally in ``_notify``.
    """

    flavor = "p2p"

    def __init__(self):
        self._observers: list[Observer] = []
        self._reg = telemetry.get_registry()
        self._link_cache: dict = {}  # (name, src, dst) -> counter

    def _obs_send(self, msg: Message, nbytes: int = 0) -> None:
        if not self._reg.enabled:
            return
        telemetry.link_counter(self._reg, self._link_cache,
                               "fedml_comm_send_total",
                               msg.sender_id, msg.receiver_id).inc()
        if nbytes:
            telemetry.link_counter(self._reg, self._link_cache,
                                   "fedml_comm_send_bytes_total",
                                   msg.sender_id, msg.receiver_id
                                   ).inc(nbytes)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        # idempotent: teardown paths (actor finish + test fixture cleanup)
        # may both remove; the second call is a no-op, not a ValueError
        if observer in self._observers:
            self._observers.remove(observer)

    def _notify(self, msg: Message) -> None:
        if self._reg.enabled:
            telemetry.link_counter(self._reg, self._link_cache,
                                   "fedml_comm_recv_total",
                                   msg.sender_id, msg.receiver_id).inc()
        for obs in self._observers:
            obs.receive_message(msg.type, msg)

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        """Deliver msg to msg.receiver_id (asynchronously)."""

    def send_many(self, messages: list) -> None:
        """Deliver a fan-out built by `message.build_fanout`: N messages
        sharing ONE already-serialized payload (`SharedPayload`), so the
        expensive model-bytes encode ran exactly once no matter how many
        silos the broadcast reaches.

        The default delegates to ``send_message`` per receiver — which is
        the correct semantics for every flavor AND every wrapper:
        `ResilientTransport` queues/retries each link independently,
        `ChaosTransport` draws each link's fault schedule exactly as for
        a single send (replay seeds stay valid), and wire transports'
        ``to_bytes`` transparently reuses the shared block.  Override
        only to exploit a wire that can address multiple receivers in
        one operation."""
        for msg in messages:
            self.send_message(msg)

    @abc.abstractmethod
    def run(self) -> None:
        """Block dispatching inbound messages to observers until stopped."""

    @abc.abstractmethod
    def stop(self) -> None:
        """Unblock run() and release resources.  Implementations MUST be
        idempotent: overlapping teardown paths (straggler-policy abort,
        actor ``finish()``, test fixtures) may each call ``stop()``."""
