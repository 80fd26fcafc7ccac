"""Actor layer: handler-registry node managers for cross-silo federation.

The port's copy of ``fedml_tpu/comm/actors.py`` (the reference's
``ClientManager`` and ``ServerManager``: an event loop plus a
message-type → handler registry, over an injected transport).

Tracing (``obs/trace.py``): with the process tracer enabled, a send
inside an active span stamps its context under the ``_trace`` header
param (JAX's ``{"t", "s", "m"}``), and an inbound message carrying one is
handled under a ``recv:<type>`` child span with a deterministic id, so a
federation of JAX and port nodes stitches one trace.  Disabled, every
path is one branch and the frames are byte-equal to JAX's.
"""

from __future__ import annotations

import abc
import logging
import threading
from typing import Callable, Dict

from fedml_tpu_torch.comm.message import Message, build_fanout
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry, trace

log = logging.getLogger(__name__)


class SelfMessageTimer:
    """One-shot daemon timer for actor watchdogs (the straggler timeout).

    The callback is expected to ENQUEUE a self-message so all policy
    logic stays single-threaded on the transport's event loop:

    * re-``arm()`` cancels the previous timer first;
    * ``cancel(join=True)`` (the finish/abort path) joins every timer
      thread still exiting its wait, so no timer outlives the federation,
      and permanently closes the timer — a fire racing the teardown is
      suppressed, and send errors from a mid-shutdown transport are
      swallowed.
    """

    def __init__(self):
        self._timer: threading.Timer | None = None
        self._spent: list = []  # cancelled, possibly still exiting
        self._closed = False

    @property
    def pending(self) -> bool:
        return self._timer is not None

    def arm(self, delay_s: float, fire: Callable[[], None]) -> None:
        self.cancel()
        if self._closed:
            return

        def wrapped():
            if self._closed:
                return
            try:
                fire()
            except Exception:  # noqa: BLE001 — transport mid-shutdown
                pass

        timer = threading.Timer(delay_s, wrapped)
        timer.daemon = True
        self._timer = timer
        timer.start()

    def cancel(self, join: bool = False) -> None:
        timer = self._timer
        if timer is not None:
            self._timer = None
            timer.cancel()
            # a cancelled Timer thread still takes a beat to exit its
            # wait; remember it so the join pass can reap every one
            self._spent = [t for t in self._spent if t.is_alive()]
            self._spent.append(timer)
        if join:
            self._closed = True
            for t in self._spent:
                if t is not threading.current_thread():
                    t.join(timeout=5)
            self._spent = [t for t in self._spent if t.is_alive()]


class NodeManager(abc.ABC):
    """Event-loop node with a message-type → handler registry.

    Tracing: when the process tracer is enabled, every ``send()`` inside
    an active span stamps the span's context onto the message, and every
    inbound message CARRYING a context is handled under a
    ``recv:<type>`` child span — one federated round stitches into a
    single cross-node trace with no per-algorithm code.  Handler spans
    use deterministic ids, so a chaotic wire delivering a frame twice
    collapses to one span.  Disabled (``_tracer is None``) both paths are
    a single branch."""

    def __init__(self, node_id: int, transport: Transport):
        self.node_id = node_id
        self.transport = transport
        self.transport.add_observer(self)
        self._handlers: Dict[object, Callable[[Message], None]] = {}
        self._tracer = trace.get_tracer()
        self._m_fanout = telemetry.get_registry().counter(
            "fedml_wire_fanout_total")

    def _span(self, name: str, **kw):
        """A span context-manager on this node's track, or the SHARED
        null context when tracing is disabled (the disabled branch
        allocates nothing)."""
        if self._tracer is None:
            return trace.NULL_CONTEXT
        return self._tracer.span(name, node=self.node_id, **kw)

    def _root_span(self, name: str, hint: str = "", **kw):
        """Like `_span` but starts a NEW trace (ignores any active span)
        — for the spans that root a round/version/re-task tree."""
        if self._tracer is None:
            return trace.NULL_CONTEXT
        return self._tracer.span(
            name, parent=None, node=self.node_id,
            trace_id=self._tracer.new_trace_id(hint or name), **kw)

    def register_handler(self, msg_type, fn: Callable[[Message], None]) -> None:
        self._handlers[msg_type] = fn

    @abc.abstractmethod
    def register_handlers(self) -> None:
        """Subclasses register their message handlers here."""

    def receive_message(self, msg_type, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            log.warning("node %d: no handler for message type %r",
                        self.node_id, msg_type)
            return
        if self._tracer is not None:
            ctx = trace.extract(msg)
            if ctx is not None:
                # deterministic id: a duplicated delivery of the same frame
                # re-runs the handler but records only one span
                with self._tracer.span(f"recv:{msg_type}", parent=ctx,
                                       node=self.node_id,
                                       deterministic=True):
                    handler(msg)
                return
        handler(msg)

    def run(self) -> None:
        self.register_handlers()
        self.transport.run()

    def send(self, msg_type, receiver_id: int, **params) -> None:
        msg = Message(msg_type, self.node_id, receiver_id)
        for k, v in params.items():
            msg.add(k, v)
        if self._tracer is not None:
            ctx = self._tracer.current_context()
            if ctx is not None:
                trace.inject(msg, ctx)
        self.transport.send_message(msg)

    def send_many(self, msg_type, receivers, shared_params=None,
                  per_receiver_params=None) -> None:
        """Encode-once fan-out: serialize ``shared_params`` a single time
        and deliver one message per receiver, varying only the small
        per-receiver header (``per_receiver_params[r]``).  The trace
        context rides each receiver's own header."""
        messages = build_fanout(msg_type, self.node_id, receivers,
                                shared_params, per_receiver_params)
        if self._tracer is not None:
            ctx = self._tracer.current_context()
            if ctx is not None:
                for msg in messages:
                    trace.inject(msg, ctx)
        self._m_fanout.inc(len(messages))
        self.transport.send_many(messages)

    def finish(self) -> None:
        self.transport.stop()


class ClientManager(NodeManager):
    """Cross-silo client actor (reference ClientManager)."""


class ServerManager(NodeManager):
    """Cross-silo server actor (reference ServerManager)."""

    #: optional `obs.perf.PerfRecorder` — subclasses accepting a ``perf=``
    #: parameter assign it; `_perf_phase` is the shared span helper
    perf = None

    def _perf_phase(self, name: str):
        """Flight-recorder phase span (the shared null context when no
        recorder — one branch, zero allocations)."""
        if self.perf is not None:
            return self.perf.phase(name)
        return trace.NULL_CONTEXT

    def _note_arrival(self) -> None:
        """Stamp one upload arrival on the round's critical-path
        timeline (one branch when the recorder is off)."""
        if self.perf is not None:
            self.perf.note_arrival()
