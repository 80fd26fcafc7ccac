"""Retry / backoff / dead-letter decorator for wire transports.

The port's copy of ``fedml_tpu/comm/resilient.py``.  `ResilientTransport`
wraps any `Transport`:

* **bounded in-flight queue** — ``send_message`` enqueues and returns; one
  daemon sender thread drains in FIFO order (per-sender order kept); a
  full queue dead-letters the message instead of blocking;
* **retries with exponential backoff and seeded jitter** — attempt ``k``
  waits ``base_backoff_s * mult**k`` (capped at ``max_backoff_s``) times a
  factor in ``[1-jitter, 1+jitter]`` drawn from
  ``np.random.RandomState(seed)``;
* **per-send deadline** — ``send_deadline_s`` bounds all attempts and
  backoffs of one message;
* **reconnection** — between attempts the inner transport's
  ``reconnect()`` runs when it has one (gRPC re-dials, MQTT re-runs
  CONNECT/SUBSCRIBE);
* **dead letters** — ``on_dead_letter(msg, exc)`` (default: log) and
  ``fault_feed(reason, msg)``, counted in
  ``fedml_comm_dead_letter_total{reason=...}``.

``ResilientTransport(ChaosTransport(inner))`` retries through injected
faults (chaos drops are silent, so only transport errors retry);
``ChaosTransport(ResilientTransport(inner))`` injects faults the retry
layer never sees.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

_STOP = object()


class SendDeadlineExceeded(RuntimeError):
    """Raised (into the dead-letter path) when a send's total retry
    budget is exhausted."""


class SendQueueFull(RuntimeError):
    """Raised (into the dead-letter path) when the bounded in-flight
    queue rejects a message."""


@dataclasses.dataclass
class RetryPolicy:
    """Backoff schedule for one message."""
    max_attempts: int = 5
    base_backoff_s: float = 0.05
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter_frac: float = 0.2            # each backoff scaled by U[1-j, 1+j]
    send_deadline_s: Optional[float] = 30.0  # total budget per message

    def backoff(self, attempt: int, rng) -> float:
        raw = min(self.base_backoff_s * self.backoff_multiplier ** attempt,
                  self.max_backoff_s)
        if self.jitter_frac <= 0:
            return raw
        lo, hi = 1.0 - self.jitter_frac, 1.0 + self.jitter_frac
        return raw * float(rng.uniform(lo, hi))


class ResilientTransport(Transport):
    """Decorate ``inner`` with queued, retried, dead-lettered sends."""

    def __init__(self, inner: Transport, policy: Optional[RetryPolicy] = None,
                 max_in_flight: int = 256,
                 on_dead_letter: Optional[
                     Callable[[Message, Exception], None]] = None,
                 seed: int = 0,
                 fault_feed: Optional[Callable[[str, Message], None]] = None):
        # no super().__init__(): observers belong to the inner transport
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        self.on_dead_letter = on_dead_letter
        # fault_feed(reason, msg): the reliability tracker's attribution
        # feed (robust/degrade) — ALWAYS called on a dead letter, in
        # addition to on_dead_letter/log, so dead letters classify as
        # network faults (partition evidence, never a trust strike) even
        # when a caller installed its own drop handler
        self.fault_feed = fault_feed
        self._rng = np.random.RandomState(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_in_flight)
        self._stopped = False
        self.sent_ok = 0
        self.retries = 0
        self.dead_letters = 0
        # telemetry mirrors of the attribute counters above (null no-ops
        # when telemetry is disabled); _m_retry increments exactly once
        # per retried attempt, in lockstep with self.retries
        reg = telemetry.get_registry()
        self._m_ok = reg.counter("fedml_comm_send_ok_total")
        self._m_retry = reg.counter("fedml_comm_send_retries_total")
        # fedml_comm_dead_letter_total{reason} registers lazily on the
        # first dead letter of each reason: a healthy run exports no
        # dead-letter series at all (no fabricated zeros)
        self._m_dead_by_reason: dict = {}
        self._sender = threading.Thread(target=self._drain, daemon=True,
                                        name="resilient-sender")
        self._sender.start()

    # -- observer passthrough ------------------------------------------------
    def add_observer(self, observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer) -> None:
        self.inner.remove_observer(observer)

    # -- send path -----------------------------------------------------------
    # send_many (inherited): each fan-out sibling is enqueued as its own
    # message, so per-link retry/backoff/dead-letter semantics are exactly
    # the single-send ones — one silo's flaky channel retries alone while
    # its siblings proceed.  The shared payload rides every sibling as an
    # already-encoded block, so retries never re-serialize the model bytes.

    def send_message(self, msg: Message) -> None:
        if self._stopped:
            # the sender thread is gone; an enqueue would vanish silently —
            # surface it like every other terminal send failure
            self._dead_letter(msg, RuntimeError(
                f"transport stopped; dropping {msg!r}"))
            return
        try:
            self._queue.put_nowait(msg)
        except queue.Full:
            self._dead_letter(msg, SendQueueFull(
                f"in-flight queue full ({self._queue.maxsize}); "
                f"dropping {msg!r}"))

    @staticmethod
    def _dead_letter_reason(exc: Exception) -> str:
        """The dead letter's labeled reason — a closed, low-cardinality
        set (each reason is one labeled series)."""
        if isinstance(exc, SendDeadlineExceeded):
            return "deadline"
        if isinstance(exc, SendQueueFull):
            return "queue_full"
        if isinstance(exc, RuntimeError) and "transport stopped" in str(exc):
            return "stopped"
        return "send_failed"

    def _dead_letter(self, msg: Message, exc: Exception) -> None:
        self.dead_letters += 1
        reason = self._dead_letter_reason(exc)
        c = self._m_dead_by_reason.get(reason)
        if c is None:
            c = telemetry.get_registry().counter(
                "fedml_comm_dead_letter_total", reason=reason)
            self._m_dead_by_reason[reason] = c
        c.inc()
        if self.fault_feed is not None:
            try:
                self.fault_feed(reason, msg)
            except Exception:  # noqa: BLE001 — attribution must not kill
                log.exception("dead-letter fault_feed raised")
        if self.on_dead_letter is not None:
            self.on_dead_letter(msg, exc)
        else:
            log.error("dead-lettering %r: %s", msg, exc)

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            self._send_with_retries(item)

    def _send_with_retries(self, msg: Message) -> None:
        deadline = (None if self.policy.send_deadline_s is None
                    else time.monotonic() + self.policy.send_deadline_s)
        last_exc: Optional[Exception] = None
        deadline_hit = False
        for attempt in range(self.policy.max_attempts):
            if self._stopped and attempt > 0:
                # graceful drain: a message already queued at stop() still
                # gets its FIRST attempt (a FINISH broadcast precedes the
                # server's own stop), but no backoff-retry loop may outlive
                # the transport
                return
            try:
                self.inner.send_message(msg)
                self.sent_ok += 1
                self._m_ok.inc()
                return
            except Exception as exc:  # noqa: BLE001 — any wire error retries
                if self._stopped:
                    return  # shutdown drain: one attempt, no backoff
                last_exc = exc
                if attempt + 1 >= self.policy.max_attempts:
                    break  # terminal attempt: no backoff/reconnect to pay
                pause = self.policy.backoff(attempt, self._rng)
                if deadline is not None and \
                        time.monotonic() + pause > deadline:
                    deadline_hit = True  # budget gone before the next try
                    break
                log.warning("send attempt %d/%d failed (%s); retrying in "
                            "%.3fs", attempt + 1, self.policy.max_attempts,
                            exc, pause)
                self.retries += 1
                self._m_retry.inc()
                time.sleep(pause)
                reconnect = getattr(self.inner, "reconnect", None)
                if reconnect is not None:
                    try:
                        reconnect()
                    except Exception as rexc:  # noqa: BLE001
                        log.warning("reconnect failed: %s", rexc)
        if deadline_hit and last_exc is not None:
            last_exc = SendDeadlineExceeded(
                f"{self.policy.send_deadline_s}s send budget exhausted "
                f"(last error: {last_exc})")
        self._dead_letter(msg, last_exc if last_exc is not None
                          else RuntimeError("send failed"))

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> None:
        self.inner.run()

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._queue.put(_STOP)
        self._sender.join(timeout=5)
        self.inner.stop()
