"""Deterministic, seeded fault injection for any Transport flavor.

The port's copy of ``fedml_tpu/comm/chaos.py``.  A `ChaosTransport` wraps
any transport (the hub, gRPC, MQTT or a `ResilientTransport` stack) and
perturbs its SEND path according to a seeded `ChaosPlan`:

* **drop** — the message vanishes;
* **delay** — delivery is deferred by a bounded random time (a daemon
  timer re-sends through the inner transport);
* **duplicate** — the message is delivered twice;
* **reorder** — the message is held back and released after the NEXT
  send on the same link (bounded by a flush timer);
* **partition** — all matching traffic on a link is dropped, for a
  wall-clock window (``window_s``) or from a round tag onward
  (``after_round``, a silo death);
* **corrupt** — one array leaf of ``ARG_MODEL_PARAMS`` gets a NaN or a
  flipped byte (seeded leaf, mode and position); the frame still
  delivers, for the admission screens to catch.  The original message is
  never mutated (copy-on-corrupt), and the damage is done to the wire's
  numpy leaves, never to a device tensor.

Determinism: every fault decision comes from a per-link
``np.random.RandomState`` derived from ``(plan.seed, src, dst)`` — the
JAX package's streams — drawn under a lock, one fixed-size draw per
message in send order, so a seeded plan makes the same decisions in both
packages over the same message sequence.  When several threads send on
one link (event loop + heartbeat) the draws follow the actual send
interleaving.

Message types in ``immune_types`` bypass every fault (FINISH, so event
loops always shut down).  ``stop()`` cancels the delay and flush timers
and joins their threads (the JAX package only cancels them), so none
outlives the transport.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry


@dataclasses.dataclass
class Partition:
    """A one-directional link cut.

    ``after_round``: drop messages whose round tag (Message.ARG_ROUND)
    is >= this value — models a silo that dies at a known round.
    ``until_round``: upper bound for ``after_round`` — cut only rounds
    in ``[after_round, until_round)``, modelling a transient split that
    heals at a KNOWN round.  Round-space windows are deterministic under
    chaos-induced wall-time variance (a wall-clock ``window_s`` can
    drift past the rounds it meant to hit when an earlier round stalls).
    ``window_s``: (start, end) seconds relative to ChaosTransport
    creation — models a transient mid-round network split.  A message
    is cut if it matches EITHER active criterion.
    """
    after_round: Optional[int] = None
    until_round: Optional[int] = None
    window_s: Optional[Tuple[float, float]] = None

    def cuts(self, msg: Message, elapsed_s: float) -> bool:
        if self.after_round is not None:
            r = msg.get(Message.ARG_ROUND)
            if r is not None and r >= self.after_round and (
                    self.until_round is None or r < self.until_round):
                return True
        if self.window_s is not None:
            t0, t1 = self.window_s
            if t0 <= elapsed_s < t1:
                return True
        return False


@dataclasses.dataclass
class LinkChaos:
    """Per-link fault probabilities and schedules (all default to off)."""
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    max_delay_s: float = 0.0
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    corrupt_prob: float = 0.0
    partition: Optional[Partition] = None

    @property
    def quiet(self) -> bool:
        return (self.drop_prob == 0 and self.delay_prob == 0
                and self.dup_prob == 0 and self.reorder_prob == 0
                and self.corrupt_prob == 0 and self.partition is None)


class ChaosPlan:
    """Seeded fault schedule: a default `LinkChaos` plus per-link
    overrides keyed by ``(sender_id, receiver_id)``.

    ``links[(src, dst)] = LinkChaos(...)`` overrides the default for
    that directed link — set a quiet ``LinkChaos()`` to exempt a link
    (e.g. keep one silo immortal so a quorum always exists).
    """

    def __init__(self, seed: int = 0,
                 default: Optional[LinkChaos] = None,
                 links: Optional[Dict[Tuple[int, int], LinkChaos]] = None,
                 immune_types: tuple = ()):
        self.seed = int(seed)
        self.default = default if default is not None else LinkChaos()
        self.links = dict(links or {})
        self.immune_types = tuple(immune_types)

    def link(self, src: int, dst: int) -> LinkChaos:
        return self.links.get((src, dst), self.default)

    def rng_for(self, src: int, dst: int):
        import numpy as np
        # stable per-link stream: independent of call order across links
        mix = (self.seed * 1_000_003 + (src + 1) * 10_007
               + (dst + 1) * 101) % (2 ** 32)
        return np.random.RandomState(mix)


def _array_leaves(tree, out):
    """Collect non-empty array leaves of the dict/list/tuple nests the
    wire codec carries (depth-first, key-sorted — a stable enumeration
    so the seeded leaf choice is reproducible)."""
    if hasattr(tree, "items"):
        for _, v in sorted(tree.items()):
            _array_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _array_leaves(v, out)
    elif hasattr(tree, "dtype") and hasattr(tree, "shape"):
        if np.asarray(tree).size > 0:
            out.append(tree)
    return out


def _corrupt_payload(msg: Message, u_leaf: float, u_mode: float,
                     u_pos: float) -> Optional[Message]:
    """A copy of ``msg`` with one ARG_MODEL_PARAMS leaf damaged: NaN
    injection into a float leaf (``u_mode < 0.5``) or a raw byte
    bit-flip.  Returns None when the message carries no array payload.
    The original message (and its arrays, possibly shared with sender
    state on an in-process hub) is never touched."""
    tree = msg.get(Message.ARG_MODEL_PARAMS)
    if tree is None:
        return None
    leaves = _array_leaves(tree, [])
    if not leaves:
        return None
    target = min(int(u_leaf * len(leaves)), len(leaves) - 1)
    idx = [0]

    def _rebuild(t):
        if hasattr(t, "items"):
            return {k: _rebuild(v) for k, v in sorted(t.items())}
        if isinstance(t, (list, tuple)):
            out = [_rebuild(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        if hasattr(t, "dtype") and hasattr(t, "shape") \
                and np.asarray(t).size > 0:
            i, idx[0] = idx[0], idx[0] + 1
            if i != target:
                return t
            arr = np.array(t, copy=True)
            if u_mode < 0.5 and np.issubdtype(arr.dtype, np.floating):
                arr.flat[min(int(u_pos * arr.size), arr.size - 1)] = np.nan
            else:
                raw = bytearray(arr.tobytes())
                raw[min(int(u_pos * len(raw)), len(raw) - 1)] ^= 0xFF
                arr = np.frombuffer(bytes(raw), dtype=arr.dtype) \
                    .reshape(arr.shape).copy()
            return arr
        return t

    out = Message(msg.type, msg.sender_id, msg.receiver_id)
    out.params = dict(msg.params)
    out.params[Message.ARG_MODEL_PARAMS] = _rebuild(tree)
    return out


class ChaosTransport(Transport):
    """Wrap ``inner``; apply the plan's faults to outgoing messages.

    Observer registration and the receive loop pass through to the
    inner transport untouched — chaos lives on the wire, not in the
    dispatcher, so the same wrapper composes with every flavor.
    """

    def __init__(self, inner: Transport, plan: ChaosPlan):
        # no super().__init__(): observers belong to the inner transport
        self.inner = inner
        self.plan = plan
        self._t0 = time.monotonic()
        self._rngs: Dict[Tuple[int, int], object] = {}
        self._held: Dict[Tuple[int, int], Message] = {}  # reorder buffer
        self._timers: list = []
        self._lock = threading.Lock()
        self._stopped = False
        # fault kind -> count, for assertions ("chaos actually happened")
        self.faults: Dict[str, int] = {
            "drop": 0, "delay": 0, "dup": 0, "reorder": 0, "partition": 0,
            "corrupt": 0}
        # telemetry mirror, one labeled counter per kind (null no-ops when
        # telemetry is disabled); handles are pre-built so the fault path
        # never allocates
        reg = telemetry.get_registry()
        self._m_faults = {k: reg.counter("fedml_chaos_faults_total", kind=k)
                          for k in self.faults}

    def _fault(self, kind: str) -> None:
        self.faults[kind] += 1
        self._m_faults[kind].inc()

    # -- observer passthrough ------------------------------------------------
    def add_observer(self, observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer) -> None:
        self.inner.remove_observer(observer)

    # -- fault pipeline ------------------------------------------------------
    def _rng(self, src: int, dst: int):
        key = (src, dst)
        if key not in self._rngs:
            self._rngs[key] = self.plan.rng_for(src, dst)
        return self._rngs[key]

    def _deliver(self, msg: Message) -> None:
        if not self._stopped:
            self.inner.send_message(msg)

    def _after(self, delay_s: float, fn, *args) -> None:
        t = threading.Timer(delay_s, fn, args=args)
        t.daemon = True
        with self._lock:
            if self._stopped:   # a send racing stop(): nothing to deliver
                return
            self._timers = [x for x in self._timers if x.is_alive()]
            self._timers.append(t)
            t.start()

    def _flush_held(self, key: Tuple[int, int]) -> None:
        with self._lock:
            held = self._held.pop(key, None)
        if held is not None:
            self._deliver(held)

    # send_many (inherited): each fan-out sibling passes through here on
    # its own link, drawing the same per-link fixed-size schedule as a
    # single send — historical chaos seeds replay unchanged.  A corrupted
    # sibling is REBUILT by _corrupt_payload as a fresh Message with no
    # shared-payload attachment, so its damaged frame re-encodes privately
    # and can never leak into a sibling's copy of the shared block.

    def send_message(self, msg: Message) -> None:
        if msg.type in self.plan.immune_types:
            self._deliver(msg)
            return
        src, dst = msg.sender_id, msg.receiver_id
        link = self.plan.link(src, dst)
        if link.quiet:
            self._deliver(msg)
            return
        elapsed = time.monotonic() - self._t0
        if link.partition is not None and link.partition.cuts(msg, elapsed):
            self._fault("partition")
            return
        # one fixed-size draw per message keeps the per-link stream
        # deterministic even when probabilities differ between links; the
        # draw happens under the lock because two sender threads (event
        # loop + heartbeat) can share a link and RandomState is not
        # thread-safe.  Links with corruption enabled draw 4 extra
        # uniforms (gate, leaf, mode, position) — still per-link
        # fixed-size, and corruption-free links keep the historical
        # 5-draw stream.
        with self._lock:
            u = self._rng(src, dst).uniform(
                size=9 if link.corrupt_prob > 0 else 5)
        u_drop, u_delay, u_dup, u_reorder, u_t = u[:5]
        if u_drop < link.drop_prob:
            self._fault("drop")
            return
        if link.corrupt_prob > 0 and u[5] < link.corrupt_prob:
            corrupted = _corrupt_payload(msg, u[6], u[7], u[8])
            if corrupted is not None:  # no array payload: nothing to damage
                msg = corrupted
                self._fault("corrupt")
        with self._lock:
            held = self._held.pop((src, dst), None)
        if u_reorder < link.reorder_prob:
            # hold this message; it rides AFTER the next send on the link
            # (or after a flush timeout so it cannot be held forever)
            self._fault("reorder")
            with self._lock:
                self._held[(src, dst)] = msg
            self._after(max(link.max_delay_s, 0.05),
                        self._flush_held, (src, dst))
        elif u_delay < link.delay_prob:
            self._fault("delay")
            self._after(float(u_t) * link.max_delay_s, self._deliver, msg)
        else:
            self._deliver(msg)
        if u_dup < link.dup_prob:
            self._fault("dup")
            self._deliver(msg)
        if held is not None:  # release the previously held message last
            self._deliver(held)

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> None:
        self.inner.run()

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            timers, self._timers = self._timers, []
            held = list(self._held.values())
            self._held.clear()
        for t in timers:
            t.cancel()
        for t in timers:  # a cancelled timer thread still has to exit
            if t is not threading.current_thread():
                t.join(timeout=1)
        for msg in held:  # do not strand a reordered message at shutdown
            self.inner.send_message(msg)
        self.inner.stop()
