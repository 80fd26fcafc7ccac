"""Distributed round tracing: spans whose context rides Message headers.

The port's copy of ``fedml_tpu/obs/trace.py`` (stdlib only, the same
ids, header key and export format, so a federation mixing JAX and port
nodes stitches one trace).  Without it there is no way to see WHERE a
federated round spends its time: a stalled round could be a dead silo, a
retry storm, or a first-call kernel build.  This tracer stitches one
round into a single cross-process trace — server ``round`` span →
``broadcast`` → per-silo ``recv``/``train``/``upload`` → server
``aggregate`` — by carrying ``(trace_id, span_id)`` in a reserved plain
header key of every `Message` (`CTX_KEY`, mirrored as
``Message.ARG_TRACE``).  Export is Chrome/Perfetto ``trace_event`` JSON
(one file per process; `obs/report.py` merges them), viewable in
``ui.perfetto.dev`` alongside the ``torch.profiler`` Chrome trace
``--profile_dir`` captures.

Cost contract: tracing is a process-global opt-in (`enable()`); when
disabled ``get_tracer()`` is ``None`` and instrumented paths pay exactly
one branch per message, no allocations, no threads.

Duplicate tolerance: a chaotic wire can deliver one frame twice.  Spans
created with ``deterministic=True`` derive their span id from
``(trace_id, parent_id, name, node)``, and the tracer records the FIRST
span per id — so a duplicated delivery collapses to one span instead of
forking the trace.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Optional

# the Message param key trace context travels under (a plain {"t","s"}
# dict, so it rides the JSON header of the binary codec untouched).
# comm/message.py mirrors this as Message.ARG_TRACE — kept literal here
# so this module stays import-cycle-free (stdlib only).
CTX_KEY = "_trace"

# the ONE null context instrumented call sites reuse when tracing is
# disabled: nullcontext is reentrant and stateless, so sharing a single
# instance makes the disabled path literally allocation-free (the
# zero-allocation pin in tests/test_torch_obs_trace.py holds it to that)
NULL_CONTEXT = contextlib.nullcontext()

_USE_CURRENT = object()  # start_span default: parent = the active span
_tracer_ids = itertools.count()


class SpanContext:
    """The propagated identity of a span: (trace_id, span_id), plus —
    when extracted from a message — the unique id ``inject()`` stamped on
    that SEND.  The msg_id is what separates "the wire duplicated one
    frame" (same msg_id → recv spans dedupe) from "two messages rode the
    same parent span" (distinct msg_ids → distinct spans)."""
    __slots__ = ("trace_id", "span_id", "msg_id")

    def __init__(self, trace_id: str, span_id: str,
                 msg_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.msg_id = msg_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id}, {self.msg_id})"


class Span:
    """One timed operation.  ``end()`` records it (idempotent)."""
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "node",
                 "args", "t0", "tid", "_tracer", "_ended")

    def __init__(self, tracer: "SpanTracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], node, args: dict,
                 t0: float):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.node = node
        self.args = args
        self.t0 = t0
        self.tid = threading.get_ident()
        self._tracer = tracer
        self._ended = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self._tracer._record(self, self._tracer._clock() - self.t0)


class SpanTracer:
    """Collects spans; exports Chrome ``trace_event`` JSON.

    ``node`` labels spans that don't pass their own (in-process actors
    pass their node id per span, so one tracer serves a whole local
    federation).  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, node="proc0", clock=time.time):
        self.node = node
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: dict = {}              # span_id -> record (first wins)
        self._order: list = []              # span ids in record order
        self._seq = itertools.count()
        self._local = threading.local()
        # per-tracer nonce keeps generated ids unique across processes
        # (grpc silos) and across tracer instances within one process
        self._nonce = f"{os.getpid():x}.{next(_tracer_ids)}"

    # -- id generation -------------------------------------------------------
    def new_trace_id(self, hint: str = "") -> str:
        return f"{self._nonce}-{hint or next(self._seq)}"

    # -- current-span stack (thread-local) -----------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_context(self) -> Optional[SpanContext]:
        stack = self._stack()
        return stack[-1].context if stack else None

    # -- span lifecycle ------------------------------------------------------
    def start_span(self, name: str, parent=_USE_CURRENT,
                   trace_id: Optional[str] = None, node=None,
                   span_id: Optional[str] = None, deterministic: bool = False,
                   **args) -> Span:
        """``parent`` accepts a Span, a SpanContext, or None (root); the
        default is the thread's active span.  ``deterministic=True``
        derives the span id from (trace_id, parent, name, node) so a
        duplicated message re-handled on the same node dedupes."""
        if parent is _USE_CURRENT:
            parent = self.current_context()
        elif isinstance(parent, Span):
            parent = parent.context
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None \
                else self.new_trace_id()
        parent_id = parent.span_id if parent is not None else None
        if node is None:
            node = self.node
        if span_id is None:
            if deterministic:
                # include the parent context's message id (present when
                # the parent was extracted off a wire message): dedupes
                # duplicated deliveries of ONE frame without collapsing
                # distinct frames that share a parent span
                msg_id = getattr(parent, "msg_id", None) or ""
                span_id = deterministic_span_id(
                    trace_id, parent_id or "", msg_id, name, str(node))
            else:
                span_id = f"{self._nonce}.{next(self._seq)}"
        return Span(self, name, trace_id, span_id, parent_id, node, args,
                    self._clock())

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        """Start a span, make it the thread's current (so sends inside it
        propagate its context), end it on exit."""
        sp = self.start_span(name, **kw)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            sp.end()

    def record_span(self, name: str, dur_s: float,
                    t0: Optional[float] = None, parent=None,
                    trace_id: Optional[str] = None, node=None,
                    **args) -> None:
        """Record an already-finished span retroactively: the hot-path
        form for schedulers that know a phase's duration only after it
        ran (serve queue wait, batch execution, decode steps) — one call
        per event, no context-manager entry on the critical path.
        ``t0`` defaults to ``now - dur_s`` on this tracer's clock; pass
        a Span/SpanContext as ``parent`` to hang it under a request."""
        if isinstance(parent, Span):
            parent = parent.context
        if t0 is None:
            t0 = self._clock() - dur_s
        sp = self.start_span(name, parent=parent, trace_id=trace_id,
                             node=node, **args)
        sp.t0 = t0
        sp._ended = True
        self._record(sp, dur_s)

    def _record(self, span: Span, dur_s: float) -> None:
        rec = {"name": span.name, "trace_id": span.trace_id,
               "span_id": span.span_id, "parent_id": span.parent_id,
               "node": span.node, "ts": span.t0, "dur": dur_s,
               "tid": span.tid, "args": span.args}
        with self._lock:
            if span.span_id not in self._spans:   # dedupe: first wins
                self._spans[span.span_id] = rec
                self._order.append(span.span_id)

    # -- export --------------------------------------------------------------
    @property
    def spans(self) -> list:
        """Recorded span dicts, in record order (test/report surface)."""
        with self._lock:
            return [dict(self._spans[i]) for i in self._order]

    def to_trace_events(self) -> list:
        """Chrome ``trace_event`` list: one complete ("X") event per span
        plus ``process_name`` metadata naming each node's track."""
        events, nodes = [], {}
        for rec in self.spans:
            pid = _node_pid(rec["node"])
            nodes.setdefault(pid, rec["node"])
            events.append({
                "name": rec["name"], "cat": "fedml", "ph": "X",
                "ts": int(rec["ts"] * 1e6), "dur": int(rec["dur"] * 1e6),
                "pid": pid, "tid": rec["tid"] % 1_000_000,
                "args": {"trace_id": rec["trace_id"],
                         "span_id": rec["span_id"],
                         "parent_id": rec["parent_id"],
                         "node": str(rec["node"]), **rec["args"]}})
        for pid, node in sorted(nodes.items()):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"node {node}"}})
        return events

    def export(self, path: str) -> None:
        """Write ``{"traceEvents": [...]}`` atomically (tmp + replace)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": self.to_trace_events(),
                       "displayTimeUnit": "ms"}, f)
        os.replace(tmp, path)


def _node_pid(node) -> int:
    """Stable small integer per node label (Perfetto tracks are per-pid)."""
    try:
        return int(node)
    except (TypeError, ValueError):
        digest = hashlib.blake2s(str(node).encode(), digest_size=2).digest()
        return 1000 + int.from_bytes(digest, "big")


def deterministic_span_id(*parts: str) -> str:
    return hashlib.blake2s("|".join(parts).encode(),
                           digest_size=8).hexdigest()


# -- Message header propagation ---------------------------------------------

_msg_seq = itertools.count()


def inject(msg, ctx: SpanContext) -> None:
    """Attach ``ctx`` to an outgoing message (plain JSON-header param),
    stamping a unique per-send message id: a chaotic wire can deliver
    this one frame twice, and the id is how the receiver's span dedupe
    tells that apart from two genuinely distinct sends."""
    msg.add(CTX_KEY, {"t": ctx.trace_id, "s": ctx.span_id,
                      "m": f"{os.getpid():x}.{next(_msg_seq)}"})


def extract(msg) -> Optional[SpanContext]:
    """Read the propagated context off an inbound message, if any."""
    d = msg.get(CTX_KEY)
    if isinstance(d, dict) and "t" in d and "s" in d:
        return SpanContext(d["t"], d["s"], d.get("m"))
    return None


# -- process-global tracer ---------------------------------------------------

_tracer: Optional[SpanTracer] = None


def get_tracer() -> Optional[SpanTracer]:
    """``None`` unless `enable()` ran — instrumented paths branch on
    exactly this."""
    return _tracer


def enable(node="proc0", clock=time.time) -> SpanTracer:
    global _tracer
    if _tracer is None:
        _tracer = SpanTracer(node=node, clock=clock)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None
