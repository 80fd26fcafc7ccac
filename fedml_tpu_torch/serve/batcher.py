"""Dynamic micro-batching with power-of-two shape buckets (port of
``fedml_tpu/serve/batcher.py``).

Requests accumulate in a bounded queue until a SIZE trigger (the largest
bucket fills) or a DEADLINE trigger (the oldest request has waited
``max_delay_s``); the batch is padded up to a small fixed set of bucket
sizes and the per-request rows are scattered back.  The JAX package pads
so that each bucket compiles once; the port keeps the same buckets so a
batch's shape is one of a few (``warmup`` runs each once, paying the
allocator's and the library's first-call costs before traffic), and
padded rows stay invisible.  The forward runs on the registry's device
under ``torch.inference_mode()`` (`registry.ServedModel.predict`),
eagerly.

Overload handling is shed-don't-collapse: a full queue rejects at
``submit`` (HTTP 429 upstream), and a request whose deadline expired
while queued is shed at dequeue.  ``stop(drain=True)`` answers every
already-queued request, then the worker exits.

Admission tiers: every request carries a tier — ``interactive`` (the
default) or ``best_effort`` — and best-effort sheds first: at a SOFT
queue watermark (``best_effort_headroom`` of the depth) and, while a
`TierGate` over the `obs.perf.SloEvaluator` says an objective is
breaching, outright (reason ``slo_degraded``).  The gate reads the SAME
verdicts as ``/healthz?deep=1``, so shedding and deep health never
disagree.

Model consistency: the worker reads ONE `ServedModel` snapshot per batch,
so every row of a batch is served by the same (params, version).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence

import numpy as np

from fedml_tpu_torch.obs import telemetry, trace

log = logging.getLogger(__name__)

_STOP = object()

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)

TIERS = ("interactive", "best_effort")

SHED_REASONS = ("queue_full", "deadline", "shutdown", "no_model",
                "slo_degraded")


class ShedError(RuntimeError):
    """A request was rejected by admission control or load shedding.
    ``reason`` ∈ {queue_full, deadline, shutdown, no_model,
    slo_degraded} — the HTTP frontend maps it to 429 (503 for
    no_model)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def best_effort_cap(queue_depth: int,
                    headroom: float) -> Optional[int]:
    """The best-effort soft watermark: the queue fill beyond which only
    interactive traffic is admitted.  An UNBOUNDED queue (depth <= 0)
    has no fill fraction, so no watermark — None, never a degenerate
    cap of 1 that would blackhole best-effort under any load."""
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"best_effort_headroom must be in (0, 1], "
                         f"got {headroom}")
    return max(1, int(headroom * queue_depth)) if queue_depth > 0 \
        else None


class TierAdmission:
    """The tiered-admission state BOTH schedulers share (`MicroBatcher`
    and `DecodeScheduler`): the (reason × tier) shed counters — built by
    the OWNER so the metric-name literal stays in its module for the
    source-scan lint — the best-effort watermark, and the `TierGate`.
    One implementation, so a tier-policy fix can never silently apply
    to one queue and not the other."""
    __slots__ = ("gate", "be_cap", "counters")

    def __init__(self, counters: dict, slo, be_cap: Optional[int]):
        self.counters = counters
        self.gate = (slo if slo is None or hasattr(slo, "degraded")
                     else TierGate(slo))
        self.be_cap = be_cap

    def shed(self, reason: str, tier: str = "interactive") -> ShedError:
        """Count a shed by (reason, tier) and build its error."""
        self.counters[(reason, tier)].inc()
        return ShedError(reason)

    def screen(self, tier: str, qsize: int) -> None:
        """Pre-queue admission: validate the tier, and shed best-effort
        while an SLO breaches (slo_degraded) or past the watermark."""
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; expected one of "
                             f"{TIERS}")
        if tier == "best_effort":
            if self.gate is not None and self.gate.degraded():
                raise self.shed("slo_degraded", tier)
            if self.be_cap is not None and qsize >= self.be_cap:
                raise self.shed("queue_full", tier)


class TierGate:
    """The objective-state side of tiered admission: ``degraded()`` is
    True while any SLO is breaching, read from the SAME `SloEvaluator`
    that backs ``/healthz?deep=1`` — one source of truth, so a shed
    best-effort request and a 503 deep probe always tell the same story.

    The verdict is cached for ``ttl_s`` (an evaluate() walks a registry
    snapshot; at 10k req/s that must not run per request) and evaluated
    with ``count_breaches=False`` — admission probes, like LB probes,
    must not inflate the per-round breach counters."""

    def __init__(self, slo, ttl_s: float = 0.25):
        self.slo = slo
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._checked_at = -1e30
        self._healthy = True

    def degraded(self) -> bool:
        if self.slo is None:
            return False
        now = time.monotonic()
        refresh = False
        with self._lock:
            if now - self._checked_at >= self.ttl_s:
                # claim the refresh INSIDE the lock, evaluate OUTSIDE it:
                # the gate is shared across every pool worker, and an
                # evaluate() (a registry snapshot walk) under the lock
                # would serialize all concurrent best-effort submits for
                # its whole duration — a stale read during the refresh
                # window is harmless for an admission hint that already
                # accepts ttl_s of staleness
                self._checked_at = now
                refresh = True
        if refresh:
            try:
                healthy = all(
                    v["ok"] for v in
                    self.slo.evaluate(count_breaches=False).values())
            except Exception:  # noqa: BLE001 — a broken evaluator
                # must degrade to admit-everything, not crash submits
                log.exception("tier gate: SLO evaluation failed")
                healthy = True
            with self._lock:
                self._healthy = healthy
        with self._lock:
            return not self._healthy


class BadInstanceError(ValueError):
    """The REQUEST's payload is at fault (wrong sample shape) — the one
    prediction failure the HTTP frontend may map to 400; everything else
    is a server fault (500)."""


class PredictResult:
    """One request's answer: the output row and the model version that
    produced it (a torn-read probe pairs these)."""
    __slots__ = ("y", "version")

    def __init__(self, y, version: int):
        self.y = y
        self.version = version


def _settle(fut: Future, result=None, exc=None) -> None:
    """Resolve a future, tolerating a client that already cancelled it:
    set_result on a cancelled Future raises InvalidStateError, and one
    impatient caller must not kill the worker thread for everyone."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class _Request:
    __slots__ = ("x", "deadline", "enq_t", "future", "tier", "ctx")

    def __init__(self, x, deadline: Optional[float], enq_t: float,
                 future: Future, tier: str = "interactive", ctx=None):
        self.x = x
        self.deadline = deadline
        self.enq_t = enq_t
        self.future = future
        self.tier = tier
        self.ctx = ctx   # the submitter's span context (serve_request),
        #                  so queue-wait spans hang under their request


class MicroBatcher:
    """The request queue + batching worker thread.

    ``registry``: a `ModelRegistry` (or anything with ``current()``).
    ``buckets``: strictly-increasing batch-size buckets; the largest is
    the size trigger.  ``max_delay_s``: the deadline trigger — how long
    the OLDEST queued request may wait for batchmates.
    ``queue_depth``: bound on queued requests (admission control).
    ``default_deadline_s``: per-request deadline when submit passes none
    (None = no deadline, requests never shed once admitted).
    ``worker``: label value stamped on every metric series this batcher
    registers — the multi-worker pool names each worker's telemetry so
    one hot worker is visible, not averaged away.
    ``slo``: a `TierGate` (or an `SloEvaluator`, wrapped into one) —
    best-effort submits shed while an objective is breaching.
    ``best_effort_headroom``: fraction of the queue depth best-effort
    traffic may fill; beyond it only interactive requests are admitted.
    ``shadow``: a `serve.release.ShadowSampler` (or anything with
    ``offer(x)``) — every ADMITTED request's instance is offered so the
    release gate replays a deterministic slice of real traffic against
    each canary; pool workers share ONE sampler via ``batcher_kw``.
    """

    def __init__(self, registry, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_s: float = 0.005, queue_depth: int = 256,
                 default_deadline_s: Optional[float] = None,
                 worker: Optional[str] = None, slo=None,
                 best_effort_headroom: float = 0.5, shadow=None):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be strictly-increasing "
                             f"positive ints, got {buckets}")
        self.registry = registry
        self.buckets = buckets
        self.max_delay_s = max_delay_s
        self.default_deadline_s = default_deadline_s
        self.worker = worker
        self.shadow = shadow
        # captured once (the actor idiom): the hot paths pay exactly one
        # `is None` branch per event when tracing is disabled
        self._tracer = trace.get_tracer()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stopped = False      # rejects new submits
        self._drain = True         # False: fail queued requests on stop
        self._thread: Optional[threading.Thread] = None
        # serializes the stopped-check + enqueue against stop(): without
        # it a submit that passed the check could land AFTER the drain
        # sentinel and leave its Future unresolved forever
        self._admit_lock = threading.Lock()
        reg = telemetry.get_registry()
        lbl = {} if worker is None else {"worker": str(worker)}
        self._c_requests = reg.counter("fedml_serve_requests_total", **lbl)
        self._c_batches = reg.counter("fedml_serve_batches_total", **lbl)
        self._adm = TierAdmission(
            {(r, t): reg.counter("fedml_serve_shed_total",
                                 reason=r, tier=t, **lbl)
             for r in SHED_REASONS for t in TIERS},
            slo, best_effort_cap(queue_depth, best_effort_headroom))
        self.tier_gate = self._adm.gate
        self._g_depth = reg.gauge("fedml_serve_queue_depth_total", **lbl)
        # qsize / depth as a ratio: the worst-worker headroom signal the
        # serve_queue_utilization_ratio SLO (and deep-healthz) reads
        self._g_util = reg.gauge("fedml_serve_queue_utilization_ratio",
                                 **lbl)
        self._h_occupancy = reg.histogram(
            "fedml_serve_batch_occupancy_total",
            buckets=tuple(float(b) for b in buckets), **lbl)
        self._h_request = reg.histogram("fedml_serve_request_seconds",
                                        **lbl)
        self._h_predict = reg.histogram("fedml_serve_predict_seconds",
                                        **lbl)
        # the model's per-instance shape, learned from warmup or the
        # first successful batch: the screening anchor, so one malformed
        # FIRST arrival cannot fail its innocent batchmates
        self._expected_shape: Optional[tuple] = None

    # -- client side ---------------------------------------------------------
    def _shed(self, reason: str, tier: str = "interactive") -> ShedError:
        return self._adm.shed(reason, tier)

    def _note_depth(self) -> None:
        depth = self._q.qsize()
        self._g_depth.set(depth)
        if self._q.maxsize > 0:   # maxsize 0 = unbounded: no fill ratio
            self._g_util.set(depth / self._q.maxsize)

    def submit(self, x, deadline_s: Optional[float] = None,
               tier: str = "interactive") -> Future:
        """Enqueue one instance (shape = the model's sample shape).
        Returns a Future resolving to a `PredictResult`, or raising
        `ShedError` if the request is shed.  Raises `ShedError`
        IMMEDIATELY when the queue is full or the batcher is stopped —
        admission control happens here, not after queueing.  Best-effort
        requests additionally shed at the soft queue watermark and while
        the tier gate reports an SLO breach."""
        self._adm.screen(tier, self._q.qsize())
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.monotonic()
        ctx = (self._tracer.current_context()
               if self._tracer is not None else None)
        req = _Request(x, None if deadline_s is None else now + deadline_s,
                       now, Future(), tier, ctx)
        with self._admit_lock:
            if self._stopped:
                raise self._shed("shutdown", tier)
            try:
                self._q.put_nowait(req)
            except queue.Full:
                raise self._shed("queue_full", tier) from None
        self._c_requests.inc()
        if self.shadow is not None:
            # admitted traffic only: the shadow slice mirrors what the
            # serving model actually answers, not what admission shed
            self.shadow.offer(x)
        self._note_depth()
        return req.future

    def predict(self, x, deadline_s: Optional[float] = None,
                timeout: Optional[float] = 30.0,
                tier: str = "interactive") -> PredictResult:
        """Blocking submit-and-wait convenience."""
        return self.submit(x, deadline_s, tier=tier).result(timeout)

    def depth(self) -> int:
        """Currently queued requests (the /healthz headroom signal)."""
        return self._q.qsize()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="serve-batcher")
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop accepting requests; with ``drain`` answer everything
        already queued first (the sentinel rides the FIFO behind them),
        without it shed the queue.  Idempotent."""
        if self._stopped and self._thread is None:
            return
        with self._admit_lock:
            # once this releases, no submit can pass the stopped check,
            # so everything ever admitted is ahead of the sentinel
            self._stopped = True
            self._drain = drain
        if self._thread is None:  # never started: settle inline
            self._flush_remaining()
            return
        # land the sentinel: the queue is bounded, so on a full queue
        # wait for the worker to make room — and if the worker is gone
        # (died, or a previous join timed out), settle inline instead of
        # blocking shutdown forever
        while True:
            try:
                self._q.put(_STOP, timeout=1.0)
                break
            except queue.Full:
                if not self._thread.is_alive():
                    self._thread = None
                    self._flush_remaining()
                    return
        self._thread.join(timeout=30)
        self._thread = None

    def warmup(self, sample_x) -> int:
        """Run every bucket once against the live model (one forward per
        bucket size) so no request pays a first call's costs.  Returns
        the number of buckets warmed; no-op without a live model."""
        m = self.registry.current()
        if m is None:
            return 0
        row = np.asarray(sample_x)
        for b in self.buckets:
            m.predict(np.broadcast_to(row, (b,) + row.shape))
        self._expected_shape = row.shape
        return len(self.buckets)

    # -- worker --------------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _STOP:
                break
            batch = [first]
            stop_seen = self._accumulate(batch)
            self._note_depth()
            self._process(batch)
            if stop_seen:
                break
        # post-sentinel: anything still queued arrived before stop()
        # returned the sentinel — drain answers it, abort sheds it
        self._flush_remaining()

    def _accumulate(self, batch) -> bool:
        """Fill ``batch`` until the largest bucket or the oldest
        request's flush deadline.  Returns True when the STOP sentinel
        was consumed (caller processes the batch, then exits).

        The already-queued backlog is drained GREEDILY first: under
        load the oldest request's flush deadline is already past, and
        consulting it before grabbing queued batchmates would dribble
        out singleton batches at exactly the moment big batches matter
        most."""
        cap = self.buckets[-1]
        while len(batch) < cap:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                return True
            batch.append(nxt)
        flush_at = batch[0].enq_t + self.max_delay_s
        while len(batch) < cap:
            wait = flush_at - time.monotonic()
            if wait <= 0:
                return False
            try:
                nxt = self._q.get(timeout=wait)
            except queue.Empty:
                return False
            if nxt is _STOP:
                return True
            batch.append(nxt)
        return False

    def _flush_remaining(self) -> None:
        while True:
            remaining = []
            try:
                while True:
                    r = self._q.get_nowait()
                    if r is not _STOP:
                        remaining.append(r)
            except queue.Empty:
                pass
            if not remaining:
                return
            if self._drain:
                # answer in bucket-sized waves (still one snapshot/batch)
                for i in range(0, len(remaining), self.buckets[-1]):
                    self._process(remaining[i:i + self.buckets[-1]])
            else:
                for r in remaining:
                    _settle(r.future, exc=self._shed("shutdown", r.tier))

    def _process(self, batch) -> None:
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                _settle(r.future, exc=self._shed("deadline", r.tier))
            else:
                live.append(r)
        if not live:
            return
        snapshot = self.registry.current()  # ONE snapshot for the batch
        if snapshot is None:
            for r in live:
                _settle(r.future, exc=self._shed("no_model", r.tier))
            return
        # per-request shape screening: one malformed x must fail ITS
        # request, not every innocent batchmate np.stack would drag
        # down.  Anchor on the learned model shape when known (warmup /
        # first good batch) so a malformed FIRST arrival can't hijack
        # the anchor and fail valid batchmates.
        rows_np, keep = [], []
        for r in live:
            arr = np.asarray(r.x)
            anchor = self._expected_shape or (rows_np[0].shape if rows_np
                                              else None)
            if anchor is not None and arr.shape != anchor:
                _settle(r.future, exc=BadInstanceError(
                    f"instance shape {arr.shape} does not match the "
                    f"model's {anchor}"))
                continue
            rows_np.append(arr)
            keep.append(r)
        live = keep
        if not live:
            return
        bucket = next(b for b in self.buckets if b >= len(live))
        try:
            rows = np.stack(rows_np)
            if bucket > len(live):  # pad with the first row (any valid
                # shape works; padded outputs are sliced off below)
                pad = np.broadcast_to(rows[:1],
                                      (bucket - len(live),) + rows.shape[1:])
                rows = np.concatenate([rows, pad])
            t0 = time.perf_counter()
            out = snapshot.predict(rows)
            pred_s = time.perf_counter() - t0
            self._h_predict.observe(pred_s)
        except Exception as e:  # noqa: BLE001 — bad payload/model: fail
            # the batch's requests, never the worker thread
            log.exception("batch of %d failed", len(live))
            for r in live:
                _settle(r.future, exc=e)
            return
        if self._expected_shape is None:
            self._expected_shape = rows_np[0].shape  # learned: this
            # batch applied cleanly, so its shape IS the model's
        self._c_batches.inc()
        self._h_occupancy.observe(len(live))
        if self._tracer is not None:
            # retroactive spans off the hot path: one batch-execution
            # span, plus each request's queue wait hung under ITS
            # serve_request span (enq_t/now are monotonic — only the
            # DURATION crosses clocks)
            self._tracer.record_span("serve_batch", pred_s,
                                     size=len(live), bucket=bucket,
                                     version=snapshot.version)
            for r in live:
                self._tracer.record_span("serve_queue", now - r.enq_t,
                                         parent=r.ctx, tier=r.tier)
        done = time.monotonic()
        for i, r in enumerate(live):
            if r.deadline is not None and done > r.deadline:
                # the answer exists but nobody useful is waiting: a late
                # response is a failed response — shed it so delivered
                # latency stays under the deadline by construction
                _settle(r.future, exc=self._shed("deadline", r.tier))
                continue
            self._h_request.observe(done - r.enq_t)
            _settle(r.future, PredictResult(out[i], snapshot.version))
