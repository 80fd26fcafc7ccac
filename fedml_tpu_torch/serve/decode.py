"""Continuous-batching decode scheduler for autoregressive serving (port
of ``fedml_tpu/serve/decode.py``).

ONE persistent decode step over a fixed ``[slots]`` batch: a finished
sequence vacates its slot at the end of a step and a queued request
joins the free slot at the start of the next, so occupancy stays near
capacity under backlog.  The step is `TransformerLM`'s incremental decode
(`models.transformer.init_decode_cache`, JAX's cache layout); prompts go
through the same step one token at a time (logits ignored until the
last prompt token).

Where the JAX package keeps one ``jax.jit`` entry for the scheduler's
lifetime (cache donated), the port captures the step ONCE into a
``torch.cuda.CUDAGraph`` over static buffers: the tokens, the positions,
the KV cache and the parameters of a private copy of the model.  A hot
swap copies the new version's parameters into those buffers at the swap
barrier, when no slot is live, and never captures again.  ``_cache_size``
counts the step's builds — the captures on the card, the one eager build
on the CPU — and must stay 1; ``register_obs`` registers it with
`obs.perf.RecompileSentry`.  On the CPU the step runs eagerly; on the
card a capture that fails raises (no eager fallback; ``graph=False``
asks for the eager step, to measure against).

Model-version consistency: a KV cache computed under version v is not
valid state for version v+1, so a hot swap never lands mid-sequence.
The scheduler pins one `ServedModel` snapshot while any slot is live;
when the registry moves on it stops ADMITTING (the swap barrier), lets
live sequences finish on the pinned version, then swaps and resumes.
Every result carries the version that decoded ALL of its tokens.

``continuous=False`` is the drain-per-batch baseline: admission only when
every slot is free.
"""

from __future__ import annotations

import copy
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from fedml_tpu_torch.obs import telemetry, trace
from fedml_tpu_torch.serve.batcher import (SHED_REASONS, TIERS,
                                           ShedError, TierAdmission,
                                           _settle, best_effort_cap)

log = logging.getLogger(__name__)


class DecodeResult:
    """One finished sequence: the generated token ids, the model version
    that produced EVERY one of them (the swap barrier guarantees a
    single version per sequence), and whether generation was cut by the
    cache bucket rather than max_new/EOS."""
    __slots__ = ("tokens", "version", "truncated")

    def __init__(self, tokens: List[int], version: int, truncated: bool):
        self.tokens = tokens
        self.version = version
        self.truncated = truncated


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "deadline", "enq_t", "future",
                 "tier", "capped", "ctx")

    def __init__(self, prompt, max_new, deadline, enq_t, future, tier,
                 capped=False, ctx=None):
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline
        self.enq_t = enq_t
        self.future = future
        self.tier = tier
        self.capped = capped   # max_new was cut at admission to fit the
        #                        cache bucket: the result is `truncated`
        self.ctx = ctx         # submitter's span context, if any


class _Slot:
    """Host-side state of one in-flight sequence."""
    __slots__ = ("req", "pos", "generated")

    def __init__(self, req: _DecodeRequest):
        self.req = req
        self.pos = 0          # next sequence index to feed
        self.generated: List[int] = []

    def next_token(self) -> int:
        if self.pos < len(self.req.prompt):
            return int(self.req.prompt[self.pos])
        return self.generated[-1]


class _DecodeStep:
    """The greedy decode step over static buffers: a private copy of the
    model (its parameters the pinned version's), ``[slots]`` tokens and
    positions, the KV cache, and the outputs (``logits`` [slots, V],
    ``out`` the argmax).  ``graph``: capture the step into one CUDA graph
    on first call and replay it after (the card), or run it eagerly."""

    def __init__(self, model, slots: int, cache_len: int, cache_dtype,
                 device: torch.device, graph: bool):
        from fedml_tpu_torch.models.transformer import init_decode_cache
        self.device = device
        self.graph = graph
        self.module = copy.deepcopy(model).to(device)
        for p in self.module.parameters():
            p.requires_grad_(False)
        self._params = dict(self.module.named_parameters())
        self.tokens = torch.zeros(slots, dtype=torch.long, device=device)
        self.positions = torch.zeros(slots, dtype=torch.long, device=device)
        self.cache = init_decode_cache(self.module, slots, cache_len,
                                       dtype=cache_dtype, device=device)
        self.logits = self.out = None
        self._graph = None
        self.builds = 0     # captures (graph) or the one eager build

    def _cache_size(self) -> int:
        return self.builds

    def load(self, params) -> None:
        """Copy a version's params (flat or nested) into the static
        parameter buffers."""
        from fedml_tpu_torch.core.pytree import flatten_nested
        flat = flatten_nested(params)
        with torch.no_grad():
            for name, p in self._params.items():
                p.copy_(torch.as_tensor(flat[name.replace(".", "/")]))

    def _body(self) -> None:
        logits, _ = self.module(self.tokens, positions=self.positions,
                                cache=self.cache)
        self.logits = logits
        self.out = torch.argmax(logits, dim=-1)

    def _capture(self) -> None:
        # warm the step up on a side stream (the library's first-call
        # work must not land in the graph), then capture it once
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            self._body()
        self._graph = graph
        self.builds += 1

    def __call__(self, tokens: np.ndarray, positions: np.ndarray
                 ) -> np.ndarray:
        self.tokens.copy_(torch.from_numpy(tokens))
        self.positions.copy_(torch.from_numpy(positions))
        if self.graph:
            if self._graph is None:
                self._capture()
            self._graph.replay()
        else:
            with torch.no_grad():
                self._body()
            self.builds = 1
        return self.out.cpu().numpy()

    def flops(self, *args, **kwargs) -> float:
        """One step's matmul FLOPs (2 x multiply-adds): the projections,
        the MLP (one expert a token under MoE) and the head per slot, and
        the scores and weighted sum over the whole cache."""
        m = self.module
        s, tc = self.tokens.shape[0], self.cache["attn_0"]["k"].shape[1]
        d, v = m.d_model, m.lm_head.kernel.shape[1]
        d_ff = (m.moe_0.d_ff if m.moe_experts
                else getattr(m, "Dense_0").kernel.shape[1])
        per_layer = 4 * d * d + 2 * d * d_ff + 2 * tc * d
        return 2.0 * s * (m.n_layers * per_layer + d * v)


class DecodeScheduler:
    """Continuous-batching greedy decode over a fixed-slot graphed step.

    ``registry``: a `ModelRegistry` whose published params belong to
    ``model`` (a `TransformerLM`); the registry's ``apply_fn`` is not
    used here — the scheduler runs its own decode step on the registry's
    device over a private copy of ``model``.
    ``slots``: the fixed batch width; ``cache_len``: the KV cache bucket
    (prompt + generated tokens must fit; a sequence hitting the wall
    finishes ``truncated``).  ``eos_id``: optional stop token.
    ``continuous``: per-step slot admission (False = drain-per-batch
    baseline).  ``worker``/``slo``/``best_effort_headroom``: the same
    tiered-admission surface as `MicroBatcher`.  ``cache_dtype``: the
    KV cache's dtype (f32 by default).  ``graph``: capture the step
    into a CUDA graph on the card (the CPU always runs it eagerly);
    False runs it eagerly on the card too.
    """

    def __init__(self, registry, model, *, slots: int = 8,
                 cache_len: int = 128, queue_depth: int = 256,
                 max_new: int = 32, eos_id: Optional[int] = None,
                 continuous: bool = True,
                 default_deadline_s: Optional[float] = None,
                 worker: Optional[str] = None, slo=None,
                 best_effort_headroom: float = 0.5,
                 cache_dtype=None, graph: bool = True):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.registry = registry
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.max_new = max_new
        self.eos_id = eos_id
        self.continuous = continuous
        self.default_deadline_s = default_deadline_s
        self.worker = worker
        # captured once (the actor idiom): disabled tracing pays one
        # `is None` branch per step/finish, no lookups on the hot loop
        self._tracer = trace.get_tracer()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._slots: List[Optional[_Slot]] = [None] * slots
        self._snapshot = None           # pinned ServedModel
        self._swap_pending = False
        self._stopped = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self._admit_lock = threading.Lock()
        self._wake = threading.Event()
        # bench-readable occupancy accounting (telemetry-independent)
        self.steps = 0
        self.live_steps = 0             # sum of live slots over steps

        device = registry.device
        # ONE build for the scheduler's lifetime: static [slots] buffers,
        # the cache written in place.  _cache_size is the sentry probe.
        self._step = _DecodeStep(
            model, slots, cache_len,
            cache_dtype if cache_dtype is not None else torch.float32,
            device, graph and device.type == "cuda")
        self._step_fn = self._step   # obs instrumentation wraps this

        reg = telemetry.get_registry()
        lbl = {} if worker is None else {"worker": str(worker)}
        self._c_requests = reg.counter("fedml_serve_decode_requests_total",
                                       **lbl)
        self._c_steps = reg.counter("fedml_serve_decode_steps_total",
                                    **lbl)
        self._c_tokens = reg.counter("fedml_serve_decode_tokens_total",
                                     **lbl)
        self._c_swaps = reg.counter("fedml_serve_decode_swaps_total",
                                    **lbl)
        self._adm = TierAdmission(
            {(r, t): reg.counter("fedml_serve_decode_shed_total",
                                 reason=r, tier=t, **lbl)
             for r in SHED_REASONS for t in TIERS},
            slo, best_effort_cap(queue_depth, best_effort_headroom))
        self.tier_gate = self._adm.gate
        self._h_occupancy = reg.histogram(
            "fedml_serve_decode_occupancy_total",
            buckets=tuple(float(i) for i in range(1, slots + 1)), **lbl)
        self._h_request = reg.histogram("fedml_serve_request_seconds",
                                        path="decode", **lbl)
        self._g_util = reg.gauge("fedml_serve_queue_utilization_ratio",
                                 path="decode", **lbl)

    # -- observability -------------------------------------------------------
    def _cache_size(self) -> int:
        """Builds of the decode step (the sentry probe): CUDA-graph
        captures on the card, the eager build on the CPU.  Must stay 1 for
        the scheduler's lifetime — slot churn, mid-flight joins and swap
        barriers never change a buffer."""
        return self._step.builds

    def register_obs(self, recorder=None, sentry=None,
                     name: Optional[str] = None) -> str:
        """Register the decode step with the observatory: the compile
        ledger (`obs.device.DeviceRecorder`) names it
        ``decode_step[s<slots>,c<cache_len>]`` and the recompile sentry
        watches its builds.  The step's FLOPs come from its own formula,
        so no flop counter runs around a capture.  Returns the ledger
        name."""
        name = name or f"decode_step[s{self.slots},c{self.cache_len}]"
        if sentry is not None:
            sentry.register(name, self)
        if recorder is not None:
            self._step_fn = recorder.instrument(
                name, self._step, sentry=sentry, sentry_name=name,
                flops=self._step.flops)
        return name

    def occupancy(self) -> Optional[float]:
        """Mean live slots per step so far (None before any step)."""
        return self.live_steps / self.steps if self.steps else None

    def depth(self) -> int:
        return self._q.qsize()

    # -- client side ---------------------------------------------------------
    def _shed(self, reason: str, tier: str = "interactive") -> ShedError:
        return self._adm.shed(reason, tier)

    def submit(self, prompt, max_new: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tier: str = "interactive") -> Future:
        """Enqueue one sequence: ``prompt`` is a non-empty list of token
        ids; the Future resolves to a `DecodeResult`.  ``deadline_s``
        bounds QUEUE wait (admission), not generation — once a sequence
        holds a slot it runs to completion.  Sheds exactly like
        `MicroBatcher.submit` (queue_full / deadline-at-admission /
        shutdown / no_model / slo_degraded for best-effort)."""
        self._adm.screen(tier, self._q.qsize())
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt: decode needs >= 1 token")
        max_new = self.max_new if max_new is None else int(max_new)
        capped = False
        if len(prompt) + max_new > self.cache_len:
            # admission-time honesty: the cache bucket cannot hold it —
            # cap max_new here and flag the request, so the result says
            # `truncated` (the generation WAS cut by the bucket, the cut
            # just happened at admission instead of mid-flight; a prompt
            # alone overflowing the bucket is a client error)
            if len(prompt) >= self.cache_len:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens does not fit the "
                    f"cache bucket ({self.cache_len})")
            max_new = self.cache_len - len(prompt)
            capped = True
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.monotonic()
        ctx = (self._tracer.current_context()
               if self._tracer is not None else None)
        req = _DecodeRequest(
            prompt, max_new,
            None if deadline_s is None else now + deadline_s,
            now, Future(), tier, capped, ctx)
        with self._admit_lock:
            if self._stopped:
                raise self._shed("shutdown", tier)
            try:
                self._q.put_nowait(req)
            except queue.Full:
                raise self._shed("queue_full", tier) from None
        self._c_requests.inc()
        self._note_util()
        self._wake.set()
        return req.future

    def _note_util(self) -> None:
        """Refresh the queue-fill gauge.  Called on submit AND from the
        worker loop after admission — a gauge only written on submit
        would latch a burst's high-water mark forever once traffic
        stops, self-sustaining an SLO breach (and best-effort shedding)
        on an idle instance."""
        if self._q.maxsize > 0:   # maxsize 0 = unbounded: no fill ratio
            self._g_util.set(self._q.qsize() / self._q.maxsize)

    def generate(self, prompt, max_new: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = 60.0,
                 tier: str = "interactive") -> DecodeResult:
        """Blocking submit-and-wait convenience."""
        return self.submit(prompt, max_new, deadline_s,
                           tier=tier).result(timeout)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DecodeScheduler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="serve-decode")
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop admitting; with ``drain`` finish every in-flight AND
        queued sequence first (bounded by max_new steps each), without
        it shed the queue and fail live slots.  Idempotent.  The worker
        never blocks on the queue (it polls with a bounded wait), so a
        flag + wake is enough — no sentinel needed."""
        with self._admit_lock:
            if self._stopped and self._thread is None:
                return
            self._stopped = True
            self._drain = drain
        self._wake.set()
        if self._thread is None:
            # never started: honor the drain contract inline (the
            # MicroBatcher convention — queued work still gets answers)
            if drain and self._refresh_snapshot():
                self._drain_all()
            self._flush_queue(shed=True)
            return
        self._thread.join(timeout=120)
        if self._thread.is_alive():
            # a drain deeper than the timeout: the worker is STILL
            # stepping — marking it stopped would let a second stop()
            # take the inline-drain path and mutate slots/cache
            # concurrently with the live worker
            log.warning("decode scheduler: worker still draining after "
                        "120s; call stop() again to keep waiting")
            return
        self._thread = None

    def warmup(self) -> bool:
        """Pay the decode step's build (the capture on the card) before
        serving: one all-dead step against the live model.  No-op without
        a published model."""
        if not self._refresh_snapshot(force=True):
            return False
        self._step_fn(np.zeros(self.slots, np.int64),
                      np.zeros(self.slots, np.int64))
        return True

    # -- worker --------------------------------------------------------------
    def _refresh_snapshot(self, force: bool = False) -> bool:
        """Pin the registry's current snapshot (its params copied into
        the step's static buffers once).  With live slots a NEWER version
        only marks the swap barrier — the pinned snapshot keeps serving
        until they drain."""
        cur = self.registry.current()
        if cur is None:
            return self._snapshot is not None
        if self._snapshot is None or force \
                or (cur.version != self._snapshot.version
                    and not any(self._slots)):
            swapped = (self._snapshot is not None
                       and cur.version != self._snapshot.version)
            self._snapshot = cur
            self._step.load(cur.params)
            self._swap_pending = False
            if swapped:
                self._c_swaps.inc()
        elif cur.version != self._snapshot.version:
            self._swap_pending = True
        return True

    def _admit(self) -> None:
        """Fill free slots from the queue.  Continuous mode admits into
        any free slot every step; drain mode only refills once EVERY
        slot is free (the pad-to-bucket baseline).  The swap barrier
        blocks all admission until live sequences finish."""
        if self._swap_pending:
            return
        if not self.continuous and any(self._slots):
            return
        now = time.monotonic()
        for i in range(self.slots):
            if self._slots[i] is not None:
                continue
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    return
                if req.deadline is not None and now > req.deadline:
                    _settle(req.future,
                            exc=self._shed("deadline", req.tier))
                    continue
                self._slots[i] = _Slot(req)
                break

    def _finish(self, i: int, truncated: bool) -> None:
        slot = self._slots[i]
        self._slots[i] = None
        done = time.monotonic()
        self._h_request.observe(done - slot.req.enq_t)
        if self._tracer is not None:
            # one retroactive span per finished sequence, hung under
            # the submitter's request span when it carried one
            self._tracer.record_span(
                "serve_decode", done - slot.req.enq_t,
                parent=slot.req.ctx, tokens=len(slot.generated),
                version=self._snapshot.version, truncated=truncated)
        _settle(slot.req.future,
                DecodeResult(slot.generated, self._snapshot.version,
                             truncated))

    def _step_once(self) -> None:
        live_idx = [i for i, s in enumerate(self._slots) if s is not None]
        if not live_idx:
            return
        tokens = np.zeros(self.slots, np.int64)
        positions = np.zeros(self.slots, np.int64)
        for i in live_idx:
            s = self._slots[i]
            tokens[i] = s.next_token()
            positions[i] = s.pos
        t0 = time.perf_counter()
        out = self._step_fn(tokens, positions)
        if self._tracer is not None:
            self._tracer.record_span("decode_step",
                                     time.perf_counter() - t0,
                                     live=len(live_idx))
        self.steps += 1
        self.live_steps += len(live_idx)
        self._c_steps.inc()
        self._c_tokens.inc(len(live_idx))
        self._h_occupancy.observe(len(live_idx))
        for i in live_idx:
            s = self._slots[i]
            feeding_prompt = s.pos < len(s.req.prompt) - 1
            s.pos += 1
            if feeding_prompt:
                # mid-prompt logits predict a token the prompt already
                # pins — ignored (teacher forcing)
                continue
            tok = int(out[i])
            s.generated.append(tok)
            if self.eos_id is not None and tok == self.eos_id:
                self._finish(i, truncated=False)   # a natural stop is
                #          never a truncation, even on a capped request
            elif len(s.generated) >= s.req.max_new:
                self._finish(i, truncated=s.req.capped)
            elif s.pos >= self.cache_len:   # unreachable given the
                # admission cap; kept as belt-and-braces against a
                # future admission change silently overrunning the cache
                self._finish(i, truncated=True)

    def _flush_queue(self, shed: bool, reason: str = "shutdown") -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if shed:
                _settle(req.future, exc=self._shed(reason, req.tier))

    def _run(self) -> None:
        while True:
            with self._admit_lock:
                stopped = self._stopped
            if stopped:
                break
            if not self._refresh_snapshot():
                # no model yet: requests would wait forever on an empty
                # registry — fail them the way MicroBatcher does
                self._flush_queue(shed=True, reason="no_model")
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._admit()
            self._note_util()
            if not any(self._slots):
                if self._swap_pending:
                    # all sequences drained: complete the barrier swap
                    self._refresh_snapshot()
                    continue
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._step_once()
        # shutdown: drain answers every admitted AND queued sequence
        # (the swap barrier still clears between batches), abort fails
        # them all.  _refresh_snapshot, not a _snapshot check: a stop()
        # racing the worker's FIRST loop iteration must still pin the
        # published model and honor the drain contract
        if self._drain and self._refresh_snapshot():
            self._drain_all()
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                _settle(s.req.future,
                        exc=self._shed("shutdown", s.req.tier))
        self._flush_queue(shed=True)

    def _drain_all(self) -> None:
        """Run the step loop until every admitted and queued sequence
        has answered (bounded: each costs <= cache_len steps)."""
        while True:
            self._refresh_snapshot()
            self._admit()
            if not any(self._slots):
                break
            self._step_once()
