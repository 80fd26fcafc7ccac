"""Zero-copy pipelined ingest: aggregation hidden behind the network.

The port of ``fedml_tpu/comm/ingest.py`` (:1-462).  Inline, every upload
is decoded, screened and folded on the transport's receive thread; this
module moves everything heavier than header validation off it.

* `IngestArena` — one flat f32 staging buffer in pinned host memory per
  payload template (the whole model, or one shard's slice layout), leaves
  in the wire codec's flatten order (`comm.message._flatten_arrays`) at
  offsets padded to 4 floats, so every leaf view starts 16-byte aligned
  as a fresh allocation does.  A frame's buffer views are gathered into
  it (one bounded memcpy a leaf) and shipped with ONE
  ``copy_(non_blocking=True)`` on the arena's own side stream into a
  fresh device buffer allocated on that stream.  The structural screen
  compares the frame header's leaf descriptors and spec with the
  template (no tree walk); the finite and sum-of-squares screens are
  ``isfinite(flat).all()`` and ``sum((flat − ref)²)`` in f32 on the
  card, as the JAX package's jitted screen computes them.  The result (`ArenaScreen`) feeds the ``pre=``
  seams of `AdmissionPipeline.admit` and `ShardAdmission.offer`; its
  ``tree`` holds views into the device buffer (JAX's ``_split_fn``).
  The pinned buffer is reused across uploads (one consumer an arena):
  before it is rewritten, the host waits on the event recorded after the
  previous copy, never on the whole device.  The side stream waits only
  for the event recorded after the round's reference copy, not for the
  work queued on the consumer's stream (the silos' training); the
  consumer's stream waits on the side stream before it reads the staged
  views, and the buffer is marked as used there (``record_stream``).
* `IngestPipeline` — bounded per-shard queues with one fold worker a
  shard.  The transport thread validates the envelope and enqueues; the
  worker runs decode → screen → fold, so the fold order of a shard is the
  arrival order and the pipelined global is bit-identical to the inline
  one.  ``submit`` dead-letters an overflowing frame
  (``fedml_comm_dead_letter_total{reason="ingest_overflow"}`` and the
  ``fault_feed``, a NETWORK fault, never a strike); ``submit_wait`` (the
  cross-device wave path) blocks the producer instead.

The arena's f32 device norm can give a different norm-outlier verdict
than the inline host f64 screen for an upload at the exact threshold;
the JAX package's arena has the same property.  The queues feed the
``fedml_ingest_*`` gauges (`obs.critical_path.IngestGauges`), and
``IngestArena(perf=)`` puts the arena's screen in the perf recorder's
compile ledger as ``<name>_screen`` (the JAX package's split jit has no
twin here: the staged leaves are views).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import queue
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.comm.message import _flatten_arrays, _unflatten_arrays
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.obs.critical_path import IngestGauges

log = logging.getLogger(__name__)

_STOP = object()

#: the dead-letter reason ingest overflow books: backpressure drops are
#: NETWORK faults by attribution (the payload was never looked at)
OVERFLOW_REASON = "ingest_overflow"

_ALIGN = 4   # leaf offsets in floats: 16 bytes


@dataclasses.dataclass
class ArenaScreen:
    """The arena's screen results, handed to the admission seam so the
    host fingerprint / finite / norm passes are skipped.  ``tree`` holds
    the staged device leaves in the template's layout, value-identical to
    the frame's host views.  ``structural_ok=False``: the header did not
    match the template (a ``fingerprint`` reject); every other field is
    then meaningless."""
    structural_ok: bool
    finite: bool = False
    sumsq: float = 0.0
    norm: float = 0.0
    tree: Any = None


class IngestArena:
    """The pinned flat f32 staging arena for ONE payload template.

    ``template``: the host payload tree this arena stages (the broadcast
    template in the wire layout, or the shard plan's slice of it).  Only all-f32 templates
    are supported (``supported`` is False otherwise and the caller keeps
    the host screens).  ``device``: where uploads are staged.

    Per round, ``round_start(reference)`` stages the screen reference
    (the current global for ``kind="params"`` norms; None keeps zeros,
    the ``kind="delta"`` norm).  ``stage_message(msg, key)`` /
    ``stage_tree(tree)`` gather, ship and screen one upload.  ``copies``
    counts the host-to-device copies of staged uploads.  ``perf``: an
    `obs.perf.PerfRecorder`; the screen lands in its compile ledger as
    ``<name>_screen`` (one entry, in the first round)."""

    def __init__(self, template, *, device="cpu", name: str = "ingest",
                 perf=None):
        self.name = name
        self.device = torch.device(device)
        leaves, spec = _flatten_arrays(template)
        leaves = [np.asarray(leaf) for leaf in leaves]
        self._spec = spec
        # the frame header's spec went through json (tuples -> lists)
        self._spec_json = json.loads(json.dumps(spec))
        self._descr = tuple((str(leaf.dtype),
                             tuple(int(d) for d in leaf.shape))
                            for leaf in leaves)
        self.supported = bool(leaves) and all(
            d == "float32" for d, _ in self._descr)
        self._shapes = [tuple(int(d) for d in leaf.shape) for leaf in leaves]
        self._sizes = [int(leaf.size) for leaf in leaves]
        padded = [-(-n // _ALIGN) * _ALIGN for n in self._sizes]
        self._offsets = [0] + list(np.cumsum(padded)[:-1].tolist()) \
            if padded else []
        self.n_elems = int(sum(self._sizes))
        self.n_padded = int(sum(padded))
        self.copies = 0
        if not self.supported:
            return
        cuda = self.device.type == "cuda"
        # reused across uploads (one consumer); the padding stays zero
        self._host = torch.zeros(self.n_padded, dtype=torch.float32,
                                 pin_memory=cuda)
        self._host_np = self._host.numpy()
        self._ref = torch.zeros(self.n_padded, dtype=torch.float32,
                                device=self.device)
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = None   # event recorded after the last upload copy
        self._ref_ready = None  # event recorded after the reference copy
        if perf is not None:
            from fedml_tpu_torch.obs.device import kernel_flops
            n = self.n_padded
            self._stage_views = perf.instrument_jit(
                f"{name}_screen", self._stage_views,
                flops=lambda views: kernel_flops("arena_screen", d=n))

    # -- round lifecycle -----------------------------------------------------
    def round_start(self, reference=None) -> None:
        """Stage the round's screen reference on the device (one copy a
        round); None keeps zeros."""
        if not self.supported:
            return
        if reference is None:
            self._ref = torch.zeros(self.n_padded, dtype=torch.float32,
                                    device=self.device)
            if self._stream is not None:
                self._ref_ready = torch.cuda.Event()
                self._ref_ready.record(
                    torch.cuda.current_stream(self.device))
            return
        leaves, _ = _flatten_arrays(reference)
        flat = np.zeros(self.n_padded, np.float32)
        for view, o, n in zip(leaves, self._offsets, self._sizes):
            np.copyto(flat[o:o + n],
                      np.asarray(view, np.float32).reshape(-1))
        self._ref = torch.from_numpy(flat).to(self.device)
        if self._stream is not None:
            self._ref_ready = torch.cuda.Event()
            self._ref_ready.record(torch.cuda.current_stream(self.device))

    # -- the structural screen (header vs template, no tree walk) ------------
    def match_header(self, descr, spec) -> bool:
        """The frame header's leaf descriptors (dtype/shape in buffer
        order) and spec must equal the template's; the spec carries the
        leaf keys, so this is as strong as the host fingerprint."""
        try:
            got = tuple((np.dtype(d["dtype"]).name, tuple(d["shape"]))
                        for d in descr)
        except (TypeError, KeyError, ValueError):
            return False
        return got == self._descr and spec == self._spec_json

    # -- staging -------------------------------------------------------------
    def stage_message(self, msg, key) -> Optional[ArenaScreen]:
        """Stage one upload straight from its frame; None when the
        message carries no raw frame (an in-process object message)."""
        raw = msg.raw_payload(key) if hasattr(msg, "raw_payload") else None
        if raw is None or not self.supported:
            return None
        descr, spec, buffers = raw
        if not self.match_header(descr, spec):
            return ArenaScreen(structural_ok=False)
        views = []
        try:
            for d in descr:
                views.append(np.frombuffer(buffers[d["idx"]],
                                           dtype=np.float32))
        except (TypeError, ValueError, IndexError, KeyError):
            return ArenaScreen(structural_ok=False)
        if any(v.size != n for v, n in zip(views, self._sizes)):
            # a torn frame: a buffer's length disagrees with its own
            # descriptor
            return ArenaScreen(structural_ok=False)
        return self._stage_views(views)

    def stage_tree(self, tree) -> Optional[ArenaScreen]:
        """Stage one upload from its decoded tree, screened against the
        template like the raw-header path."""
        if not self.supported:
            return None
        try:
            leaves, spec = _flatten_arrays(tree)
        except Exception:  # noqa: BLE001 — garbage payload object
            return ArenaScreen(structural_ok=False)
        if leaves is None \
                or json.loads(json.dumps(spec)) != self._spec_json \
                or len(leaves) != len(self._descr):
            return ArenaScreen(structural_ok=False)
        views = []
        for leaf, (dtype, shape) in zip(leaves, self._descr):
            arr = np.asarray(leaf)
            if str(arr.dtype) != dtype \
                    or tuple(int(d) for d in arr.shape) != shape:
                return ArenaScreen(structural_ok=False)
            views.append(arr)
        return self._stage_views(views)

    def _stage_views(self, views: List[np.ndarray]) -> ArenaScreen:
        if self._copied is not None:
            # the previous upload's copy must have read the pinned buffer
            # before it is rewritten
            self._copied.synchronize()
        host = self._host_np
        for v, o, n in zip(views, self._offsets, self._sizes):
            np.copyto(host[o:o + n], v.reshape(-1))
        if self._stream is None:
            dev = self._host.clone()
            finite = bool(torch.isfinite(dev).all())
            d = dev - self._ref
            sumsq = float(torch.sum(d * d))
        else:
            consumer = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                if self._ref_ready is not None:
                    self._stream.wait_event(self._ref_ready)
                self._ref.record_stream(self._stream)
                dev = torch.empty(self.n_padded, dtype=torch.float32,
                                  device=self.device)
                dev.copy_(self._host, non_blocking=True)
                self._copied = torch.cuda.Event()
                self._copied.record(self._stream)
                finite_t = torch.isfinite(dev).all()
                d = dev - self._ref
                sumsq_t = torch.sum(d * d)
                finite, sumsq = bool(finite_t), float(sumsq_t)
            # the fold reads the staged views on the consumer's stream
            consumer.wait_stream(self._stream)
            dev.record_stream(consumer)
        self.copies += 1
        leaves = [dev[o:o + n].view(s) for o, n, s in
                  zip(self._offsets, self._sizes, self._shapes)]
        tree = _unflatten_arrays(self._spec, leaves)
        return ArenaScreen(structural_ok=True, finite=finite, sumsq=sumsq,
                           norm=math.sqrt(max(sumsq, 0.0)), tree=tree)


class IngestPipeline:
    """Bounded per-shard ingest queues and one fold worker a shard.

    ``num_shards``: 1 for the replicated / secagg / async paths (one FIFO
    worker is the determinism proof), S for the sharded wire.  ``depth``
    bounds each queue (``--ingest_queue_depth``).  ``fault_feed(reason,
    detail)``: every overflow dead-letter feeds it, so the degrade ledger
    books the drop as a NETWORK fault.  ``attach_arenas`` gives each
    shard's worker its `IngestArena`.

    A worker's exception is stored and re-raised from the next
    ``drain()`` / ``stop()``: a fold that dies fails the round loudly."""

    def __init__(self, *, num_shards: int = 1, depth: int = 64,
                 registry=None,
                 fault_feed: Optional[Callable[[str, str], None]] = None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if depth < 1:
            raise ValueError(
                f"--ingest_queue_depth must be >= 1, got {depth}")
        self.num_shards = num_shards
        self.depth = depth
        reg = registry if registry is not None else telemetry.get_registry()
        self._gauges = IngestGauges(reg)
        self._c_dead = reg.counter("fedml_comm_dead_letter_total",
                                   reason=OVERFLOW_REASON)
        self.overflows = 0
        self._fault_feed = fault_feed
        self._arenas: Optional[List[Optional[IngestArena]]] = None
        self._queues = [queue.Queue(maxsize=depth)
                        for _ in range(num_shards)]
        self._unhandled: List[BaseException] = []
        self._processed = 0
        self._drained_at = 0
        self._lock = threading.Lock()
        # test seam: a paused pipeline enqueues but does not consume
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        self._stopped = False
        self._threads = [
            threading.Thread(target=self._worker, args=(q,),
                             name=f"ingest-fold-{s}", daemon=True)
            for s, q in enumerate(self._queues)]
        for t in self._threads:
            t.start()

    # -- arena wiring --------------------------------------------------------
    def attach_arenas(self, arenas: List[Optional[IngestArena]]) -> None:
        if len(arenas) != self.num_shards:
            raise ValueError(f"{len(arenas)} arenas for {self.num_shards} "
                             f"shard queues")
        self._arenas = arenas

    @property
    def has_arenas(self) -> bool:
        return self._arenas is not None

    def arena_for(self, shard: int) -> Optional[IngestArena]:
        if self._arenas is None:
            return None
        return self._arenas[shard]

    def round_start(self, references) -> None:
        """Per-round reference staging: one reference tree (or None) per
        shard queue."""
        if self._arenas is None:
            return
        for arena, ref in zip(self._arenas, references):
            if arena is not None:
                arena.round_start(ref)

    # -- the producer side ---------------------------------------------------
    def submit(self, shard: int, task: Callable[[], None],
               detail: str = "") -> bool:
        """Transport-path enqueue, non-blocking.  False on overflow: the
        frame is dead-lettered (a NETWORK fault) and the caller must not
        strike trust."""
        self._check_shard(shard)
        self._raise_unhandled()
        try:
            self._queues[shard].put_nowait(task)
        except queue.Full:
            self.overflows += 1
            self._gauges.note_overflow(shard)
            self._c_dead.inc()
            log.warning("ingest queue %d full (depth %d): dead-lettering "
                        "%s as a network fault", shard, self.depth,
                        detail or "frame")
            if self._fault_feed is not None:
                self._fault_feed(OVERFLOW_REASON, detail)
            return False
        self._gauges.note_enqueued(self._queues[shard].qsize())
        return True

    def submit_wait(self, shard: int, task: Callable[[], None]) -> None:
        """Producer-blocking enqueue (the cross-device wave path): a wave
        is never a droppable network frame."""
        self._check_shard(shard)
        self._raise_unhandled()
        self._queues[shard].put(task)
        self._gauges.note_enqueued(self._queues[shard].qsize())

    def _check_shard(self, shard: int) -> None:
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} outside the pipeline's "
                             f"{self.num_shards} queues")

    # -- the consumer side ---------------------------------------------------
    def _worker(self, q: "queue.Queue") -> None:
        while True:
            task = q.get()
            if task is _STOP:
                q.task_done()
                return
            self._resume_evt.wait()
            try:
                task()
            except BaseException as e:  # noqa: BLE001 — must surface
                log.exception("ingest fold worker died processing a task")
                with self._lock:
                    self._unhandled.append(e)
            finally:
                with self._lock:
                    self._processed += 1
                self._gauges.note_depth(q.qsize())
                q.task_done()

    # -- barrier / lifecycle -------------------------------------------------
    def drain(self) -> int:
        """Block until every enqueued task ran; returns how many completed
        since the previous drain (the pump's idle-hook progress signal).
        Re-raises the first worker exception."""
        for q in self._queues:
            q.join()
        self._raise_unhandled()
        with self._lock:
            progress = self._processed - self._drained_at
            self._drained_at = self._processed
        return progress

    def pause(self) -> None:
        """Test seam: workers finish their current task, then hold."""
        self._resume_evt.clear()

    def resume(self) -> None:
        self._resume_evt.set()

    def _raise_unhandled(self) -> None:
        with self._lock:
            if self._unhandled:
                exc = self._unhandled[0]
                self._unhandled = []
                raise RuntimeError(
                    "ingest fold worker died; the round cannot complete"
                ) from exc

    def stop(self) -> None:
        """Idempotent shutdown: stop sentinels, join the workers (never the
        calling thread: a barrier close that ends the federation runs on a
        worker), then surface any worker exception."""
        if self._stopped:
            return
        self._stopped = True
        self._resume_evt.set()
        for q in self._queues:
            q.put(_STOP)
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=10.0)
        self._raise_unhandled()
