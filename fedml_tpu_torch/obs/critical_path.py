"""Round critical-path observatory: overlap accounting over the server
receive path, reduced to one ``critical_path`` record per perf.jsonl
round line (the port's copy of ``fedml_tpu/obs/critical_path.py``).

The flight recorder already measures *how long* each receive-path phase
ran (decode, admission, fold, journal, unmask, ...) but not *when* —
so a round where fold runs fully overlapped with the network looks
identical to one where the host serializes fold after the last upload.
`RoundCriticalPath` keeps the actual ``[t0, t1)`` interval of every
phase sample plus every upload-arrival timestamp, then sweeps the round
once at close:

* each elementary segment of the round's wall clock is attributed to
  exactly ONE constraint, so the attribution *partitions* the round —
  ``sum(attribution) == round_s`` by construction (the ``coverage``
  field states it);
* a segment where phase work was active goes to the busiest-priority
  active bucket (fold > decode > admission > network);
* an idle segment is classified by where it falls against the round's
  arrival timeline: before the first upload it is ``network`` (the
  broadcast + remote train + upload are in flight — from the server's
  chair the wire is the constraint), between first and last arrival it
  is ``straggler`` (the quorum is trickling in), and after the last
  arrival it is ``barrier_wait`` (share reveals, barrier close);
* known compile wall time (the device observatory's per-round compile
  ledger) is carved OUT of the work buckets into ``compile`` without
  changing the total — compiles happen *inside* fold/decode work, so
  re-labeling keeps the partition a partition.

The ``binding`` constraint is simply the bucket with the largest share.
``fold_overlap_ratio`` is the fraction of fold busy time that ran while
uploads were still arriving — exactly the "aggregation hidden behind
the network" number the Smart-NIC analog (arXiv 2307.06561) optimizes;
1.0 means the host never stalled the wire to fold.

Cost contract: this module is armed by `PerfRecorder` only — no
recorder, no accumulator, and instrumented paths pay the one
``perf is None`` branch they always paid.  Stdlib only, like all of
``obs/``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from fedml_tpu_torch.obs import telemetry

#: the closed attribution vocabulary — every second of a round lands in
#: exactly one of these (trend.validate_ledger rejects records naming
#: anything else, so dashboards never chase an invented constraint)
CONSTRAINTS = ("network", "decode", "admission", "fold", "barrier_wait",
               "straggler", "compile")

# perf-phase name -> constraint bucket.  Open vocabulary on the phase
# side (unknown phases default to "fold": host-side round work); the
# idle buckets (straggler / barrier_wait) are never mapped — they are
# derived from the arrival timeline, and "straggler_wait" (an idle
# *measurement*, not work) is excluded so it cannot double-count.
PHASE_BUCKETS: Dict[str, str] = {
    "decode": "decode",
    "broadcast_serialize": "network",
    "admission": "admission",
    "health": "admission",
    "fold": "fold", "staging": "fold", "journal": "fold",
    "aggregate": "fold", "defended_aggregate": "fold",
    "shard_finalize": "fold",
    "unmask": "fold", "mask_agreement": "fold",
    "checkpoint": "fold", "publish": "fold",
    # in the mega-cohort regime the wave *produces* uploads — it is the
    # wire analog (broadcast + local train + upload compressed into one
    # device dispatch), so it buckets as network: fold_overlap_ratio
    # then measures exactly "folds hidden behind wave production", the
    # same question the cross-silo arms ask of the real wire
    "wave": "network",
    "compile": "compile",
}
_EXCLUDED_PHASES = frozenset({"straggler_wait"})

# when several buckets are active in one instant (receive threads
# overlap), the segment goes to the first active bucket in this order —
# the one most likely to be the actual bottleneck
_WORK_PRIORITY = ("fold", "decode", "admission", "compile", "network")


def phase_bucket(name: str) -> Optional[str]:
    """Constraint bucket for a perf-phase name (None = excluded)."""
    if name in _EXCLUDED_PHASES:
        return None
    return PHASE_BUCKETS.get(name, "fold")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping intervals; returns disjoint sorted intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for lo, hi in intervals[1:]:
        if lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def _overlap(intervals, lo: float, hi: float) -> float:
    """Total length of ``intervals ∩ [lo, hi)`` (intervals disjoint)."""
    return sum(b - a for a, b in _clip(intervals, lo, hi))


class RoundCriticalPath:
    """Per-round interval accumulator + the closing attribution sweep.

    Receive threads call ``note(phase, seconds)`` (the sample ENDED now;
    its interval is ``[now - seconds, now)`` — the measure-then-note
    idiom every `PerfRecorder.add_phase` caller already follows) and
    ``note_arrival()`` once per upload landing off the wire.  The owner
    calls ``finalize(duration)`` once at round close."""

    __slots__ = ("_t0", "_clock", "_lock", "_samples", "_arrivals")

    def __init__(self, t0: Optional[float] = None, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock() if t0 is None else t0
        self._lock = threading.Lock()
        self._samples: Dict[str, List[Tuple[float, float]]] = {}
        self._arrivals: List[float] = []

    def note(self, phase: str, seconds: float,
             t1: Optional[float] = None) -> None:
        """Record a phase sample that ran for ``seconds`` ending at
        ``t1`` (now by default)."""
        bucket = phase_bucket(phase)
        if bucket is None or seconds <= 0.0:
            return
        if t1 is None:
            t1 = self._clock()
        with self._lock:
            self._samples.setdefault(bucket, []).append((t1 - seconds, t1))

    def note_arrival(self, t: Optional[float] = None) -> None:
        """Record one upload landing off the wire (the arrival timeline
        classifies the round's idle time: network → straggler →
        barrier_wait)."""
        if t is None:
            t = self._clock()
        with self._lock:
            self._arrivals.append(t)

    # -- the closing sweep ---------------------------------------------------
    def finalize(self, duration: Optional[float] = None,
                 compile_s: float = 0.0) -> dict:
        """Reduce the round into its ``critical_path`` record.

        ``duration`` pins the round's wall clock (the recorder passes
        its own ``round_s`` so the partition target and the ledger's
        headline number are the same measurement); ``compile_s`` is
        known compile wall time to carve out of the work buckets."""
        t0 = self._t0
        with self._lock:
            samples = {k: list(v) for k, v in self._samples.items()}
            arrivals = sorted(self._arrivals)
        t1 = t0 + duration if duration is not None else self._clock()
        duration = max(t1 - t0, 0.0)
        attribution = {c: 0.0 for c in CONSTRAINTS}
        busy = {b: _union(_clip(iv, t0, t1)) for b, iv in samples.items()}
        if duration > 0.0:
            # sweep every elementary segment between interval boundaries
            bounds = {t0, t1}
            for iv in busy.values():
                for a, b in iv:
                    bounds.add(a)
                    bounds.add(b)
            first = arrivals[0] if arrivals else None
            last = arrivals[-1] if arrivals else None
            for t in arrivals:
                if t0 < t < t1:
                    bounds.add(t)
            edges = sorted(b for b in bounds if t0 <= b <= t1)
            for lo, hi in zip(edges, edges[1:]):
                if hi <= lo:
                    continue
                mid = (lo + hi) / 2.0
                seg = hi - lo
                active = next(
                    (b for b in _WORK_PRIORITY
                     if any(a <= mid < e for a, e in busy.get(b, ()))),
                    None)
                if active is not None:
                    attribution[active] += seg
                elif first is None or mid < first:
                    attribution["network"] += seg
                elif mid < last:
                    attribution["straggler"] += seg
                else:
                    attribution["barrier_wait"] += seg
        # carve known compile time out of the work buckets (compiles run
        # INSIDE fold/decode work); the total is untouched
        carve = min(compile_s, sum(attribution[b]
                                   for b in ("fold", "decode", "network")))
        if carve > 0.0:
            for b in ("fold", "decode", "network"):
                take = min(carve, attribution[b])
                attribution[b] -= take
                attribution["compile"] += take
                carve -= take
                if carve <= 0.0:
                    break
        total = sum(attribution.values())
        fold_busy = sum(b - a for a, b in busy.get("fold", ()))
        overlap = (_overlap(busy.get("fold", ()), t0, arrivals[-1])
                   / fold_busy if fold_busy > 0.0 and arrivals else 0.0)
        binding = max(CONSTRAINTS, key=lambda c: attribution[c])
        rec = {
            "binding": binding,
            "attribution": {c: round(v, 6)
                            for c, v in attribution.items() if v > 0.0},
            "coverage": round(total / duration, 6) if duration > 0.0 else 1.0,
            "round_s": round(duration, 6),
            "uploads": len(arrivals),
            "fold_overlap_ratio": round(overlap, 6),
        }
        if arrivals:
            # "pure network time": t0 → last arrival — a pipelined
            # round ends almost as soon as the wire does.
            rec["last_arrival_s"] = round(max(arrivals[-1] - t0, 0.0), 6)
        return rec


class IngestGauges:
    """The ``fedml_ingest_*`` family: per-round wire throughput, the
    fold-overlap ratio, per-constraint utilization, the upload counter,
    and — when the `--ingest_pipeline` path is on — the queue-depth
    gauge plus the enqueue/overflow counters (overflow labelled per
    shard so a hot shard's backpressure is visible on its own series).
    Handles are cached at construction (the registry may be the Null
    one — then every export is a no-op attribute call); the per-shard
    overflow counters are lazy because the shard count is a runtime
    fact, not a construction-time one."""

    __slots__ = ("_reg", "_g_bps", "_g_overlap", "_g_util", "_c_uploads",
                 "_g_depth", "_c_enqueued", "_c_overflow")

    def __init__(self, registry=None):
        reg = registry if registry is not None else telemetry.get_registry()
        self._reg = reg
        self._g_bps = reg.gauge("fedml_ingest_bytes_per_second_value")
        self._g_overlap = reg.gauge("fedml_ingest_fold_overlap_ratio")
        self._g_util = {
            c: reg.gauge("fedml_ingest_phase_utilization_ratio",
                         constraint=c)
            for c in CONSTRAINTS}
        self._c_uploads = reg.counter("fedml_ingest_uploads_total")
        self._g_depth = reg.gauge("fedml_ingest_queue_depth_value")
        self._c_enqueued = reg.counter("fedml_ingest_enqueued_total")
        self._c_overflow: Dict[int, object] = {}

    # -- pipeline queue instrumentation --------------------------------------
    def note_enqueued(self, depth: int) -> None:
        """One frame entered an ingest queue; ``depth`` is that queue's
        occupancy after the put."""
        self._c_enqueued.inc()
        self._g_depth.set(depth)

    def note_depth(self, depth: int) -> None:
        """Queue occupancy after a fold worker consumed a frame."""
        self._g_depth.set(depth)

    def note_overflow(self, shard: int) -> None:
        """One frame bounced off a full queue (it is dead-lettered by
        the pipeline, attributed as a network fault — never a strike)."""
        c = self._c_overflow.get(shard)
        if c is None:
            c = self._reg.counter("fedml_ingest_overflow_total",
                                  shard=str(shard))
            self._c_overflow[shard] = c
        c.inc()

    def export(self, record: dict, wire_bytes_in: float) -> None:
        round_s = record.get("round_s") or 0.0
        if round_s > 0.0:
            self._g_bps.set(wire_bytes_in / round_s)
            attribution = record.get("attribution") or {}
            for c, g in self._g_util.items():
                g.set(attribution.get(c, 0.0) / round_s)
        self._g_overlap.set(record.get("fold_overlap_ratio", 0.0))
        uploads = record.get("uploads", 0)
        if uploads:
            self._c_uploads.inc(uploads)


def validate_record(rec, path: str = "critical_path") -> List[str]:
    """Shape-check one ``critical_path`` record (trend gate + tests
    share this): returns problem strings, empty when valid."""
    problems: List[str] = []
    if not isinstance(rec, dict):
        return [f"{path}: not a dict"]
    binding = rec.get("binding")
    if binding not in CONSTRAINTS:
        problems.append(f"{path}: binding {binding!r} not in {CONSTRAINTS}")
    attribution = rec.get("attribution")
    if not isinstance(attribution, dict):
        problems.append(f"{path}: no attribution dict")
        attribution = {}
    for k, v in attribution.items():
        if k not in CONSTRAINTS:
            problems.append(f"{path}: unknown constraint {k!r}")
        if not isinstance(v, (int, float)) or v < 0:
            problems.append(f"{path}: attribution[{k!r}] = {v!r}")
    round_s = rec.get("round_s")
    if not isinstance(round_s, (int, float)) or round_s < 0:
        problems.append(f"{path}: round_s = {round_s!r}")
    coverage = rec.get("coverage")
    if not isinstance(coverage, (int, float)):
        problems.append(f"{path}: coverage = {coverage!r}")
    elif isinstance(round_s, (int, float)) and round_s > 0:
        total = sum(v for v in attribution.values()
                    if isinstance(v, (int, float)))
        if abs(total / round_s - coverage) > 0.01:
            problems.append(
                f"{path}: coverage {coverage} disagrees with "
                f"attribution sum {total:.6f} / round_s {round_s:.6f}")
    return problems
