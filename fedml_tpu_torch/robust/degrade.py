"""Sustained-degradation survivability: the per-silo reliability tracker.

The port of ``fedml_tpu/robust/degrade.py`` (:1-527), host Python and
numpy as there, so the deadline, the verdicts and the ``state_dict``
(the NaN-padded ``[n_silos, window]`` latency matrix) are equal to the
JAX package's and a state written by either package loads in the other.

* ``FaultClass`` (:60-78) — the closed attribution vocabulary; only
  ``payload`` verdicts may strike the `TrustTracker`.
* ``classify_admission_reason`` (:84), ``TimeoutVerdict`` (:94).
* ``_quantile`` (:114) and ``merge_priority`` (:129) — the deadline's
  deterministic quantile and the cross-device re-task head.
* ``ReliabilityTracker`` (:153-527) — windowed completions, the adaptive
  deadline (``p90 × slack`` clamped to ``[deadline_floor_s,
  round_timeout_s]``), ``assess_timeout`` (quorum close, partition hold
  with network evidence, abandon), participation debt and priority,
  ``as_ledger``, and ``state_dict``/``load_state_dict``.  The state rides
  the round checkpoint and the journal under the ``"degrade"`` key of the
  live actor's extra state, so a resumed server re-derives the deadline
  the crashed process armed.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)


class FaultClass:
    """The closed fault-attribution vocabulary.

    ``NETWORK`` — the wire failed, not the silo: dead-lettered sends,
    deadline drops, partition misses.  MUST NEVER strike trust.
    ``PAYLOAD`` — the silo's own bytes are the offense: fingerprint /
    nonfinite / norm-outlier / bad-sample-count admission verdicts.
    The ONLY class allowed to strike.
    ``UNKNOWN`` — damage whose origin cannot be pinned (e.g. a frame
    that decodes to garbage on a corrupting link).  Never strikes.
    """

    NETWORK = "network"
    PAYLOAD = "payload"
    UNKNOWN = "unknown"
    ALL = (NETWORK, PAYLOAD, UNKNOWN)


def classify_admission_reason(reason: str) -> str:
    """Attribution class of an admission verdict: every reason in the
    admission ``REASONS`` vocabulary is evidence about the silo's OWN
    payload, so all map to ``payload`` — the wire cannot forge a
    finite-precision norm outlier or a bad sample count, and a
    fingerprint mismatch is a misconfigured (or lying) sender."""
    return FaultClass.PAYLOAD


@dataclasses.dataclass
class TimeoutVerdict:
    """One ``assess_timeout`` decision — ``as_dict()`` lands on the
    perf-ledger line so every hold/close is auditable after the fact."""

    action: str                 # "close" | "hold" | "abandon" | "wait"
    quorum: int                 # the required fold count
    received: int
    missing: tuple              # silo ids still outstanding
    partition_suspected: bool
    holds: int                  # holds taken so far THIS round
    reason: str

    def as_dict(self) -> dict:
        return {"action": self.action, "quorum": int(self.quorum),
                "received": int(self.received),
                "missing": list(self.missing),
                "partition": bool(self.partition_suspected),
                "holds": int(self.holds), "reason": self.reason}


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Deterministic linear-interpolation quantile over an already
    sorted sequence (numpy's default method, hand-rolled so the
    derivation never depends on a numpy version)."""
    n = len(sorted_vals)
    if n == 1:
        return float(sorted_vals[0])
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo]) * (1.0 - frac) \
        + float(sorted_vals[hi]) * frac


def merge_priority(sampled: Sequence[int], priority: Sequence[int],
                   limit: int) -> List[int]:
    """Debt-driven re-task priority: ``priority`` ids (most-indebted
    first) claim the head of the cohort, the seeded sample fills the
    rest — same size, no duplicates, deterministic.  Used by the
    cross-device sampler so a client the deadline dropped is GUARANTEED
    a slot next round instead of waiting on the sampler's luck."""
    out: List[int] = []
    seen: Set[int] = set()
    for cid in priority:
        if len(out) >= limit:
            break
        if int(cid) not in seen:
            out.append(int(cid))
            seen.add(int(cid))
    for cid in sampled:
        if len(out) >= limit:
            break
        if int(cid) not in seen:
            out.append(int(cid))
            seen.add(int(cid))
    return out[:limit]


class ReliabilityTracker:
    """Per-silo reliability state: EWMA/quantile completion latencies
    (phi-accrual-style suspicion), participation debt, fault
    attribution counts, and the quorum/partition verdict logic.

    The tracker is fed by the existing receive path
    (``observe_completion`` per arrival), `FailureDetector` states
    (passed into ``assess_timeout``), and `ResilientTransport`
    dead-letter events (``note_dead_letter`` via the transport's
    ``fault_feed`` hook).  Its few fixed-shape arrays ride the round
    checkpoint through ``state_dict``/``load_state_dict`` (the
    ``extra_state`` seam), so a resumed server re-derives the same
    deadline and quorum verdict — pinned deterministic."""

    def __init__(self, n_silos: int, *,
                 min_quorum: float = 0.0,
                 adaptive_deadline: bool = False,
                 deadline_floor_s: float = 0.5,
                 deadline_quantile: float = 0.9,
                 deadline_slack: float = 1.5,
                 partition_frac: float = 0.0,
                 partition_max_holds: int = 3,
                 window: int = 32,
                 min_history: int = 3,
                 ewma_alpha: float = 0.2):
        if not 0.0 <= min_quorum <= 1.0:
            raise ValueError(f"min_quorum must be in [0, 1], got "
                             f"{min_quorum}")
        if not 0.0 < deadline_quantile <= 1.0:
            raise ValueError(f"deadline_quantile must be in (0, 1], got "
                             f"{deadline_quantile}")
        self.n_silos = int(n_silos)
        self.min_quorum = float(min_quorum)
        self.adaptive_deadline = bool(adaptive_deadline)
        self.deadline_floor_s = float(deadline_floor_s)
        self.deadline_quantile = float(deadline_quantile)
        self.deadline_slack = float(deadline_slack)
        self.partition_frac = float(partition_frac)
        self.partition_max_holds = int(partition_max_holds)
        self.window = int(window)
        self.min_history = max(1, int(min_history))
        self.ewma_alpha = float(ewma_alpha)
        # newest-`window` completion latencies per silo: the deadline's
        # whole input, fixed-size by construction so state_dict is a
        # restart-independent [n_silos, window] matrix
        self._lat: Dict[int, Deque[float]] = {
            s: collections.deque(maxlen=self.window)
            for s in range(1, self.n_silos + 1)}
        # phi-accrual moments (EWMA mean/var of completion latency)
        self._ewma_mean: Dict[int, float] = {}
        self._ewma_var: Dict[int, float] = {}
        self._debt: Dict[int, int] = {s: 0
                                      for s in range(1, self.n_silos + 1)}
        self._fault_counts = {c: 0 for c in FaultClass.ALL}
        self.holds_total = 0
        self.drops_total = 0
        # per-round state (reset by round_start)
        self._round_idx: Optional[int] = None
        self._round_holds = 0
        self._round_dead_letters = 0
        self._round_accepted: Set[int] = set()
        self._round_dropped: List[int] = []
        self._round_deadline: Optional[float] = None
        self._last_verdict: Optional[TimeoutVerdict] = None
        reg = telemetry.get_registry()
        self._g_deadline = reg.gauge("fedml_degrade_deadline_seconds")
        self._g_debt = reg.gauge("fedml_degrade_debt_max_value")
        self._g_susp = reg.gauge("fedml_degrade_suspicion_max_value")
        self._c_holds = reg.counter("fedml_degrade_holds_total")
        self._c_drops = reg.counter("fedml_degrade_drops_total")
        # fedml_degrade_faults_total{fault=...} registers LAZILY on the
        # first event of each class (the no-fabricated-0 contract:
        # a run with zero network faults must not export a 0 series)
        self._c_faults: Dict[str, object] = {}

    # -- feeds ---------------------------------------------------------------

    def round_start(self, round_idx: int, expected: Iterable[int]) -> None:
        """Open the round's decision window: hold budget and network
        evidence are per-round, the latency/debt histories persist."""
        self._round_idx = int(round_idx)
        self._round_holds = 0
        self._round_dead_letters = 0
        self._round_accepted = set()
        self._round_dropped = []
        self._round_deadline = None
        self._last_verdict = None

    def observe_completion(self, silo: int, latency_s: float) -> None:
        """One report arrival (admitted OR rejected — either way the
        silo completed the round trip): feeds the deadline quantiles
        and the phi-accrual moments."""
        silo = int(silo)
        lat = float(latency_s)
        if silo not in self._lat or not math.isfinite(lat) or lat < 0:
            return
        self._lat[silo].append(lat)
        m = self._ewma_mean.get(silo)
        if m is None:
            self._ewma_mean[silo] = lat
            self._ewma_var[silo] = 0.0
        else:
            a = self.ewma_alpha
            d = lat - m
            self._ewma_mean[silo] = m + a * d
            self._ewma_var[silo] = (1 - a) * (
                self._ewma_var.get(silo, 0.0) + a * d * d)

    def note_accept(self, silo: int) -> None:
        """An admitted fold: the silo participated — its debt clears."""
        silo = int(silo)
        if silo in self._debt:
            self._debt[silo] = 0
        self._round_accepted.add(silo)

    def note_drop(self, silo: int, round_idx: Optional[int] = None) -> None:
        """A deadline drop: NETWORK-attributed (the silo may be honest
        and merely slow/partitioned — never a strike), and the silo
        accrues one unit of participation debt so re-tasking
        prioritizes it next round."""
        silo = int(silo)
        if silo in self._debt:
            self._debt[silo] += 1
        self.drops_total += 1
        self._round_dropped.append(silo)
        self._c_drops.inc()
        self.note_fault(FaultClass.NETWORK, silo=silo)

    def note_dead_letter(self, reason: str = "send_failed",
                         silo: Optional[int] = None) -> None:
        """A `ResilientTransport` dead-letter (the transport's
        ``fault_feed`` routes here): network evidence for partition
        discrimination this round, never a strike."""
        self._round_dead_letters += 1
        self.note_fault(FaultClass.NETWORK, silo=silo,
                        detail=f"dead_letter:{reason}")

    def note_fault(self, fault: str, *, silo: Optional[int] = None,
                   detail: str = "") -> None:
        """Count one attributed fault event (the closed vocabulary is
        enforced here too — an unknown class is a programming error,
        not a new category)."""
        if fault not in FaultClass.ALL:
            raise ValueError(
                f"unknown fault class {fault!r}; the vocabulary is "
                f"closed: {FaultClass.ALL}")
        self._fault_counts[fault] += 1
        c = self._c_faults.get(fault)
        if c is None:
            c = telemetry.get_registry().counter(
                "fedml_degrade_faults_total", fault=fault)
            self._c_faults[fault] = c
        c.inc()

    # -- adaptive deadline ---------------------------------------------------

    def deadline_s(self, expected: Iterable[int],
                   cap_s: Optional[float]) -> Optional[float]:
        """The round's straggler deadline: ``max`` over the expected
        silos' per-silo latency quantiles × ``deadline_slack``, clamped
        to ``[deadline_floor_s, cap_s]``.  Cold start falls back to the
        static ``cap_s`` until EVERY expected silo has ``min_history``
        observations — a deadline derived from only the measured (fast)
        silos would drop an unmeasured slow-but-honest silo before it
        ever got a completion on record, and starve it forever.  PURE
        in the recorded history — same state in, same deadline out (the
        resume-determinism contract)."""
        if cap_s is None:
            return None
        if not self.adaptive_deadline:
            self._round_deadline = float(cap_s)
            return float(cap_s)
        qs = []
        for silo in expected:
            hist = self._lat.get(int(silo))
            if hist is None:
                continue   # foreign key: not this tracker's cohort
            if len(hist) < self.min_history:
                self._round_deadline = float(cap_s)
                return float(cap_s)
            qs.append(_quantile(sorted(hist), self.deadline_quantile))
        if not qs:
            self._round_deadline = float(cap_s)
            return float(cap_s)
        d = max(qs) * self.deadline_slack
        d = min(max(d, self.deadline_floor_s), float(cap_s))
        self._round_deadline = d
        self._g_deadline.set(d)
        return d

    def suspicion(self, silo: int, elapsed_s: float) -> float:
        """Phi-accrual-style suspicion that ``silo`` has failed, given
        ``elapsed_s`` since it was tasked: φ = −log10 P(latency >
        elapsed) under an exponential model at the silo's EWMA mean.
        0 when the silo has no history (nothing to suspect from)."""
        m = self._ewma_mean.get(int(silo))
        if m is None or m <= 0:
            return 0.0
        # exponential tail: P(T > t) = exp(-t/m)  →  φ = (t/m) / ln(10)
        return max(0.0, float(elapsed_s) / m / math.log(10.0))

    # -- quorum / partition --------------------------------------------------

    def quorum_for(self, n_expected: int) -> Optional[int]:
        """The fold count required to close, or None when quorum-aware
        closure is off (the caller falls back to min_silo_frac)."""
        if self.min_quorum <= 0:
            return None
        return max(1, math.ceil(self.min_quorum * int(n_expected)))

    def assess_timeout(self, round_idx: int, expected: Set[int],
                       received: Set[int], quorum: int,
                       detector_states: Optional[Dict[int, str]] = None,
                       ) -> TimeoutVerdict:
        """The deadline fired with silos outstanding: close, hold, or
        abandon.

        * A correlated miss (``missing/expected ≥ partition_frac``)
          WITH network evidence — dead-letters seen this round, or
          every missing silo non-ALIVE per the failure detector — is a
          suspected partition: HOLD (global unchanged, timer re-arms),
          at most ``partition_max_holds`` times, then ABANDON loudly.
        * Quorum met → CLOSE (the caller drops the missing and folds).
        * Otherwise → WAIT (re-arm and keep waiting)."""
        missing = tuple(sorted(set(expected) - set(received)))
        n = max(1, len(expected))
        miss_frac = len(missing) / n
        suspected = False
        reason = "quorum_met" if len(received) >= quorum else "below_quorum"
        if self.partition_frac > 0 and miss_frac >= self.partition_frac \
                and missing:
            evidence = self._round_dead_letters > 0
            why = f"dead_letters={self._round_dead_letters}"
            if not evidence and detector_states:
                states = [detector_states.get(s, "?") for s in missing]
                evidence = all(st in ("suspect", "dead") for st in states)
                why = f"detector={dict(zip(missing, states))}"
            if evidence:
                suspected = True
                reason = (f"correlated_miss {len(missing)}/{n} with "
                          f"network evidence ({why})")
            else:
                reason = (f"mass_miss {len(missing)}/{n} without network "
                          f"evidence (not a partition)")
        if suspected:
            if self._round_holds < self.partition_max_holds:
                self._round_holds += 1
                self.holds_total += 1
                self._c_holds.inc()
                action = "hold"
            else:
                action = "abandon"
                reason += f"; hold budget exhausted " \
                          f"({self.partition_max_holds})"
        elif len(received) >= quorum:
            action = "close"
        else:
            action = "wait"
        v = TimeoutVerdict(action=action, quorum=int(quorum),
                           received=len(received), missing=missing,
                           partition_suspected=suspected,
                           holds=self._round_holds, reason=reason)
        self._last_verdict = v
        return v

    # -- participation debt --------------------------------------------------

    def debt(self, silo: int) -> int:
        return int(self._debt.get(int(silo), 0))

    def max_debt(self) -> int:
        return max(self._debt.values(), default=0)

    def priority(self, candidates: Iterable[int]) -> List[int]:
        """Candidates ordered most-indebted first (ties by silo id, so
        the ordering is deterministic): the re-tasking order."""
        return sorted((int(c) for c in candidates),
                      key=lambda s: (-self._debt.get(s, 0), s))

    def priority_clients(self, limit: Optional[int] = None) -> List[int]:
        """Ids carrying debt > 0, most-indebted first — the guaranteed
        head of the next sampled cohort (see ``merge_priority``)."""
        out = [s for s in self.priority(self._debt)
               if self._debt.get(s, 0) > 0]
        return out if limit is None else out[:limit]

    # -- ledger --------------------------------------------------------------

    def as_ledger(self) -> dict:
        """The ``degrade={...}`` dict for the round's perf-ledger line:
        every decision this round, auditable after the fact."""
        md = self.max_debt()
        self._g_debt.set(md)
        out = {
            "deadline_s": (None if self._round_deadline is None
                           else round(self._round_deadline, 6)),
            "accepted": sorted(self._round_accepted),
            "dropped": sorted(set(self._round_dropped)),
            "holds": self._round_holds,
            "dead_letters": self._round_dead_letters,
            "debt_max": md,
            "faults": dict(self._fault_counts),
        }
        if self._last_verdict is not None:
            out["verdict"] = self._last_verdict.as_dict()
        return out

    # -- checkpoint (fixed-shape numpy, rides extra_state) -------------------

    def state_dict(self) -> dict:
        """Fixed-shape snapshot: the latency matrix (NaN-padded
        [n_silos, window] — row s-1 is silo s's newest-first history),
        per-silo debt, and the lifetime hold/drop/fault counters.  The
        deadline is a pure function of the latency matrix, so restoring
        this state re-derives the crashed process's deadline exactly."""
        lat = np.full((self.n_silos, self.window), np.nan, np.float64)
        for silo, hist in self._lat.items():
            vals = list(hist)
            if vals:
                lat[silo - 1, :len(vals)] = vals
        debt = np.zeros(self.n_silos, np.int64)
        for silo, d in self._debt.items():
            debt[silo - 1] = d
        faults = np.asarray([self._fault_counts[c] for c in FaultClass.ALL],
                            np.int64)
        return {"lat": lat, "debt": debt, "faults": faults,
                "holds_total": np.asarray(self.holds_total, np.int64),
                "drops_total": np.asarray(self.drops_total, np.int64)}

    def load_state_dict(self, state: dict) -> None:
        """Tolerant restore: an older snapshot (no degrade keys) or a
        foreign-shape matrix (silo count changed across the restart)
        warns and keeps zeros instead of refusing the resume."""
        lat = np.asarray(state.get("lat", ()))
        if lat.ndim == 2 and lat.shape[0] == self.n_silos:
            w = min(lat.shape[1], self.window)
            for silo in range(1, self.n_silos + 1):
                row = lat[silo - 1, :w]
                hist = self._lat[silo]
                hist.clear()
                for v in row[np.isfinite(row)]:
                    hist.append(float(v))
                # rebuild the phi moments from the restored history in
                # record order — deterministic given the matrix
                self._ewma_mean.pop(silo, None)
                self._ewma_var.pop(silo, None)
                mean = var = None
                for v in self._lat[silo]:
                    if mean is None:
                        mean, var = float(v), 0.0
                    else:
                        a = self.ewma_alpha
                        d = float(v) - mean
                        mean = mean + a * d
                        var = (1 - a) * (var + a * d * d)
                if mean is not None:
                    self._ewma_mean[silo] = mean
                    self._ewma_var[silo] = var
        elif "lat" in state:
            log.warning("degrade: latency matrix shape %s does not match "
                        "n_silos=%d/window=%d; starting reliability "
                        "history fresh", lat.shape, self.n_silos,
                        self.window)
        debt = np.asarray(state.get("debt", ()))
        if debt.ndim == 1 and debt.shape[0] == self.n_silos:
            for silo in range(1, self.n_silos + 1):
                self._debt[silo] = int(debt[silo - 1])
        faults = np.asarray(state.get("faults", ()))
        if faults.ndim == 1 and faults.shape[0] == len(FaultClass.ALL):
            for i, c in enumerate(FaultClass.ALL):
                self._fault_counts[c] = int(faults[i])
        if "holds_total" in state:
            self.holds_total = int(np.asarray(state["holds_total"]))
        if "drops_total" in state:
            self.drops_total = int(np.asarray(state["drops_total"]))
