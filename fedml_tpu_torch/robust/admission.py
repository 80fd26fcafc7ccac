"""Update admission pipeline: screen every upload before it may aggregate.

The port's copy of ``fedml_tpu/robust/admission.py`` (host numpy at
message rate: the wire delivers numpy, and the screens run before any
tensor is made).  An upload must pass, in order:

1. **fingerprint** — tree structure, shapes and dtypes must match the
   global params exactly;
2. **finite guard** — every float leaf NaN/Inf-free;
3. **sample-count validation** — ``num_samples`` present, finite,
   positive, and at most ``max_num_samples``;
4. **norm-outlier screen** — ``||upload - global||`` against the rolling
   median + k * MAD of recent accepted norms.

Every rejection is counted by reason (``fedml_robust_rejected_total``)
and strikes the silo in the `TrustTracker`: K strikes quarantine it for
``quarantine_rounds`` (weight 0, excluded from the quorum), then
probation: one strike re-jails, ``probation_rounds`` clean uploads
restore trust.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.robust.degrade import FaultClass

log = logging.getLogger(__name__)

# the closed set of rejection reasons (each is a labeled series of
# fedml_robust_rejected_total; tests assert the sum accounts for every
# rejected upload)
REASONS = ("quarantined", "fingerprint", "bad_num_samples", "nonfinite",
           "norm_outlier")


def _canon_key(k) -> str:
    """Canonical Mapping-key form shared by `params_fingerprint` and
    `_leaves`: the key TYPE is part of the identity (an int-keyed tree
    must NOT fingerprint equal to its str-keyed twin — their leaf
    orders differ, and later tree math would treedef-mismatch), and the
    str form gives a total order even across mixed key types."""
    return f"{type(k).__name__}:{k}"


def params_fingerprint(tree) -> object:
    """Codec-stable structural description of a params pytree: nested
    plain containers with ``(shape, dtype)`` leaves.  Mapping flavors
    (dict / flax FrozenDict) normalize to plain dicts keyed by
    `_canon_key`, so a tree that went through the wire codec
    fingerprints identically to the live global it must match — while
    a key-type-confused payload (int keys posing as str keys) does
    NOT match."""
    if hasattr(tree, "items"):
        return {_canon_key(k): params_fingerprint(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_fingerprint(v) for v in tree]
    arr = np.asarray(tree)
    return (tuple(arr.shape), np.dtype(arr.dtype).str)


def _leaves(tree) -> List[np.ndarray]:
    """Flatten in `_canon_key` order — the SAME canonicalization as
    `params_fingerprint` (only called on trees whose fingerprints
    already matched, so two flattenings zip leaf-for-leaf)."""
    if hasattr(tree, "items"):
        out: List[np.ndarray] = []
        for _, v in sorted(tree.items(),
                           key=lambda kv: _canon_key(kv[0])):
            out.extend(_leaves(v))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(_leaves(v))
        return out
    return [np.asarray(tree)]


def _all_finite(tree) -> bool:
    for leaf in _leaves(tree):
        if np.issubdtype(leaf.dtype, np.floating) \
                and not np.isfinite(leaf).all():
            return False
    return True


def update_sumsq(upload, reference_leaves) -> float:
    """f64 ``sum((upload - reference)^2)`` over all leaves — the
    partial the sharded admission (`shard_spine.admission`)
    computes per shard slice and combines across shards, so the
    per-silo norm it screens is the SAME quantity this module screens
    on the replicated path.  ``reference_leaves``: pre-flattened f64
    host leaves (the per-round cache — never a fresh device transfer
    per upload)."""
    total = 0.0
    for u, g in zip(_leaves(upload), reference_leaves):
        d = u.astype(np.float64) - g
        total += float(np.sum(d * d))
    return total


def _update_norm(upload, reference_leaves) -> float:
    """||upload - reference||_2 over all leaves in f64 (host math; the
    screen must not be fooled by f32 overflow on a scale attack)."""
    return math.sqrt(update_sumsq(upload, reference_leaves))


def _norm(tree) -> float:
    total = 0.0
    for u in _leaves(tree):
        d = u.astype(np.float64)
        total += float(np.sum(d * d))
    return math.sqrt(total)


# public aliases for the sharded admission (shard_spine/admission.py),
# which screens per shard slice with EXACTLY these canonicalizations —
# aliasing (not copying) means the two screens can never drift apart
flatten_leaves = _leaves
all_finite = _all_finite


def norm_outlier_threshold(norms, k: float,
                           min_history: int) -> Optional[float]:
    """THE norm-outlier threshold formula: ``median + k * max(MAD, 5% of
    median, 1e-12)`` over the banked accepted norms, or None while fewer
    than ``min_history`` are banked (warm-up stays silent).  Robust
    statistics — up to half the history being poisoned cannot drag the
    threshold up; the MAD floor keeps a freakishly-uniform history from
    rejecting benign jitter.  Shared by the per-upload screen below and
    the sharded spine's combined-norm screen, so the two can never drift
    apart."""
    if len(norms) < min_history:
        return None
    arr = np.asarray(norms, np.float64)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    return med + k * max(mad, 0.05 * med, 1e-12)


class TrustTracker:
    """Per-silo strike ledger: TRUSTED → QUARANTINED → PROBATION → TRUSTED.

    * every rejected upload is a **strike**; ``strikes_to_quarantine``
      strikes quarantine the silo until ``round + quarantine_rounds``;
    * while quarantined the silo contributes weight 0 and is excluded
      from the round quorum (the server actors treat it like a
      FailureDetector-dead silo — the barrier never waits on it);
    * quarantine expiry moves the silo to **probation**: it is tasked
      and screened normally, but ONE strike re-quarantines immediately,
      and ``probation_rounds`` clean accepted uploads restore trust;
    * while trusted, each clean upload decays one old strike, so honest
      silos with occasional wire corruption never ratchet into
      quarantine.

    ``events`` keeps a ``(round, silo, event)`` audit log — the trail
    tests and the run_byzantine demo assert on.  It is BOUNDED at
    insert time (``events_window`` newest entries): at mega-cohort
    scale a seeded adversary fleet strikes O(cohort) times per round,
    and an append-only log would grow without bound for the life of
    the federation — the same cap-at-insert discipline as the norm
    screen's ``norm_window`` deque, so the whole admission subsystem
    holds O(window + silos) state regardless of cohort size.

    Trust is DURABLE state: `state_dict` / `load_state_dict` ride the
    server's ``extra_state`` checkpoint hook, so a crash-resumed server
    keeps every strike, quarantine sentence, and probation clock.  It
    was originally left soft ("re-learn within strikes_to_quarantine
    rounds of fresh evidence"), but that contract releases a jailed
    attacker EARLY on every server crash — a crash-loop (or an attacker
    who can induce one) resets all sentences, so quarantine must survive
    the process.  The bounded
    ``events`` audit log and the norm screen's rolling history stay
    soft — they affect no admission verdict's correctness, only
    reporting and the screen's warm-up.
    """

    TRUSTED = "trusted"
    QUARANTINED = "quarantined"
    PROBATION = "probation"

    def __init__(self, strikes_to_quarantine: int = 3,
                 quarantine_rounds: int = 4, probation_rounds: int = 2,
                 events_window: int = 4096):
        if events_window < 1:
            raise ValueError(f"events_window must be >= 1, got "
                             f"{events_window}")
        if strikes_to_quarantine < 1:
            raise ValueError(f"strikes_to_quarantine must be >= 1, got "
                             f"{strikes_to_quarantine}")
        if quarantine_rounds < 1:
            raise ValueError(f"quarantine_rounds must be >= 1, got "
                             f"{quarantine_rounds}")
        if probation_rounds < 0:
            raise ValueError(f"probation_rounds must be >= 0, got "
                             f"{probation_rounds}")
        self.strikes_to_quarantine = strikes_to_quarantine
        self.quarantine_rounds = quarantine_rounds
        self.probation_rounds = probation_rounds
        self._strikes: Dict[int, int] = {}
        self._quarantine_until: Dict[int, int] = {}   # silo -> first free round
        self._probation_left: Dict[int, int] = {}
        # per-silo strike counts BY ATTRIBUTION CLASS: the
        # invariant above means only the payload column can ever be
        # nonzero, but the full matrix rides state_dict so the claim
        # "zero network-attributed strikes" survives a crash and is
        # auditable from any checkpoint
        self._strike_faults: Dict[str, Dict[int, int]] = {
            c: {} for c in FaultClass.ALL}
        self.events: Deque[Tuple[int, int, str]] = collections.deque(
            maxlen=events_window)
        reg = telemetry.get_registry()
        self._c_strikes = reg.counter("fedml_robust_strikes_total")
        self._c_quarantines = reg.counter(
            "fedml_robust_quarantine_events_total")
        self._g_quarantined = reg.gauge("fedml_robust_quarantined_total")

    def state(self, silo: int, round_idx: int) -> str:
        until = self._quarantine_until.get(silo)
        if until is not None:
            if round_idx < until:
                return self.QUARANTINED
            # lazy expiry: the first query past the sentence starts
            # probation (symmetric to FailureDetector's sticky-DEAD
            # cleared by the next beat)
            del self._quarantine_until[silo]
            if self.probation_rounds > 0:
                self._probation_left[silo] = self.probation_rounds
                self.events.append((round_idx, silo, "probation"))
                return self.PROBATION
            self.events.append((round_idx, silo, "trusted"))
            return self.TRUSTED
        if self._probation_left.get(silo, 0) > 0:
            return self.PROBATION
        return self.TRUSTED

    def strike(self, silo: int, round_idx: int, reason: str,
               fault: str = FaultClass.PAYLOAD) -> bool:
        """Record a strike; returns True when this strike QUARANTINES.

        ``fault`` is the attribution class, and the hard
        invariant lives HERE, at the one strike call site: only
        ``payload`` verdicts may strike.  A ``network`` or ``unknown``
        fault reaching this method is a programming error — network
        failures (dead letters, deadline drops, partitions) belong to
        the reliability tracker (`robust/degrade.ReliabilityTracker`),
        never to the trust ledger, or a chaotic link could walk an
        honest silo into Byzantine quarantine."""
        if fault not in FaultClass.ALL:
            raise ValueError(f"unknown fault class {fault!r}; the "
                             f"vocabulary is closed: {FaultClass.ALL}")
        if fault != FaultClass.PAYLOAD:
            raise ValueError(
                f"only payload-attributed verdicts may strike trust "
                f"(got fault={fault!r}, reason={reason!r}, silo={silo}) "
                f"— route network/unknown faults to the reliability "
                f"tracker instead (the attribution invariant)")
        self._strike_faults[fault][silo] = \
            self._strike_faults[fault].get(silo, 0) + 1
        self._c_strikes.inc()
        state = self.state(silo, round_idx)
        if state == self.QUARANTINED:
            return False  # already serving — nothing escalates
        self._strikes[silo] = self._strikes.get(silo, 0) + 1
        if state == self.PROBATION \
                or self._strikes[silo] >= self.strikes_to_quarantine:
            self._strikes[silo] = 0
            self._probation_left.pop(silo, None)
            self._quarantine_until[silo] = round_idx + self.quarantine_rounds
            self._c_quarantines.inc()
            self.events.append((round_idx, silo, f"quarantined:{reason}"))
            log.warning("silo %d quarantined at round %d (reason=%s) until "
                        "round %d", silo, round_idx, reason,
                        self._quarantine_until[silo])
            return True
        return False

    def record_clean(self, silo: int, round_idx: int) -> None:
        """An accepted upload: burn one probation round / decay a strike."""
        state = self.state(silo, round_idx)
        if state == self.PROBATION:
            self._probation_left[silo] -= 1
            if self._probation_left[silo] <= 0:
                del self._probation_left[silo]
                self._strikes.pop(silo, None)
                self.events.append((round_idx, silo, "trusted"))
        elif state == self.TRUSTED and self._strikes.get(silo, 0) > 0:
            self._strikes[silo] -= 1

    def state_dict(self, n_silos: int) -> Dict[str, np.ndarray]:
        """Fixed-shape host snapshot for the round-checkpoint
        ``extra_state`` hook (restart-independent shapes — the same
        structure doubles as the orbax restore template): slot ``i``
        holds silo ``i+1``'s strikes / first-free-round (-1 = not
        quarantined) / probation rounds left.  Silos beyond ``n_silos``
        (none in a fixed deployment) are dropped with a warning rather
        than silently truncated."""
        strikes = np.zeros(n_silos, np.int64)
        until = np.full(n_silos, -1, np.int64)
        probation = np.zeros(n_silos, np.int64)
        for tgt, src in ((strikes, self._strikes),
                         (until, self._quarantine_until),
                         (probation, self._probation_left)):
            for silo, v in src.items():
                if 1 <= silo <= n_silos:
                    tgt[silo - 1] = int(v)
                else:
                    log.warning("trust state_dict: silo %d outside 1..%d "
                                "not persisted", silo, n_silos)
        # [n_silos, |FaultClass.ALL|] strike counts by attribution class
        # column order is FaultClass.ALL
        strike_reasons = np.zeros((n_silos, len(FaultClass.ALL)), np.int64)
        for col, cls in enumerate(FaultClass.ALL):
            for silo, v in self._strike_faults[cls].items():
                if 1 <= silo <= n_silos:
                    strike_reasons[silo - 1, col] = int(v)
        return {"strikes": strikes, "quarantine_until": until,
                "probation_left": probation,
                "strike_reasons": strike_reasons}

    def load_state_dict(self, state) -> None:
        """Restore a `state_dict` snapshot (resume path): sentences and
        probation clocks continue from where the crashed process left
        them — a quarantined attacker stays jailed.

        ``strike_reasons`` restores tolerantly: a pre-19 snapshot
        carries no attribution matrix, and a foreign-shape one (the
        fault vocabulary or silo count changed across the restart)
        cannot be mapped — both accept with a warning (counts restart
        at zero) instead of refusing the resume."""
        strikes = np.asarray(state["strikes"])
        until = np.asarray(state["quarantine_until"])
        probation = np.asarray(state["probation_left"])
        self._strikes = {i + 1: int(v) for i, v in enumerate(strikes)
                         if v > 0}
        self._quarantine_until = {i + 1: int(v)
                                  for i, v in enumerate(until) if v >= 0}
        self._probation_left = {i + 1: int(v)
                                for i, v in enumerate(probation) if v > 0}
        self._strike_faults = {c: {} for c in FaultClass.ALL}
        sr = state.get("strike_reasons") if hasattr(state, "get") else None
        if sr is None:
            log.warning("trust snapshot carries no strike_reasons (pre-19 "
                        "checkpoint); attribution counts restart at zero")
            return
        sr = np.asarray(sr)
        if sr.ndim != 2 or sr.shape[1] != len(FaultClass.ALL):
            log.warning("trust snapshot strike_reasons shape %s does not "
                        "match the %d-class fault vocabulary; attribution "
                        "counts restart at zero", sr.shape,
                        len(FaultClass.ALL))
            return
        for col, cls in enumerate(FaultClass.ALL):
            for i in range(sr.shape[0]):
                if sr[i, col] > 0:
                    self._strike_faults[cls][i + 1] = int(sr[i, col])

    def quarantined(self, round_idx: int, silos=None) -> set:
        """The silos serving quarantine at ``round_idx`` (sweeps states,
        so expiry → probation transitions happen here; refreshes the
        quarantine gauge)."""
        pool = (set(silos) if silos is not None
                else set(self._quarantine_until))
        out = {s for s in pool
               if self.state(s, round_idx) == self.QUARANTINED}
        self._g_quarantined.set(len(out))
        return out

    def strike_fault_totals(self) -> Dict[str, int]:
        """Lifetime strike count per attribution class (only ``payload``
        is ever non-zero: the attribution invariant)."""
        return {c: sum(self._strike_faults[c].values())
                for c in FaultClass.ALL}


@dataclasses.dataclass
class AdmissionVerdict:
    """The screen's full output — callers must not recompute any of it.

    ``norm`` is the f64 update norm the pipeline already paid one
    O(model) pass for (``||upload - global||`` for params,
    ``||delta||`` for deltas): the health observatory
    (`obs/health.HealthAccumulator.observe_admitted`) and telemetry
    consume it from here, so defense, health, and metrics share ONE
    pass over the payload instead of three.  It is set on every accept
    and on norm-outlier rejects; ``None`` means an earlier screen
    (fingerprint / finite / sample-count) rejected before the norm was
    ever computed."""
    ok: bool
    reason: Optional[str] = None     # one of REASONS when rejected
    num_samples: float = 0.0         # sanitized weight (valid when ok)
    norm: Optional[float] = None     # update norm (None if screened earlier)


class AdmissionPipeline:
    """The per-upload screen in front of both distributed server actors.

    ``template``: the global params at federation start — its structural
    fingerprint is the contract every upload must match.  ``kind``:
    ``"params"`` (cross-silo uploads are full parameter trees; the norm
    screened is ``||upload - global||``), ``"delta"`` (async uploads
    are updates already; the norm is ``||delta||``) or ``"masked"``
    (secure aggregation: the template is `secure.protocol.
    masked_template`, and only the screens that mean something on
    ciphertext run — the structural fingerprint and ``num_samples``;
    the norm of ring words is PRG noise, so the server's post-unmask sum
    screen stands in for it).

    The norm screen keeps the last ``norm_window`` ACCEPTED norms and
    rejects ``norm > median + norm_k * max(MAD, 5% of median)`` once
    ``norm_min_history`` norms are banked — robust statistics, so up to
    half the history being poisoned cannot drag the threshold up, and
    the screen stays silent during warm-up instead of rejecting honest
    round-0 variance.  The MAD floor keeps a freakishly-uniform history
    (MAD 0) from rejecting benign jitter.
    """

    def __init__(self, template, *, kind: str = "params",
                 max_num_samples: float = 1e6,
                 norm_k: float = 6.0, norm_window: int = 64,
                 norm_min_history: int = 8,
                 trust: Optional[TrustTracker] = None):
        if kind not in ("params", "delta", "masked"):
            raise ValueError(f"kind must be 'params', 'delta', or "
                             f"'masked', got {kind!r}")
        if max_num_samples < 0:
            raise ValueError(f"max_num_samples must be >= 0 (0 disables the "
                             f"cap), got {max_num_samples}")
        if norm_window < 1 or norm_min_history < 1:
            raise ValueError("norm_window and norm_min_history must be >= 1")
        self.kind = kind
        self.fingerprint = params_fingerprint(template)
        self.max_num_samples = max_num_samples
        self.norm_k = norm_k
        self.norm_min_history = norm_min_history
        self._norms: Deque[float] = collections.deque(maxlen=norm_window)
        self.trust = trust if trust is not None else TrustTracker()
        reg = telemetry.get_registry()
        self._c_admitted = reg.counter("fedml_robust_admitted_total")
        self._c_rejected = {r: reg.counter("fedml_robust_rejected_total",
                                           reason=r) for r in REASONS}
        self._h_norm = reg.histogram(
            "fedml_robust_update_norm_total",
            buckets=(0.01, 0.1, 0.5, 1, 2, 5, 10, 50, 100, 1000, 1e5))
        # reason -> count mirror for in-process assertions (tests, demo)
        self.rejected: Dict[str, int] = {r: 0 for r in REASONS}
        self.admitted = 0
        # identity-keyed host copy of the reference globals: ONE
        # device->host transfer per round, not one per upload (the same
        # idiom as the wire-decompression cache in experiments/main.py)
        self._ref_cache: Tuple[object, Optional[list]] = (None, None)

    def _reject(self, silo: int, round_idx: int, reason: str,
                norm: Optional[float] = None) -> AdmissionVerdict:
        self.rejected[reason] += 1
        self._c_rejected[reason].inc()
        if reason != "quarantined":
            # serving quarantine is not a NEW offense — strikes come
            # from fresh evidence only
            self.trust.strike(silo, round_idx, reason)
        return AdmissionVerdict(False, reason=reason, norm=norm)

    def reject(self, silo: int, round_idx: int,
               reason: str) -> AdmissionVerdict:
        """Administrative rejection for structural damage detected
        UPSTREAM of `admit` (compression-handshake mismatch, a frame the
        codec itself cannot decode): counted and struck exactly like a
        pipeline rejection, so the accounting invariant — every rejected
        upload appears in ``fedml_robust_rejected_total`` — holds."""
        if reason not in REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}; "
                             f"available: {REASONS}")
        return self._reject(silo, round_idx, reason)

    def _reference_leaves(self, global_params) -> list:
        if self._ref_cache[0] is not global_params:
            self._ref_cache = (global_params,
                               [np.asarray(leaf, np.float64)
                                for leaf in _leaves(global_params)])
        return self._ref_cache[1]

    def norm_threshold(self) -> Optional[float]:
        return norm_outlier_threshold(self._norms, self.norm_k,
                                      self.norm_min_history)

    def admit(self, silo: int, upload, num_samples, global_params,
              round_idx: int, pre=None) -> AdmissionVerdict:
        """Screen one upload.  ``global_params`` is the CURRENT global
        (the reference point for ``kind="params"`` norms; ignored for
        deltas).  Order matters: structural checks run before any tree
        math touches the payload.

        ``pre`` (a `comm.ingest.ArenaScreen`, the JAX seam of
        ``robust/admission.py:513-514``) carries the ingest arena's
        screen: its header check stands in for the fingerprint and its
        device reduction for the host finite and norm passes.  The
        verdict order is the same; only who computed each fact
        changes."""
        if self.trust.state(silo, round_idx) == TrustTracker.QUARANTINED:
            return self._reject(silo, round_idx, "quarantined")
        if pre is not None:
            fp_ok = pre.structural_ok
        else:
            try:
                fp_ok = params_fingerprint(upload) == self.fingerprint
            except Exception:  # noqa: BLE001 — unhashable garbage payload
                fp_ok = False
        if not fp_ok:
            return self._reject(silo, round_idx, "fingerprint")
        try:
            n = float(num_samples)
        except (TypeError, ValueError):
            n = float("nan")
        if not math.isfinite(n) or n <= 0 \
                or (self.max_num_samples > 0 and n > self.max_num_samples):
            return self._reject(silo, round_idx, "bad_num_samples")
        if self.kind == "masked":
            # ring words: the finite guard is vacuous and a norm measures
            # PRG noise; the sum-level screens run after the unmask
            self.admitted += 1
            self._c_admitted.inc()
            self.trust.record_clean(silo, round_idx)
            return AdmissionVerdict(True, num_samples=n, norm=None)
        if not (pre.finite if pre is not None else _all_finite(upload)):
            return self._reject(silo, round_idx, "nonfinite")
        norm = (pre.norm if pre is not None else
                _update_norm(upload, self._reference_leaves(global_params))
                if self.kind == "params" else _norm(upload))
        self._h_norm.observe(norm)
        thresh = self.norm_threshold()
        if thresh is not None and norm > thresh:
            return self._reject(silo, round_idx, "norm_outlier", norm)
        self._norms.append(norm)
        self.admitted += 1
        self._c_admitted.inc()
        self.trust.record_clean(silo, round_idx)
        return AdmissionVerdict(True, num_samples=n, norm=norm)
