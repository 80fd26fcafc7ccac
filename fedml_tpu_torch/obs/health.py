"""Federation health observatory: streaming learning-health statistics
on the receive path (the port's copy of ``fedml_tpu/obs/health.py``).

The perf ledger makes the *machine* observable (phase wall-times, RSS,
recompiles); this module makes the *learning process* observable.  Once the stream
fold (`core/stream_agg.py`) consumes an upload at arrival, nothing
downstream can ever ask "were the cohort's updates coherent, who is
drifting, which silo never participates?" — the evidence is destroyed on
the receive path.  So the statistics are computed there too, FedJAX-style
per-client metric aggregation (arXiv 2108.02117) fused with the
Smart-NIC argument (arXiv 2307.06561) that per-upload processing belongs
in the receive path: every stat folds at arrival in **O(model) +
O(silos)** standing state, never a post-hoc scan of retained uploads —
the contract the mega-cohort north star (1k–100k sampled clients per
round) requires.

Per-round statistics (one ``health.jsonl`` line per round/version, the
same torn-tail-tolerant single-``write()`` O_APPEND contract as
``perf.jsonl``):

* **update-norm running moments** — mean/var/min/max via Welford over
  the admitted update norms.  The norm itself is REUSED from the
  `AdmissionVerdict` the admission pipeline already computed (one
  O(model) pass shared by defense, health, and telemetry — computed here
  only when no screen ran);
* **cosine alignment** — each admitted upload's update direction against
  the round's running weighted-mean direction so far (one dot product
  against O(model) state — the same fold-at-arrival state shape
  `StreamingAggregator` holds; health keeps its own f32 host work
  vector so stream and stack mode emit IDENTICAL lines, pinned by
  test).  Past ``sketch_coords`` model coordinates the statistics ride
  a deterministic proportional-prefix coordinate sketch, bounding
  per-upload health work at O(cap) for arbitrarily large models —
  sketched norms rescale by sqrt(total/m), cosines are
  subspace-exact, and the admission screen (a *defense*) still walks
  the full payload either way;
* **per-silo fairness counters** — tasked/accepted/rejected/dropped/
  excluded counts, staleness, and rounds-since-last-accept per silo
  (O(silos) state, bounded by the deployment);
* **global round-over-round delta norm** — how far the aggregate
  actually moved the model;
* **per-edge rollups** — under the multi-level topology each
  `EdgeAggregatorActor` ships its compact summary inside the existing
  per-round edge frame (`Message.ARG_HEALTH`; the tree stays
  one-frame-per-round) and the root merges the edge moments exactly
  (Chan's parallel-Welford combine) beside its own edge-tier stats.

Drift/anomaly detection: three alarms evaluated at round close, each a
``larger-is-worse`` ratio so the `SloEvaluator` (and
``/healthz?deep=1``) can gate on the exported gauges with its existing
``value <= threshold`` contract — thresholds configurable through the
same ``--slo`` spec:

* ``health_misalignment_ratio`` = 1 - mean cosine alignment (alignment
  collapse: the cohort's updates stopped agreeing on a direction);
* ``health_norm_cv_ratio`` = std/mean of admitted update norms (norm
  variance blowup: somebody's updates are wildly out of scale);
* ``health_starvation_ratio`` = fraction of known silos with no
  accepted upload for ``starve_after`` consecutive rounds
  (participation starvation: fairness accounting — quarantine,
  dead-drop, or scheduler bias is freezing silos out).

The statistics are host-side numpy at message rate.  An upload staged
on the card (the ingest arena's device views) is cut to its sketch on
the device and reaches the host in one copy of at most
``sketch_coords`` coordinates, read on the stream the arena's copy was
ordered before; nothing here builds anything for the recompile sentry
to watch.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

# default alarm thresholds — merged into `obs/perf.DEFAULT_SLOS`, so the
# --slo spec ("health_misalignment_ratio=0.8,...") overrides them and a
# typo'd name fails loudly at config time like every other objective.
#
# Calibration note (misalignment = 1 - mean cosine): an honest but
# HETEROGENEOUS cohort trains near-orthogonal update directions — mean
# cosine ~0, misalignment ~1.0 — so the safe-by-default threshold sits
# at 1.5 (mean cosine below -0.5: a coordinated anti-aligned mass, the
# sign-flip-fleet signature).  An iid/homogeneous deployment whose
# healthy cosine sits near 1 should tighten it via --slo
# ("health_misalignment_ratio=0.5").  Scale/inflate attacks show up in
# norm_cv instead: honest cohorts' update norms are tight (cv ~0.1),
# one 30x-scaled attacker in a small cohort pushes cv past 1.
HEALTH_SLOS = {
    "health_misalignment_ratio": 1.5,   # 1 - mean cosine alignment
    "health_norm_cv_ratio": 1.0,        # std/mean of update norms
    "health_starvation_ratio": 0.5,     # starved / known silos
}

# alarm name (ledger + breach-counter label) per SLO objective
ALARMS = {
    "health_misalignment_ratio": "alignment_collapse",
    "health_norm_cv_ratio": "norm_variance_blowup",
    "health_starvation_ratio": "participation_starvation",
}


def _tree_leaves(tree) -> list:
    """The leaves of an upload or a global in the JAX package's canonical
    order (`robust.admission._leaves`): a nested dict walks its keys
    sorted, a flat dict keyed by flax path is nested first, so both
    layouts flatten alike.  Leaves stay where they are (numpy arrays or
    tensors on any device)."""
    from fedml_tpu_torch.core.pytree import nest
    from fedml_tpu_torch.robust.admission import _canon_key

    def walk(t, out):
        if hasattr(t, "items"):
            for _, v in sorted(t.items(), key=lambda kv: _canon_key(kv[0])):
                walk(v, out)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, out)
        else:
            out.append(t)
        return out

    if hasattr(tree, "items") and any(
            isinstance(k, str) and "/" in k for k in tree):
        tree = nest(dict(tree))
    return walk(tree, [])


def _sketch_f32(tree, cap: int):
    """The health work vector: an f32 flatten in canonical leaf order,
    coordinate-SKETCHED past ``cap`` total coordinates — each leaf
    contributes a proportional contiguous prefix, so the sketch is the
    same fixed linear subspace for every upload of the round (and
    across agg modes / topologies: it depends only on the tree's leaf
    shapes).  Returns ``(vec, scale)`` where ``scale = sqrt(total/m)``
    un-biases a sketched norm back to the full-vector estimate (cosines
    need no correction — the factor cancels).

    Tensor leaves (an arena's staged upload, a global on the card) are
    cut and concatenated where they live, and the work vector comes to
    the host in ONE copy of at most ``cap`` coordinates; the arithmetic
    after it is the JAX package's numpy, so a line is bit-equal to
    JAX's on the same uploads."""
    import torch
    leaves = _tree_leaves(tree)
    flat = [l.reshape(-1) if torch.is_tensor(l)
            else np.asarray(l).reshape(-1) for l in leaves]
    total = sum(int(l.numel() if torch.is_tensor(l) else l.size)
                for l in flat)
    if total == 0:
        return np.zeros(0, np.float32), 1.0
    scale = 1.0
    if not (cap <= 0 or total <= cap):
        parts = []
        for l in flat:
            n = int(l.numel() if torch.is_tensor(l) else l.size)
            parts.append(l[:max(1, (n * cap) // total)])
        flat = parts
        took = sum(int(p.numel() if torch.is_tensor(p) else p.size)
                   for p in parts)
        scale = math.sqrt(total / took)
    tensors = [p for p in flat if torch.is_tensor(p)]
    if tensors:
        dev = tensors[0].device
        vec = torch.cat([
            (p if torch.is_tensor(p) else torch.from_numpy(np.asarray(p)))
            .to(device=dev, dtype=torch.float32) for p in flat])
        return vec.cpu().numpy(), scale
    if len(flat) == 1:
        return flat[0].astype(np.float32, copy=False), scale
    return np.concatenate([p.astype(np.float32, copy=False)
                           for p in flat]), scale


def _finite(v) -> Optional[float]:
    """JSON-safe float: non-finite values ledger as null, never as the
    bare NaN token that breaks every downstream json.loads."""
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else None


class Welford:
    """Streaming mean/variance/min/max — one O(1) update per value, so
    the moments of a 100k-upload round cost the same state as an
    8-upload one."""

    __slots__ = ("count", "mean", "m2", "min", "max")

    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def push(self, x: float) -> None:
        x = float(x)
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x

    @property
    def var(self) -> float:
        """Population variance (ddof=0) — the alarm-facing moment; a
        1-value round has zero variance, not an undefined one."""
        return self.m2 / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def summary(self) -> dict:
        return {"count": self.count,
                "mean": _finite(self.mean) if self.count else None,
                "std": _finite(self.std) if self.count else None,
                "min": _finite(self.min), "max": _finite(self.max)}


def merge_moments(summaries: List[dict]) -> dict:
    """Chan's parallel combine over `Welford.summary()` dicts — the root
    merges per-edge norm moments into cohort-level moments EXACTLY (same
    count/mean/var as one pass over all uploads, up to fp association),
    without any upload ever crossing the edge tier."""
    count, mean, m2 = 0, 0.0, 0.0
    mn = mx = None
    for s in summaries:
        if not s or not s.get("count"):
            continue
        n_b = int(s["count"])
        mean_b = float(s["mean"])
        var_b = float(s["std"] or 0.0) ** 2
        delta = mean_b - mean
        tot = count + n_b
        m2 += var_b * n_b + delta * delta * count * n_b / tot
        mean += delta * n_b / tot
        count = tot
        if s.get("min") is not None:
            mn = s["min"] if mn is None else min(mn, s["min"])
        if s.get("max") is not None:
            mx = s["max"] if mx is None else max(mx, s["max"])
    out = Welford()
    out.count, out.mean, out.m2, out.min, out.max = count, mean, m2, mn, mx
    return out.summary()


class _SiloHealth:
    """Cross-round fairness ledger for one silo (O(1) each, O(silos)
    total — the only state that outlives a round besides thresholds)."""

    __slots__ = ("tasked", "accepted", "rejected", "dropped", "excluded",
                 "staleness_sum", "staleness_n", "rounds_since_accept",
                 "last_accept_round")

    def __init__(self):
        self.tasked = 0
        self.accepted = 0
        self.rejected = 0
        self.dropped = 0
        self.excluded = 0
        self.staleness_sum = 0.0
        self.staleness_n = 0
        self.rounds_since_accept = 0
        self.last_accept_round: Optional[int] = None

    def summary(self) -> dict:
        out = {"tasked": self.tasked, "accepted": self.accepted,
               "rejected": self.rejected, "dropped": self.dropped,
               "excluded": self.excluded,
               "rounds_since_accept": self.rounds_since_accept,
               "last_accept_round": self.last_accept_round}
        if self.staleness_n:
            out["mean_staleness"] = _finite(
                self.staleness_sum / self.staleness_n)
        return out


def compact_summary(line: dict) -> dict:
    """The subset of a health line an edge ships inside its per-round
    frame: small, pure-Python, codec-safe — the tree stays
    one-frame-per-round (the model mean dwarfs this by orders of
    magnitude)."""
    return {k: line[k] for k in
            ("uploads", "accepted", "rejected", "dropped", "weight",
             "norm", "alignment", "global_delta_norm") if k in line}


class HealthAccumulator:
    """Per-round learning-health statistics on the admission-accept →
    fold seam of both live servers and the edge actors.

    Round protocol (mirrors `PerfRecorder`)::

        h.round_start(round_idx, reference, expected=[...])
        h.observe_admitted(silo, upload, weight, norm=..., staleness=...)
        h.observe_rejected(silo, reason)        # per inadmissible upload
        h.note_edge(edge_id, summary)           # root, per edge frame
        line = h.round_end(round_idx, new_global=...)

    ``kind="params"`` (sync uploads are parameter trees; the update is
    ``upload - reference``) or ``"delta"`` (async uploads ARE updates).
    ``reference`` at round_start is the round's global either way — the
    delta-norm baseline; for params kind it is also the per-upload
    update reference.

    ``ledger_path``: one ``health.jsonl`` line per round, formatted fully
    and written with ONE O_APPEND ``write()`` (crash tears at most the
    tail; `trend.load_ledger` / `report.load_jsonl` both tolerate it).
    An existing file rotates to ``.prev`` like ``perf.jsonl`` — one
    ledger, one run.

    ``alarms=False`` (edge actors): statistics only — no gauges, no
    breach counters, no ledger; the root owns the verdicts.

    Thread-safety: observation may run on receive threads while the
    round closes on the event loop — one lock guards the per-round
    state, the same discipline as `PerfRecorder`'s phase dict.
    """

    def __init__(self, *, kind: str = "params", node: str = "server",
                 ledger_path: Optional[str] = None,
                 thresholds: Optional[dict] = None,
                 starve_after: int = 3, alarms: bool = True,
                 sketch_coords: int = 1_000_000,
                 suppress_payload: Optional[str] = None,
                 registry=None):
        """``sketch_coords``: past this many model coordinates the
        per-upload statistics ride a deterministic proportional-prefix
        coordinate sketch (`_sketch_f32`) instead of the full vector —
        bounding health work per upload at O(cap) for arbitrarily large
        models (0 = always exact).  Sketched norms are rescaled by
        sqrt(total/m); cosines need no correction.

        ``suppress_payload``: a REASON string (e.g.
        ``"secagg_pairwise_masking"``) that disables every payload-
        derived statistic — update-norm moments and cosine alignment —
        because the uploads are ciphertext and per-silo learning stats
        are unavailable BY CONSTRUCTION (the privacy↔observability
        trade of secure aggregation).  Fairness counters, participation,
        and the round-over-round global delta norm (computed on the
        published PLAINTEXT global) keep working, and every ledger line
        carries a ``suppressed`` section NAMING the missing fields and
        the reason — the observatory degrades honestly, never to a
        silent zero that reads as 'perfectly aligned cohort'."""
        if kind not in ("params", "delta"):
            raise ValueError(f"kind must be 'params' or 'delta', got {kind!r}")
        if starve_after < 1:
            raise ValueError(f"starve_after must be >= 1, got {starve_after}")
        unknown = set(thresholds or {}) - set(HEALTH_SLOS)
        if unknown:
            raise ValueError(f"unknown health thresholds {sorted(unknown)}; "
                             f"available: {sorted(HEALTH_SLOS)}")
        self.kind = kind
        self.node = node
        self.path = ledger_path
        self._ledger_disabled = False
        self.thresholds = {**HEALTH_SLOS, **(thresholds or {})}
        self.starve_after = starve_after
        self.alarms_enabled = alarms
        self.sketch_coords = int(sketch_coords)
        self.suppress_payload = suppress_payload
        if ledger_path:
            d = os.path.dirname(ledger_path)
            if d:
                os.makedirs(d, exist_ok=True)
            if os.path.exists(ledger_path):
                # one ledger == one run (the perf.jsonl rotation contract):
                # splicing a previous run's rounds would poison every
                # reader's round-over-round view
                os.replace(ledger_path, ledger_path + ".prev")
        reg = registry if registry is not None else telemetry.get_registry()
        self._g = {
            "norm_mean": reg.gauge("fedml_health_update_norm_mean_value"),
            "norm_max": reg.gauge("fedml_health_update_norm_max_value"),
            "norm_cv": reg.gauge("fedml_health_norm_cv_ratio"),
            "align_mean": reg.gauge("fedml_health_alignment_mean_ratio"),
            "misalign": reg.gauge("fedml_health_misalignment_ratio"),
            "starvation": reg.gauge("fedml_health_starvation_ratio"),
            "starved": reg.gauge("fedml_health_starved_silos_total"),
            "participation": reg.gauge("fedml_health_participation_ratio"),
            "delta_norm": reg.gauge("fedml_health_global_delta_norm_value"),
        }
        self._c_rounds = reg.counter("fedml_health_rounds_total")
        self._c_breaches = {slo: reg.counter("fedml_health_breaches_total",
                                             alarm=alarm)
                            for slo, alarm in ALARMS.items()}
        self._lock = threading.Lock()
        self._silos: Dict[int, _SiloHealth] = {}
        self.last_line: Optional[dict] = None
        self._round: Optional[int] = None
        self._reset_round_state()

    def _reset_round_state(self) -> None:
        self._norms = Welford()
        self._aligns = Welford()
        self._stale = Welford()
        self._ref_vec: Optional[np.ndarray] = None  # f32 (sketched) global
        self._ref_scale = 1.0   # sqrt(total/m) norm un-bias factor
        self._dir_sum: Optional[np.ndarray] = None  # running weighted update
        self._dir_sq = 0.0   # ||dir_sum||^2, maintained incrementally:
        #                      ||s + w*d||^2 = ||s||^2 + 2w(s.d) + w^2(d.d)
        #                      reuses the dots the cosine already paid, so
        #                      no per-upload re-walk of the O(model) state
        self._dir_weight = 0.0
        self._expected: List[int] = []
        self._excluded: List[int] = []
        self._seen: Dict[int, str] = {}  # silo -> "accepted" | "rejected"
        self._weight_total = 0.0
        self._edges: Dict[int, dict] = {}

    def _silo(self, silo: int) -> _SiloHealth:
        rec = self._silos.get(silo)
        if rec is None:
            rec = self._silos[silo] = _SiloHealth()
        return rec

    def register(self, silos) -> None:
        """Pre-register the silo universe (the barrier-free async path,
        where no per-version 'expected' set exists): registered silos
        count toward the starvation denominator from version 0 even if
        they never manage an accepted upload."""
        with self._lock:
            for s in silos:
                self._silo(int(s))

    # -- round lifecycle -----------------------------------------------------
    def round_start(self, round_idx, reference=None, *,
                    expected=None, excluded=None) -> None:
        """Open a round.  ``reference``: the round's global (a HOST tree
        — the server's `HostMirror` copy, so opening a round costs no new
        device transfer); flattened ONCE here to f64.  ``expected``: the
        silos the barrier waits on (None for the barrier-free async
        path); ``excluded``: silos dropped at broadcast (dead /
        quarantined) — their fairness counters tick without ever seeing
        an upload."""
        with self._lock:
            self._reset_round_state()
            self._round = round_idx
            if reference is not None:
                self._ref_vec, self._ref_scale = _sketch_f32(
                    reference, self.sketch_coords)
            self._expected = sorted(int(s) for s in (expected or []))
            self._excluded = sorted(int(s) for s in (excluded or []))
            for s in self._expected:
                self._silo(s).tasked += 1
            for s in self._excluded:
                self._silo(s).excluded += 1

    def observe_admitted(self, silo: int, upload, weight, *,
                         norm: Optional[float] = None,
                         staleness: Optional[float] = None) -> None:
        """Fold one ADMITTED upload's statistics at arrival.  O(model)
        work (the update flatten + one dot against the running
        direction), O(model) standing state.  ``norm``: the update norm
        the admission pipeline already computed (`AdmissionVerdict.norm`)
        — passed through so the screen's one O(model) norm pass is the
        only one; computed here only when no screen ran."""
        delta = None
        if self.suppress_payload is None:
            delta, scale = _sketch_f32(upload, self.sketch_coords)
            if self.kind == "params":
                if self._ref_vec is None:
                    raise RuntimeError(
                        "observe_admitted() before round_start(): the "
                        "round's update reference is not set")
                delta = delta - self._ref_vec
        # else: ciphertext upload — the payload-derived stats below are
        # suppressed BY NAME in the ledger line; only the shared
        # fairness/participation tail runs
        with self._lock:
            try:
                w = float(weight)
            except (TypeError, ValueError):
                w = 0.0
            if not math.isfinite(w) or w < 0:
                w = 0.0
            if delta is not None:
                dd = float(np.dot(delta, delta))
                if norm is None:
                    # no screen ran: the norm is the sketch's rescaled
                    # estimate (exact below the sketch cap, scale == 1)
                    norm = math.sqrt(dd) * scale
                norm = float(norm)
                if math.isfinite(norm):
                    self._norms.push(norm)
                if self._dir_sum is None:
                    eff_w = w if w > 0 else 1.0
                    self._dir_sum = eff_w * delta
                    self._dir_sq = eff_w * eff_w * dd
                else:
                    # one dot product against the O(model) running
                    # weighted-mean direction (cos is scale-invariant, so
                    # the un-normalized running SUM is the same direction);
                    # the same dot then advances the incremental ||sum||^2
                    sd = float(np.dot(delta, self._dir_sum))
                    denom = math.sqrt(max(dd, 0.0)) \
                        * math.sqrt(max(self._dir_sq, 0.0))
                    if denom > 0 and math.isfinite(denom):
                        cos = sd / denom
                        if math.isfinite(cos):
                            self._aligns.push(cos)
                    eff_w = w if w > 0 else 1.0
                    self._dir_sum += eff_w * delta
                    self._dir_sq += 2.0 * eff_w * sd + eff_w * eff_w * dd
                self._dir_weight += w if w > 0 else 1.0
            self._weight_total += w
            self._seen[int(silo)] = "accepted"
            rec = self._silo(int(silo))
            rec.accepted += 1
            rec.rounds_since_accept = 0
            rec.last_accept_round = self._round
            if staleness is not None:
                s = float(staleness)
                self._stale.push(s)
                rec.staleness_sum += s
                rec.staleness_n += 1

    def observe_rejected(self, silo: int, reason: str) -> None:
        """One inadmissible upload: the silo reported, its payload did
        not count — fairness accounting ticks, statistics do not."""
        with self._lock:
            self._seen.setdefault(int(silo), "rejected")
            self._silo(int(silo)).rejected += 1

    def note_edge(self, edge: int, summary) -> None:
        """Root side of the multi-level topology: bank the compact health
        summary an edge shipped inside its per-round frame."""
        if not isinstance(summary, dict):
            return
        with self._lock:
            self._edges[int(edge)] = summary

    # -- alarms ---------------------------------------------------------------
    def _alarm_values(self) -> Dict[str, float]:
        misalign = (1.0 - self._aligns.mean) if self._aligns.count else 0.0
        cv = (self._norms.std / self._norms.mean
              if self._norms.count >= 2 and self._norms.mean > 0 else 0.0)
        known = list(self._silos)
        starved = [s for s in known
                   if self._silos[s].rounds_since_accept >= self.starve_after]
        starvation = len(starved) / len(known) if known else 0.0
        return {"health_misalignment_ratio": misalign,
                "health_norm_cv_ratio": cv,
                "health_starvation_ratio": starvation,
                "_starved_silos": float(len(starved))}

    def round_end(self, round_idx, new_global=None, **extra) -> dict:
        """Close the round: per-silo bookkeeping for who never showed,
        the global delta norm against the round's reference, alarm
        verdicts, gauges, and one ledger line.  Returns the line dict
        (``extra`` lands verbatim — quorum sizes, version tags)."""
        with self._lock:
            missing = [s for s in self._expected if s not in self._seen]
            for s in missing:
                self._silos[s].dropped += 1
            # starvation clock: every known silo that did not land an
            # accepted upload this round ages one round
            for s, rec in self._silos.items():
                if self._seen.get(s) != "accepted":
                    rec.rounds_since_accept += 1
            delta_norm = None
            if new_global is not None and self._ref_vec is not None:
                d = _sketch_f32(new_global, self.sketch_coords)[0] \
                    - self._ref_vec
                delta_norm = _finite(math.sqrt(float(np.dot(d, d)))
                                     * self._ref_scale)
            values = self._alarm_values()
            starved = int(values.pop("_starved_silos"))
            alarms = {}
            for slo, alarm in ALARMS.items():
                thr = float(self.thresholds[slo])
                v = values[slo]
                ok = v <= thr
                alarms[alarm] = {"value": _finite(v), "threshold": thr,
                                 "ok": ok}
                if not ok and self.alarms_enabled:
                    self._c_breaches[slo].inc()
            accepted = sum(1 for v in self._seen.values() if v == "accepted")
            line = {
                "round": round_idx,
                "ts": time.time(),
                "node": self.node,
                "kind": self.kind,
                "uploads": len(self._seen),
                "accepted": accepted,
                "rejected": len(self._seen) - accepted,
                "dropped": len(missing),
                "excluded": len(self._excluded),
                "expected": len(self._expected),
                "weight": _finite(self._weight_total),
                "norm": self._norms.summary(),
                "alignment": {"count": self._aligns.count,
                              "mean": (_finite(self._aligns.mean)
                                       if self._aligns.count else None),
                              "min": _finite(self._aligns.min)},
                "global_delta_norm": delta_norm,
                "alarms": alarms,
                "silos": {str(s): self._silos[s].summary()
                          for s in sorted(set(self._seen)
                                          | set(self._expected)
                                          | set(self._excluded))},
            }
            if self.suppress_payload is not None:
                # the named privacy↔observability trade: these fields ARE
                # absent (count-0 summaries), and the line says why
                line["suppressed"] = {"fields": ["norm", "alignment"],
                                      "reason": self.suppress_payload}
            if self._stale.count:
                line["staleness"] = self._stale.summary()
            if self._edges:
                line["edges"] = {str(e): self._edges[e]
                                 for e in sorted(self._edges)}
                line["edge_rollup"] = merge_moments(
                    [s.get("norm") for s in self._edges.values()])
            line.update(extra)
            self.last_line = line
            self._round = None
        if self.alarms_enabled:
            self._export(line, values, starved)
        if self.path:
            self._write(line)
        return line

    def _export(self, line: dict, values: Dict[str, float],
                starved: int) -> None:
        self._c_rounds.inc()
        norm = line["norm"]
        if norm["mean"] is not None:
            self._g["norm_mean"].set(norm["mean"])
        if norm["max"] is not None:
            self._g["norm_max"].set(norm["max"])
        self._g["norm_cv"].set(values["health_norm_cv_ratio"])
        if line["alignment"]["mean"] is not None:
            self._g["align_mean"].set(line["alignment"]["mean"])
        self._g["misalign"].set(values["health_misalignment_ratio"])
        self._g["starvation"].set(values["health_starvation_ratio"])
        self._g["starved"].set(starved)
        if line["expected"]:
            self._g["participation"].set(
                line["accepted"] / line["expected"])
        if line["global_delta_norm"] is not None:
            self._g["delta_norm"].set(line["global_delta_norm"])

    def _write(self, line: dict) -> None:
        if self._ledger_disabled:
            return
        from fedml_tpu_torch.utils.journal import durable_append
        data = json.dumps(line, sort_keys=True) + "\n"
        # one write() on an O_APPEND fd (the perf.jsonl contract): a
        # crash tears at most the tail, which every reader tolerates.
        # A disk fault (ENOSPC/EIO) warns ONCE and disables the ledger —
        # it must never kill the receive thread or the round loop; the
        # in-memory stats, gauges, and alarms keep working.
        try:
            durable_append(self.path, data, channel="health_ledger")
        except OSError as e:
            self._ledger_disabled = True
            log.warning("health ledger append failed (%s); disabling the "
                        "ledger — stats and alarms continue in memory", e)

    # -- queries --------------------------------------------------------------
    def round_summary(self) -> Optional[dict]:
        """The compact frame-ready summary of the LAST closed round
        (what an edge ships to the root)."""
        if self.last_line is None:
            return None
        return compact_summary(self.last_line)

    def healthz(self) -> Optional[dict]:
        """The deep-health payload: last round's verdicts, small enough
        for every LB probe."""
        if self.last_line is None:
            return None
        return {"round": self.last_line.get("round"),
                "alarms": self.last_line.get("alarms"),
                "uploads": self.last_line.get("uploads"),
                "accepted": self.last_line.get("accepted")}

    def per_silo(self) -> Dict[int, dict]:
        """Cross-round fairness ledger snapshot (tests / demos)."""
        with self._lock:
            return {s: rec.summary() for s, rec in sorted(self._silos.items())}
