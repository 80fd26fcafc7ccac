"""Train-to-serve release gate (port of ``fedml_tpu/serve/release.py``):
canary shadow evaluation, automated promote/rollback, and poisoned-round
containment.

Every finalized global enters the `ModelRegistry` as a **canary** (in
history, never the live slot) and `ReleaseController` gates promotion on
three independent signals:

* **shadow traffic** — a deterministic slice of live requests tapped by
  `ShadowSampler` (the `MicroBatcher` ``shadow=`` seam; a pool's workers
  share one sampler) is replayed against the canary and the serving
  version; the disagreement fraction (`_divergence`) must stay within
  ``divergence_budget``;
* **health observatory** — the drift and norm alarms
  (`obs.health.HealthAccumulator.healthz`) of the round that produced the
  candidate must all be ok;
* **held-out eval** — ``eval_fn(params)`` (higher is better) must not
  regress below the last promoted score by more than ``eval_tolerance``.

Pass → ``registry.promote()``: one lock-guarded reference swap.  Fail →
the canary is discarded; serving never moved, which IS the rollback, and
a cooldown with exponential backoff refuses the next canaries.  Every
verdict lands in telemetry (``fedml_release_*``) and the release journal
(`utils.journal.durable_append`, channel ``release_journal``).

Crash consistency: `robust.faultline` crash points ``canary_promote`` /
``canary_rollback`` fire BEFORE and AFTER each atomic registry mutation
(hit 1 = pre, hit 2 = post); a respawned controller's ``recover()``
discards lingering canaries and the next offer re-drives the gate.

Signals with no evidence pass VACUOUSLY (no shadow rows, no health
record, no eval_fn), and each vacuous pass is named in the verdict.
Shadow rows run through `registry.ServedModel.predict` (the registry's
device, ``torch.inference_mode()``).
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

Pytree = Any

SIGNALS = ("shadow", "health", "eval")

# rollback/refusal reasons (the rollback counter's label vocabulary)
ROLLBACK_REASONS = SIGNALS + ("cooldown",)


class ShadowSampler:
    """Deterministic every-Nth tap of live request traffic into a fixed
    ring — the shadow slice the gate replays against each canary.

    Hot-path cost is one C-level ``next()`` on an `itertools.count`
    (GIL-atomic, lock-free: a lock on the request path would serialize
    every pool worker's submits) plus, on the sampled Nth request
    only, one row copy into the ring.  The slice is deterministic in the
    arrival sequence: the same submit order yields the same captured
    rows, so shadow verdicts replay."""

    def __init__(self, every: int = 16, slots: int = 64):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.every = int(every)
        self.slots = int(slots)
        self._n = itertools.count()
        self._ring: list = [None] * self.slots
        reg = telemetry.get_registry()
        self._c_sampled = reg.counter("fedml_release_shadow_requests_total")

    def offer(self, x) -> None:
        """One live request's instance; keeps every ``every``-th."""
        n = next(self._n)
        if n % self.every:
            return
        # np.array: an owned copy — the caller's buffer may be reused
        self._ring[(n // self.every) % self.slots] = np.array(x)
        self._c_sampled.inc()

    def snapshot(self) -> list:
        """The captured rows, ring order (stable for a fixed arrival
        sequence; partially-filled rings return only the filled slots)."""
        return [r for r in self._ring if r is not None]


def _divergence(y_live: np.ndarray, y_canary: np.ndarray) -> float:
    """Disagreement fraction between two models' outputs on the shadow
    slice.  Classification heads ([N, C], C > 1) compare argmax — the
    user-visible prediction; anything else compares values within a
    relative tolerance (regression outputs drift a little every honest
    round; a poisoned model blows far past it)."""
    if y_live.ndim >= 2 and y_live.shape[-1] > 1:
        a = np.argmax(y_live.reshape(y_live.shape[0], -1), axis=-1)
        b = np.argmax(y_canary.reshape(y_canary.shape[0], -1), axis=-1)
        return float(np.mean(a != b))
    flat_l = y_live.reshape(y_live.shape[0], -1).astype(np.float64)
    flat_c = y_canary.reshape(y_canary.shape[0], -1).astype(np.float64)
    tol = 1e-3 * (1.0 + np.abs(flat_l))
    row_diff = np.any(~np.isfinite(flat_c) | (np.abs(flat_l - flat_c)
                                              > tol), axis=-1)
    return float(np.mean(row_diff))


class ReleaseController:
    """The promote/rollback state machine between the train loop and the
    serving registry.  ``offer(params, version, round_idx)`` is the
    publish hook: canary-publish, evaluate the three signals, then
    promote or discard — never leaving a canary unresolved (except
    across a crash, which ``recover()`` cleans up).

    ``eval_fn(params) -> float`` scores the candidate on held-out data,
    higher is better.  ``health`` is an `obs.health.HealthAccumulator`
    (or anything with ``healthz()``).  ``clock`` is injectable for
    cooldown tests."""

    def __init__(self, registry, *, shadow: Optional[ShadowSampler] = None,
                 health=None, eval_fn: Optional[Callable] = None,
                 divergence_budget: float = 0.1,
                 eval_tolerance: float = 0.02,
                 cooldown_s: float = 5.0, backoff: float = 2.0,
                 max_cooldown_s: float = 60.0,
                 journal_path: Optional[str] = None,
                 faultline=None, clock: Callable[[], float] = time.monotonic):
        if not 0.0 <= divergence_budget <= 1.0:
            raise ValueError(f"divergence_budget must be in [0, 1], got "
                             f"{divergence_budget}")
        if cooldown_s < 0 or backoff < 1.0 or max_cooldown_s < cooldown_s:
            raise ValueError(
                f"cooldown_s >= 0, backoff >= 1, max_cooldown_s >= "
                f"cooldown_s required; got cooldown_s={cooldown_s}, "
                f"backoff={backoff}, max_cooldown_s={max_cooldown_s}")
        self.registry = registry
        self.shadow = shadow
        self.health = health
        self.eval_fn = eval_fn
        self.divergence_budget = float(divergence_budget)
        self.eval_tolerance = float(eval_tolerance)
        self.cooldown_s = float(cooldown_s)
        self.backoff = float(backoff)
        self.max_cooldown_s = float(max_cooldown_s)
        self.journal_path = journal_path
        self.faultline = faultline
        self.clock = clock
        self._lock = threading.Lock()
        self._cooldown_until = -float("inf")
        self._consecutive_failures = 0
        self._last_promoted_score: Optional[float] = None
        self.promotions = 0
        self.rollbacks = 0
        self.verdicts: list = []          # every offer's verdict dict
        self._journal_dead = False
        reg = telemetry.get_registry()
        self._c_canaries = reg.counter("fedml_release_canaries_total")
        self._c_promotions = reg.counter("fedml_release_promotions_total")
        self._c_rollbacks = {
            r: reg.counter("fedml_release_rollbacks_total", signal=r)
            for r in ROLLBACK_REASONS}
        self._g_divergence = reg.gauge(
            "fedml_release_shadow_divergence_ratio")
        self._g_eval = reg.gauge("fedml_release_eval_score_value")
        self._g_cooldown = reg.gauge("fedml_release_cooldown_seconds")
        self._h_verdict = reg.histogram("fedml_release_verdict_seconds")

    # -- crash points --------------------------------------------------------
    def _crash(self, point: str, round_idx) -> None:
        if self.faultline is not None:
            self.faultline.maybe_crash(point, round_idx=round_idx)

    # -- the three signals ---------------------------------------------------
    def _signal_shadow(self, version: int) -> dict:
        rows = self.shadow.snapshot() if self.shadow is not None else []
        serving = self.registry.current()
        if not rows or serving is None:
            return {"ok": True, "vacuous": True, "n": 0,
                    "divergence": None}
        canary = self.registry.get(version)
        x = np.stack([np.asarray(r) for r in rows])
        y_live = serving.predict(x)
        y_canary = canary.predict(x)
        div = _divergence(y_live, y_canary)
        self._g_divergence.set(div)
        return {"ok": div <= self.divergence_budget, "vacuous": False,
                "n": len(rows), "divergence": div,
                "budget": self.divergence_budget,
                "against": serving.version}

    def _signal_health(self, round_idx) -> dict:
        h = self.health.healthz() if self.health is not None else None
        if h is None or not h.get("alarms"):
            return {"ok": True, "vacuous": True, "round": None,
                    "alarms": {}}
        if round_idx is not None and h.get("round") != round_idx:
            # no record FOR THE PRODUCING ROUND: vacuous, but named — an
            # operator can see the observatory lagged the publish
            return {"ok": True, "vacuous": True, "round": h.get("round"),
                    "expected_round": round_idx, "alarms": {}}
        alarms = {name: bool(a.get("ok", True))
                  for name, a in h["alarms"].items()}
        return {"ok": all(alarms.values()), "vacuous": False,
                "round": h.get("round"), "alarms": alarms}

    def _signal_eval(self, params) -> dict:
        if self.eval_fn is None:
            return {"ok": True, "vacuous": True, "score": None}
        score = float(self.eval_fn(params))
        self._g_eval.set(score)
        baseline = self._last_promoted_score
        ok = (np.isfinite(score)
              and (baseline is None
                   or score >= baseline - self.eval_tolerance))
        return {"ok": bool(ok), "vacuous": False, "score": score,
                "baseline": baseline, "tolerance": self.eval_tolerance}

    # -- the gate ------------------------------------------------------------
    def offer(self, params: Pytree, version: int,
              round_idx=None) -> dict:
        """Gate one finalized global.  Returns the verdict dict (also
        appended to ``self.verdicts`` and the release journal)."""
        t0 = time.perf_counter()
        with self._lock:
            verdict = self._offer_locked(params, int(version), round_idx)
        self._h_verdict.observe(time.perf_counter() - t0)
        return verdict

    def _offer_locked(self, params, version: int, round_idx) -> dict:
        now = self.clock()
        base = {"version": version, "round": round_idx,
                "live_before": self.registry.version}
        if now < self._cooldown_until:
            verdict = {**base, "decision": "cooldown",
                       "cooldown_remaining_s":
                           round(self._cooldown_until - now, 3),
                       "live_version": self.registry.version}
            self._c_rollbacks["cooldown"].inc()
            log.warning("release: version %d REFUSED (cooldown, %.1fs "
                        "remaining)", version,
                        verdict["cooldown_remaining_s"])
            return self._record(verdict)
        if not self.registry.publish(params, version, canary=True):
            return self._record({**base, "decision": "stale",
                                 "live_version": self.registry.version})
        self._c_canaries.inc()
        signals = {"shadow": self._signal_shadow(version),
                   "health": self._signal_health(round_idx),
                   "eval": self._signal_eval(params)}
        failed = [s for s in SIGNALS if not signals[s]["ok"]]
        if not failed:
            self._crash("canary_promote", round_idx)   # hit N: pre
            self.registry.promote(version)
            self._crash("canary_promote", round_idx)   # hit N+1: post
            self.promotions += 1
            self._c_promotions.inc()
            if not signals["eval"]["vacuous"]:
                self._last_promoted_score = signals["eval"]["score"]
            self._consecutive_failures = 0
            self._cooldown_until = -float("inf")
            self._g_cooldown.set(0.0)
            verdict = {**base, "decision": "promote", "signals": signals,
                       "live_version": version}
            log.info("release: version %d PROMOTED (shadow n=%d "
                     "div=%s, health=%s, eval=%s)", version,
                     signals["shadow"]["n"],
                     signals["shadow"]["divergence"],
                     "vacuous" if signals["health"]["vacuous"] else "ok",
                     signals["eval"]["score"])
            return self._record(verdict)
        # fail → automatic rollback: discard the canary (the live slot
        # never moved, so serving is already the last promoted version)
        self._crash("canary_rollback", round_idx)      # hit N: pre
        self.registry.discard(version)
        self._crash("canary_rollback", round_idx)      # hit N+1: post
        self.rollbacks += 1
        for s in failed:
            self._c_rollbacks[s].inc()
        self._consecutive_failures += 1
        cooldown = min(
            self.cooldown_s
            * self.backoff ** (self._consecutive_failures - 1),
            self.max_cooldown_s)
        self._cooldown_until = self.clock() + cooldown
        self._g_cooldown.set(cooldown)
        verdict = {**base, "decision": "rollback", "signals": signals,
                   "failed_signals": failed,
                   "rolled_back_to": self.registry.version,
                   "live_version": self.registry.version,
                   "cooldown_s": cooldown,
                   "consecutive_failures": self._consecutive_failures}
        log.warning("release: version %d ROLLED BACK (failed signals "
                    "%s); serving stays on %s, cooldown %.1fs",
                    version, failed, self.registry.version, cooldown)
        return self._record(verdict)

    # -- crash recovery ------------------------------------------------------
    def recover(self) -> dict:
        """Respawn path: resolve any canary a crash left unvetted.  A
        canary is never half-promoted (the registry mutation is one
        atomic swap), so the registry is in exactly one of two states
        per canary: still-canary (verdict never landed — discard it;
        the trainer's next offer re-drives the gate) or promoted (the
        verdict completed before the crash — nothing to do)."""
        with self._lock:
            discarded = []
            for v in self.registry.canaries():
                self.registry.discard(v)
                discarded.append(v)
            report = {"decision": "recover", "discarded": discarded,
                      "live_version": self.registry.version}
            if discarded:
                log.warning("release: recovery discarded unresolved "
                            "canaries %s (live stays %s)", discarded,
                            self.registry.version)
            return self._record(report)

    # -- verdict record ------------------------------------------------------
    def _record(self, verdict: dict) -> dict:
        verdict = {"ts": time.time(), **verdict}
        self.verdicts.append(verdict)
        if self.journal_path and not self._journal_dead:
            from fedml_tpu_torch.utils.journal import durable_append
            try:
                durable_append(self.journal_path,
                               json.dumps(verdict, sort_keys=True) + "\n",
                               channel="release_journal")
            except OSError as e:
                # the ledger contract everywhere else in obs/: warn once
                # and disable — a full disk must never block a verdict
                self._journal_dead = True
                log.warning("release journal disabled (%s); verdicts "
                            "stay in telemetry only", e)
        return verdict
