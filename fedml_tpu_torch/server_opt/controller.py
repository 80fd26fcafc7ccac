"""The health-driven adaptive round controller (the port's copy of
``fedml_tpu/server_opt/controller.py``, pure numpy/math).

``AdaptiveController.decide(round_idx, health_line)`` turns the
health observatory's per-round verdict (``HealthAccumulator.round_end``
line: drift alarms over cosine alignment, update-norm dispersion, and
per-silo participation fairness) into next-round pacing:

* **cohort** — the one LIVE lever.  Cohort size is a host-side sampling
  count; waves pad to a static width and the silo barrier tracks the
  tasked set, so changing it never retraces a compiled program.  Alarm
  firing → widen the cohort (more independent evidence per round);
  ``patience`` consecutive calm rounds → decay back toward the
  configured baseline.
* **epochs** / **wave size** — ADVISORY on the compiled engines.  The
  local-epoch count and the wave width are static shapes inside the
  jitted round programs; applying a change would retrace — exactly what
  the RecompileSentry forbids under ``--perf_strict``.  The controller
  still takes the decision (cut epochs under norm-variance blowup, back
  off under alignment collapse) and names the pin
  (``epochs=K[pinned:static-shape]``) on the round's perf-ledger line,
  so the trend line shows what an engine with dynamic shapes would have
  done.

Every decision is named: the ledger line carries the full decision dict
(``adapt={cohort, epochs, wave, reasons}``), and the
``fedml_adapt_*`` telemetry family exports the levers round-over-round.

The policy is a deterministic pure function of the health-line sequence
(pinned by tests/test_torch_controller.py: same trace in, same decisions
out), and its few integers ride ``state_dict``/``load_state_dict``
through the round checkpoint so a resumed run continues the same pacing
trajectory instead of snapping back to the baseline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Decision:
    """One round's pacing verdict — ``as_ledger()`` is the dict that
    lands verbatim on the perf ledger line under ``adapt=``."""
    round_idx: int
    cohort: int
    epochs: int
    wave_size: int
    reasons: List[str] = field(default_factory=list)

    def as_ledger(self) -> dict:
        return {"cohort": int(self.cohort), "epochs": int(self.epochs),
                "wave": int(self.wave_size),
                "reasons": list(self.reasons)}


class AdaptiveController:
    """Round-over-round pacing from health alarms.

    ``cohort``/``epochs``/``wave_size`` are the configured baselines;
    ``max_cohort`` bounds the widening (cross_silo's local backend
    constructs exactly the configured silo actors, so its ceiling IS
    the baseline; cross_device samples from the full population and
    can genuinely widen).  ``min_cohort``/``min_epochs`` floor the
    backoff.  ``patience`` calm rounds decay every lever one step back
    toward its baseline.
    """

    # one escalation widens the cohort ~25% (at least 1)
    GROW = 0.25

    def __init__(self, *, cohort: int, epochs: int = 1,
                 wave_size: int = 0, min_cohort: int = 2,
                 max_cohort: Optional[int] = None, min_epochs: int = 1,
                 patience: int = 2, epochs_live: bool = False):
        self.base_cohort = int(cohort)
        self.base_epochs = max(1, int(epochs))
        self.wave_size = int(wave_size)
        self.min_cohort = max(1, min(int(min_cohort), self.base_cohort))
        self.max_cohort = int(max_cohort if max_cohort is not None
                              else cohort)
        self.min_epochs = max(1, min(int(min_epochs), self.base_epochs))
        self.patience = max(1, int(patience))
        # epochs_live: engines whose local-step count is NOT a static
        # compiled shape may apply the epoch decision; the compiled
        # engines leave it False and the decision is ledgered as pinned
        self.epochs_live = bool(epochs_live)
        self.cohort = self.base_cohort
        self.epochs = self.base_epochs
        self.calm = 0
        self.decisions = 0
        from fedml_tpu_torch.obs import telemetry as _tel
        reg = _tel.get_registry()
        self._g_cohort = reg.gauge("fedml_adapt_cohort_value")
        self._g_epochs = reg.gauge("fedml_adapt_epochs_value")
        self._g_wave = reg.gauge("fedml_adapt_wave_value")
        self._c_decisions = reg.counter("fedml_adapt_decisions_total")

    # -- the policy -----------------------------------------------------------

    @staticmethod
    def _alarm(line: dict, name: str):
        """(fired, severity) for one health alarm; severity is
        value/threshold (>= 1.0 when firing), 0.0 when absent."""
        a = (line or {}).get("alarms", {}).get(name)
        if not isinstance(a, dict):
            return False, 0.0
        thr = float(a.get("threshold") or 0.0)
        val = float(a.get("value") or 0.0)
        sev = val / thr if thr > 0 else 0.0
        return not a.get("ok", True), sev

    def decide(self, round_idx: int, health_line: Optional[dict], *,
               debt: int = 0, quorum_floor: Optional[int] = None) \
            -> Decision:
        """The verdict for the NEXT round, from THIS round's health
        line.  Pure in (controller state, line); mutates only the
        controller's own levers.

        ``debt``/``quorum_floor`` are the degrade spine's composition
        hooks: outstanding participation debt widens the
        cohort like a starvation alarm (the deadline-dropped honest
        silos need seats to repay it), and a downward cohort move is
        clamped at the quorum floor — the controller NEVER fights the
        quorum.  The defaults keep every trajectory without them
        bit-identical."""
        reasons: List[str] = []
        misaligned, mis_sev = self._alarm(health_line,
                                          "alignment_collapse")
        blowup, _ = self._alarm(health_line, "norm_variance_blowup")
        starved, _ = self._alarm(health_line,
                                 "participation_starvation")
        indebted = int(debt) > 0
        fired = misaligned or blowup or starved or indebted
        if fired:
            self.calm = 0
            if misaligned or starved or indebted:
                why = ("alignment_collapse" if misaligned
                       else "participation_starvation" if starved
                       else f"participation_debt[{int(debt)}]")
                grown = min(self.max_cohort,
                            self.cohort
                            + max(1, math.ceil(self.cohort * self.GROW)))
                if grown > self.cohort:
                    self.cohort = grown
                    reasons.append(f"{why}:cohort+>{self.cohort}")
                else:
                    reasons.append(f"{why}:cohort=clamped[max="
                                   f"{self.max_cohort}]")
            if misaligned and mis_sev >= 2.0 or blowup:
                why = "norm_variance_blowup" if blowup \
                    else "alignment_collapse[severe]"
                cut = max(self.min_epochs, self.epochs - 1)
                if cut < self.epochs:
                    self.epochs = cut
                    reasons.append(f"{why}:epochs->{self.epochs}" + (
                        "" if self.epochs_live
                        else "[pinned:static-shape]"))
                else:
                    reasons.append(f"{why}:epochs=floor[{self.min_epochs}]")
        else:
            self.calm += 1
            if self.calm >= self.patience and (
                    self.cohort != self.base_cohort
                    or self.epochs != self.base_epochs):
                self.calm = 0
                if self.cohort > self.base_cohort:
                    self.cohort = max(self.base_cohort, self.cohort
                                      - max(1, math.ceil(
                                          self.cohort * self.GROW / 2)))
                    reasons.append(f"calm:cohort->{self.cohort}")
                elif self.cohort < self.base_cohort:
                    self.cohort = min(self.base_cohort, self.cohort + 1)
                    reasons.append(f"calm:cohort->{self.cohort}")
                if self.epochs != self.base_epochs:
                    self.epochs = min(self.base_epochs, self.epochs + 1)
                    reasons.append(f"calm:epochs->{self.epochs}" + (
                        "" if self.epochs_live
                        else "[pinned:static-shape]"))
            else:
                reasons.append("hold")
        if quorum_floor is not None and self.cohort < int(quorum_floor):
            # never fight the quorum: a cohort smaller than the close
            # threshold could never fold a round
            self.cohort = int(quorum_floor)
            reasons.append(f"quorum_floor:cohort->{self.cohort}")
        if not reasons:
            reasons.append("hold")
        self.decisions += 1
        if reasons != ["hold"]:
            self._c_decisions.inc()
        self._g_cohort.set(self.cohort)
        self._g_epochs.set(self.epochs)
        self._g_wave.set(self.wave_size)
        return Decision(round_idx=round_idx, cohort=self.cohort,
                        epochs=self.epochs, wave_size=self.wave_size,
                        reasons=reasons)

    # -- checkpoint (fixed-shape numpy, rides the round checkpoint) -----------

    def state_dict(self) -> dict:
        return {"cohort": np.asarray(self.cohort, np.int64),
                "epochs": np.asarray(self.epochs, np.int64),
                "calm": np.asarray(self.calm, np.int64),
                "decisions": np.asarray(self.decisions, np.int64)}

    def load_state_dict(self, state: dict) -> None:
        self.cohort = int(np.asarray(state["cohort"]))
        self.epochs = int(np.asarray(state["epochs"]))
        self.calm = int(np.asarray(state["calm"]))
        self.decisions = int(np.asarray(state.get("decisions", 0)))
