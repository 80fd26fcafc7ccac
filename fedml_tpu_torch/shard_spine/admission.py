"""Per-shard upload admission for the sharded spine.

Port of ``fedml_tpu/shard_spine/admission.py``.  On the sharded wire a
silo's update arrives as S shard slices, and the screens split across two
moments:

* **per slice, at arrival** — quarantine state, the structural
  fingerprint against that SHARD's template (the shard id is part of the
  screened structure, so a wrong-shard slice is a fingerprint reject even
  when shapes collide), the finite guard, ``num_samples`` validation and
  cross-slice consistency;
* **per silo, at completion** — the norm-outlier screen over the
  combined update norm ``sqrt(sum_s sumsq_s)``, the same f64 quantity and
  the same rolling median + MAD threshold as the replicated screen.

Rejection granularity is the SILO: one bad slice rejects the whole upload
before anything folds, and the strike feeds the shared `TrustTracker`.
A silo's slices are held on the host until its last slice lands or the
round closes.  The screens run on the decoded wire arrays (host numpy).
"""

from __future__ import annotations

import collections
import logging
import math
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.comm.message import _flatten_arrays
from fedml_tpu_torch.core.pytree import host_array, tree_keys
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.robust.admission import (REASONS, TrustTracker,
                                              all_finite, flatten_leaves,
                                              norm_outlier_threshold,
                                              params_fingerprint,
                                              update_sumsq)
from fedml_tpu_torch.shard_spine.plan import ShardPlan

log = logging.getLogger(__name__)

# offer() outcomes
WAIT = "wait"          # banked; more slices outstanding
ACCEPT = "accept"      # all slices arrived and passed every screen
REJECT = "reject"      # the SILO is rejected (reason attached)


class ShardAdmission:
    """The sharded bouncer.  ``template``: the port's flat params dict at
    federation start; ``template_slices`` is the plan's split of it (the
    fingerprint contract).

    Round protocol::

        adm.round_start(host_params)          # the nested host global
        status, payload = adm.offer(silo, shard, nshards, slice, n, r)
        ...
        adm.round_end()                       # drops unfinished holds
    """

    def __init__(self, plan: ShardPlan, template, *,
                 max_num_samples: float = 1e6, norm_k: float = 6.0,
                 norm_window: int = 64, norm_min_history: int = 8,
                 trust: Optional[TrustTracker] = None):
        if max_num_samples < 0:
            raise ValueError(f"max_num_samples must be >= 0 (0 disables "
                             f"the cap), got {max_num_samples}")
        if norm_window < 1 or norm_min_history < 1:
            raise ValueError("norm_window and norm_min_history must be "
                             ">= 1")
        self.plan = plan
        leaves = [host_array(template[k]) for k in tree_keys(template)]
        self.template_slices = plan.split_leaves(leaves)
        self.fingerprints = [params_fingerprint(sl)
                             for sl in self.template_slices]
        self.max_num_samples = max_num_samples
        self.norm_k = norm_k
        self.norm_min_history = norm_min_history
        self._norms: Deque[float] = collections.deque(maxlen=norm_window)
        self.trust = trust if trust is not None else TrustTracker()
        reg = telemetry.get_registry()
        self._c_admitted = reg.counter("fedml_robust_admitted_total")
        self._c_rejected = {r: reg.counter("fedml_robust_rejected_total",
                                           reason=r) for r in REASONS}
        self._c_shard_rej = {r: reg.counter("fedml_shard_rejected_total",
                                            reason=r) for r in REASONS}
        # the SAME histogram the replicated screen observes per upload
        # (robust/admission.py) — a sharded federation must not leave
        # the norm dashboards silently empty
        self._h_norm = reg.histogram(
            "fedml_robust_update_norm_total",
            buckets=(0.01, 0.1, 0.5, 1, 2, 5, 10, 50, 100, 1000, 1e5))
        self.rejected: Dict[str, int] = {r: 0 for r in REASONS}
        self.admitted = 0
        # per-round state
        self._ref_slices: Optional[list] = None   # per-shard f64 leaves
        self._pending: Dict[int, Dict[int, dict]] = {}
        self._sumsq: Dict[int, Dict[int, float]] = {}
        self._num_samples: Dict[int, float] = {}

    # -- round lifecycle -----------------------------------------------------
    def round_start(self, host_params) -> None:
        """Cache the round's reference slices as f64 host leaves, from
        the round's host mirror (nested, the wire layout) — once per
        round, never once per slice."""
        leaves, _ = _flatten_arrays(host_params)
        slices = self.plan.split_leaves(leaves)
        self._ref_slices = [
            [np.asarray(leaf, np.float64)
             for leaf in flatten_leaves(sl)] for sl in slices]
        self.round_end()

    def round_end(self) -> None:
        """Drop unfinished holds (stragglers whose remaining slices
        never arrived — the round closed over them at weight 0)."""
        self._pending.clear()
        self._sumsq.clear()
        self._num_samples.clear()

    def norm_threshold(self) -> Optional[float]:
        return norm_outlier_threshold(self._norms, self.norm_k,
                                      self.norm_min_history)

    # -- the screens ---------------------------------------------------------
    def _reject(self, silo: int, round_idx: int, reason: str,
                norm: Optional[float] = None) -> Tuple[str, dict]:
        self._drop(silo)
        self.rejected[reason] += 1
        self._c_rejected[reason].inc()
        self._c_shard_rej[reason].inc()
        if reason != "quarantined":
            self.trust.strike(silo, round_idx, reason)
        return REJECT, {"reason": reason, "norm": norm}

    def _drop(self, silo: int) -> None:
        self._pending.pop(silo, None)
        self._sumsq.pop(silo, None)
        self._num_samples.pop(silo, None)

    def offer(self, silo: int, shard, num_shards, slice_payload,
              num_samples, round_idx: int, pre=None) -> Tuple[str, dict]:
        """Screen + bank one shard slice.  Returns ``(WAIT, {})``,
        ``(REJECT, {reason, norm})``, or ``(ACCEPT, {slices,
        num_samples, norm})`` with the silo's S slices in shard order —
        the exact payload `ShardedStreamingAggregator.fold_slices`
        consumes.

        ``pre`` (a `comm.ingest.ArenaScreen` from the shard's ingest
        arena, the JAX seam of ``shard_spine/admission.py:150-151``)
        stands in for the host screens: its header check for the
        fingerprint, its device reduction for finite and sumsq.  The
        caller passes ``pre.tree`` (the staged device slice) as
        ``slice_payload``, so the banked slices live on the device."""
        if self._ref_slices is None:
            raise RuntimeError("offer() before round_start(): the "
                               "round's reference slices are not cached")
        if self.trust.state(silo, round_idx) == TrustTracker.QUARANTINED:
            return self._reject(silo, round_idx, "quarantined")
        # the slice's own shard/count claims must match the plan — a
        # mislabeled frame is structural damage, same bucket as a
        # fingerprint mismatch
        try:
            shard = int(shard)
            num_shards = int(num_shards)
        except (TypeError, ValueError):
            return self._reject(silo, round_idx, "fingerprint")
        if num_shards != self.plan.num_shards \
                or not 0 <= shard < self.plan.num_shards:
            return self._reject(silo, round_idx, "fingerprint")
        if pre is not None:
            fp_ok = pre.structural_ok
        else:
            try:
                fp_ok = (params_fingerprint(slice_payload)
                         == self.fingerprints[shard])
            except Exception:  # noqa: BLE001 — unhashable garbage payload
                fp_ok = False
        if not fp_ok:
            return self._reject(silo, round_idx, "fingerprint")
        n = self._validate_num_samples(silo, num_samples)
        if n is None:
            return self._reject(silo, round_idx, "bad_num_samples")
        if not (pre.finite if pre is not None else
                all_finite(slice_payload)):
            return self._reject(silo, round_idx, "nonfinite")
        held = self._pending.setdefault(silo, {})
        if shard in held:
            # duplicate slice delivery (chaos dup / transport retry):
            # the first copy was already screened and banked
            log.info("ignoring duplicate shard-%d slice from silo %d",
                     shard, silo)
            return WAIT, {}
        held[shard] = slice_payload
        self._sumsq.setdefault(silo, {})[shard] = (
            pre.sumsq if pre is not None else update_sumsq(
                slice_payload, self._ref_slices[shard]))
        if len(held) < self.plan.num_shards:
            return WAIT, {}
        # completion: the combined norm screen over the whole update
        norm = math.sqrt(sum(self._sumsq[silo].values()))
        self._h_norm.observe(norm)
        thresh = self.norm_threshold()
        if thresh is not None and norm > thresh:
            return self._reject(silo, round_idx, "norm_outlier", norm)
        slices = [held[s] for s in range(self.plan.num_shards)]
        self._drop(silo)
        self._norms.append(norm)
        self.admitted += 1
        self._c_admitted.inc()
        self.trust.record_clean(silo, round_idx)
        return ACCEPT, {"slices": slices, "num_samples": float(n),
                        "norm": norm}

    def _validate_num_samples(self, silo: int,
                              num_samples) -> Optional[float]:
        try:
            n = float(num_samples)
        except (TypeError, ValueError):
            return None
        if not math.isfinite(n) or n <= 0 \
                or (self.max_num_samples > 0 and n > self.max_num_samples):
            return None
        prev = self._num_samples.get(silo)
        if prev is not None and prev != n:
            # a silo claiming different weights on different slices is
            # weight confusion, not an honest upload
            return None
        self._num_samples[silo] = n
        return n

    def pending_silos(self) -> set:
        """Silos with at least one banked slice still waiting for the
        rest (diagnostics; the straggler timer reads the barrier, not
        this)."""
        return set(self._pending)

    def reject(self, silo: int, round_idx: int, reason: str):
        """Administrative rejection for damage detected upstream (the
        `AdmissionPipeline.reject` twin): counted and struck so every
        rejected upload appears in the rejected series."""
        if reason not in REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}; "
                             f"available: {REASONS}")
        return self._reject(silo, round_idx, reason)
