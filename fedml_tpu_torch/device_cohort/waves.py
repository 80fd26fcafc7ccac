"""Static device-sized waves: the unit of cross-device training (port of
``fedml_tpu/device_cohort/waves.py``).

A mega-cohort round (1k-100k sampled clients) cannot train as one vmap:
the stacked cohort would not fit the card.  `plan_waves` chops the
sampled cohort into fixed-size waves (the last one padded with weight-0
slots); `make_wave_fn` trains one wave over its stacked client axis
(`parallel.cohort.train_cohort`, ``torch.func.vmap`` on one card) and
computes on the device the wave's summary the host screens: the weighted
partial mean (accumulated in the acc dtype), the weight total and the
weighted sums of per-client aux values.

A client's keys are those of its global cohort slot (``offset + i``,
``fold_in(round_key, slot)``), so a wave-chunked round trains exactly as
a single-wave round does, dropout masks included.

`WaveAdmission` screens each wave's summary with the live admission
pipeline's statistics (`robust.admission`): structural fingerprint,
finite guard, and a rolling median + MAD norm screen.  A rejected wave
contributes weight 0: inside a wave there is no per-client payload to
screen.

On a mesh (`parallel.mesh.Mesh`, one rank a position of its
``clients`` axis) each rank trains its contiguous ``W / D`` slots of the
wave, keyed by their global slots (``offset + rank·W/D + i``); the
summary's sums go over the ranks (`Mesh.allsum`) and the stacked uploads
and weights are gathered in rank order, which is slot order.  So every
rank folds the same uploads in the same order as one rank would, and
the ranks' globals stay byte-equal."""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from fedml_tpu_torch.core.pytree import Tree, acc_dtype, tree_keys
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.parallel.cohort import cohort_rngs
from fedml_tpu_torch.robust.admission import (AdmissionVerdict, _all_finite,
                                              _leaves, _update_norm,
                                              norm_outlier_threshold,
                                              params_fingerprint)

@dataclasses.dataclass(frozen=True)
class Wave:
    """One static-size slice of the round's sampled cohort: the live
    client ``ids`` (at most wave_size; the gather pads the rest with
    weight-0 slots) and ``offset``, the global cohort slot of its first
    client."""
    ids: np.ndarray
    offset: int

    @property
    def n_live(self) -> int:
        return len(self.ids)


def plan_waves(ids: Sequence[int], wave_size: int) -> List[Wave]:
    """The cohort in ``wave_size`` chunks, in cohort order."""
    if wave_size < 1:
        raise ValueError(f"wave_size must be >= 1, got {wave_size}")
    ids = np.asarray(ids, dtype=np.int64)
    return [Wave(ids=ids[lo:lo + wave_size], offset=lo)
            for lo in range(0, max(len(ids), 1), wave_size)]


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _wave_summary(stacked: Tree, w: torch.Tensor,
                  aux: Dict[str, torch.Tensor], mesh=None):
    """The wave's weighted partial mean (each leaf accumulated in its acc
    dtype), weight total and weighted aux sums, on the device; on a
    ``mesh`` each a sum over the ranks' rows."""
    def allsum(tree):
        return tree if mesh is None else mesh.allsum(tree, "clients")

    total = allsum(torch.sum(w))
    # an all-pad wave (total 0) divides by the guard, not 0; the engine
    # skips it by weight before the mean is read
    ratio = w / torch.clamp_min(total, 1e-6)

    def _part(x):
        acc = acc_dtype(x.dtype)
        return torch.sum(x.to(acc) * _bcast(ratio, x.dim()).to(acc), dim=0)

    sums = allsum({**{f"mean/{k}": _part(stacked[k])
                      for k in tree_keys(stacked)},
                   **{f"aux/{k}": torch.sum(v.to(torch.float32)
                                            * _bcast(w, v.dim()), dim=0)
                      for k, v in aux.items()}})
    mean = {k: sums[f"mean/{k}"].to(stacked[k].dtype)
            for k in tree_keys(stacked)}
    aux_sums = {k: sums[f"aux/{k}"] for k in aux}
    return mean, total, aux_sums


def make_wave_fn(make_stacked: Callable, mesh=None):
    """One wave: ``wave_fn(params, wave_data, seed_words, offset) ->
    (stacked_uploads, weights, wave_mean, wave_weight, aux_sums)``.

    ``make_stacked(params, wave_data, seed_words, offset) -> (stacked,
    aux)`` trains the wave (typically `train_cohort` over a local
    trainer); ``aux`` maps names to per-client ``[wave, ...]`` tensors
    that reduce to weighted sums (FedNova's tau).

    ``mesh``: each rank trains its block of the wave's slots (the wave
    size must divide over the ``clients`` axis), the summary is summed
    over the ranks and the stacked uploads and weights come back whole,
    gathered in slot order."""
    if mesh is None:
        def wave_fn(params, wave_data, seed_words, offset: int):
            stacked, aux = make_stacked(params, wave_data, seed_words,
                                        offset)
            w = wave_data["num_samples"].to(torch.float32)
            mean, total, aux_sums = _wave_summary(stacked, w, aux)
            return stacked, w, mean, total, aux_sums

        return wave_fn

    from fedml_tpu_torch.parallel.mesh import stage_global
    n_dev = mesh.shape["clients"]

    def sharded_wave_fn(params, wave_data, seed_words, offset: int):
        width = wave_data["num_samples"].shape[0]
        if width % n_dev:
            raise ValueError(
                f"wave size {width} not divisible by the mesh clients axis "
                f"({n_dev}); pick --wave_size as a multiple of the device "
                f"count")
        local = dict(stage_global(wave_data, mesh, "clients"))
        lo = mesh.axis_index("clients") * (width // n_dev)
        stacked, aux = make_stacked(
            {k: v.to(mesh.device) for k, v in params.items()}, local,
            seed_words, offset + lo)
        w = local["num_samples"].to(torch.float32)
        mean, total, aux_sums = _wave_summary(stacked, w, aux, mesh)
        gathered = mesh.all_gather_rows({**stacked, "_weights_": w})
        w_all = gathered.pop("_weights_")
        return gathered, w_all, mean, total, aux_sums

    return sharded_wave_fn


def make_scaffold_wave_fn(scaffold_local, lr: float):
    """SCAFFOLD's wave (the control variates are host-resident stacked
    state, gathered per wave):

    ``wave_fn(params, wave_data, seed_words, offset, c_global, c_cohort)
    -> (stacked_y, weights, wave_mean, wave_weight, new_c_cohort,
    c_delta_sum, live_count)``

    Padded slots (weight 0) keep their aliased ``c`` rows and add nothing
    to the c-delta sum, as in `algorithms.scaffold.Scaffold`."""

    def wave_fn(params, wave_data, seed_words, offset: int, c_global,
                c_cohort):
        batches = {k: v for k, v in wave_data.items() if k != "num_samples"}
        c_diffs = {k: c_global[k][None] - c_cohort[k] for k in c_global}
        rngs = cohort_rngs(scaffold_local, wave_data, seed_words, offset)
        extra = () if rngs is None else (rngs,)
        ys, ks = vmap(scaffold_local,
                      in_dims=(None, 0, 0) + (0,) * len(extra))(
            params, batches, c_diffs, *extra)
        w = wave_data["num_samples"].to(torch.float32)
        live = (w > 0).to(torch.float32)
        k_safe = torch.clamp_min(ks, 1.0)
        # c_i+ = c_i − c + (x − y_i)/(K·lr); padded slots keep c_i
        new_c = {k: torch.where(
                     _bcast(live, x.dim() + 1) > 0,
                     c_cohort[k] - c_global[k][None]
                     + (x[None] - ys[k]) / (_bcast(k_safe, x.dim() + 1)
                                            * lr),
                     c_cohort[k])
                 for k, x in params.items()}
        c_delta = {k: torch.sum((new_c[k] - c_cohort[k])
                                * _bcast(live, new_c[k].dim()), dim=0)
                   for k in new_c}
        mean, total, _ = _wave_summary(ys, w, {})
        return ys, w, mean, total, new_c, c_delta, torch.sum(live)

    return wave_fn


class WaveAdmission:
    """Per-wave admission: the structural fingerprint, finite guard and
    rolling median + MAD norm screen of the live admission pipeline, run
    on each wave's weighted partial mean (host numpy) against the round's
    global.

    Rejections are counted in ``fedml_cohort_wave_rejected_total{reason}``
    and in ``rejected``; there is no trust ledger (a wave index is a
    position in a freshly sampled cohort, not an identity).

    The norm history resets at ``round_start``: the wave means of one
    round are the exchangeable population, and update norms drift from
    round to round as training converges.  So the screen arms only in
    rounds with more than ``norm_min_history`` live waves."""

    REASONS = ("fingerprint", "nonfinite", "norm_outlier")

    def __init__(self, template, *, norm_k: float = 6.0,
                 norm_window: int = 64, norm_min_history: int = 8,
                 norm_screen: bool = True):
        if norm_window < 1 or norm_min_history < 1:
            raise ValueError("norm_window and norm_min_history must be >= 1")
        self.fingerprint = params_fingerprint(template)
        self.norm_k = norm_k
        self.norm_min_history = norm_min_history
        self.norm_screen = norm_screen
        self._norms = collections.deque(maxlen=norm_window)
        reg = telemetry.get_registry()
        self._c_rejected = {r: reg.counter(
            "fedml_cohort_wave_rejected_total", reason=r)
            for r in self.REASONS}
        self.rejected: Dict[str, int] = {r: 0 for r in self.REASONS}
        self.admitted = 0
        # an identity-keyed f64 host copy of the round's global: one
        # conversion a round, not one a wave
        self._ref_cache: Tuple[object, Optional[list]] = (None, None)

    def round_start(self) -> None:
        """Open a round: clear the norm history."""
        self._norms.clear()

    def _reject(self, reason: str,
                norm: Optional[float] = None) -> AdmissionVerdict:
        self.rejected[reason] += 1
        self._c_rejected[reason].inc()
        return AdmissionVerdict(False, reason=reason, norm=norm)

    def norm_threshold(self) -> Optional[float]:
        return norm_outlier_threshold(self._norms, self.norm_k,
                                      self.norm_min_history)

    def screen(self, wave_mean, global_params) -> AdmissionVerdict:
        """Screen one wave's summary against the round's global (host
        trees); structure before any tree math."""
        try:
            fp_ok = params_fingerprint(wave_mean) == self.fingerprint
        except Exception:  # noqa: BLE001 — unhashable garbage summary
            fp_ok = False
        if not fp_ok:
            return self._reject("fingerprint")
        if not _all_finite(wave_mean):
            return self._reject("nonfinite")
        if self._ref_cache[0] is not global_params:
            self._ref_cache = (global_params,
                               [np.asarray(leaf, np.float64)
                                for leaf in _leaves(global_params)])
        norm = _update_norm(wave_mean, self._ref_cache[1])
        if self.norm_screen:
            thresh = self.norm_threshold()
            if thresh is not None and norm > thresh:
                return self._reject("norm_outlier", norm)
            self._norms.append(norm)
        self.admitted += 1
        return AdmissionVerdict(True, norm=norm)
