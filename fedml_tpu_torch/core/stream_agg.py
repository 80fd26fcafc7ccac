"""Streaming O(model)-memory mean aggregation, folded at arrival.

Port of ``fedml_tpu/core/stream_agg.py`` (the ``mean`` regime).  Each
admitted upload folds into running state on the receive path,

    acc += clip(upload, reference) * w,      wsum += w,

and the barrier close does one ``finalize``: ``acc / wsum`` plus the
round's weak-DP noise.  Nothing model-sized is held per silo.

The arithmetic is the JAX package's, operation for operation, so that on
the CPU the two packages agree bit for bit where XLA's CPU code and
PyTorch's CPU kernels round alike:

* the fold is one fused multiply-add per element (``acc.add_(u,
  alpha=w)``), which is how XLA compiles ``acc + u * w``; the clip's
  ``g + (u - g) * scale`` likewise (``torch.add(g, u - g, alpha=scale)``);
* the clip scale is the JAX package's ``min(1, bound / max(||u - g||,
  1e-12))`` in f32, but XLA and PyTorch sum the squares in different
  orders, so a clipped fold agrees with JAX's to float tolerance, not
  bits;
* the wave fold is a sequential per-slot loop, never a ``sum(dim=0)``
  (which would reorder the additions); a weight-0 slot adds an exact
  ``+0.0``;
* the accumulator dtype follows `acc_dtype` (floats in their own dtype,
  ints in f32), shared with the sharded spine (`zeros_acc_like`).

``wsum``, the clip scale and the step are host scalars: the scale costs
one ``.item()`` (a device sync) per clipped fold.

The weak-DP noise of this (unfused) finalize comes from a
``torch.Generator`` seeded from the JAX key chain's words
(``fold_in(key(seed), step)``): the same distribution as JAX's threefry
normal, not the same bits.

The order-statistic rules (median, trimmed mean, Krum, multi-Krum,
geometric median) need a population, so they stream into a **reservoir**
of ``reservoir_k`` slots instead (Vitter's Algorithm R over
``np.random.RandomState(seed)``, the JAX package's draws, so the same
uploads land in the same slots); ``finalize`` runs
`robust.defense.make_defended_aggregate` over the ``[K, ...]`` reservoir,
unfilled slots at weight 0.  Up to K uploads the rule sees every upload;
beyond that a uniform K-subsample.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import (Tree, acc_dtype, as_tensor,
                                         tree_keys)
from fedml_tpu_torch.core.robust import (add_gaussian_noise,
                                         default_is_weight_param)
from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

STREAM_MODES = ("stream", "stack")
ROBUST_AGG_METHODS = ("mean", "coordinate_median", "trimmed_mean", "krum",
                      "multi_krum", "geometric_median")


def zeros_acc_like(reference: Tree) -> Tree:
    """A fresh fold accumulator for ``reference``: same shapes and device,
    leaves in `acc_dtype`.  Shared with the sharded spine — the
    accumulator-dtype contract must stay one definition."""
    return {k: torch.zeros(v.shape, dtype=acc_dtype(v.dtype), device=v.device)
            for k, v in reference.items()}


def update_sumsq(upload: Tree, reference: Tree, keys: Iterable[str]
                 ) -> torch.Tensor:
    """``sum((u - g)^2)`` over ``keys`` in that order: the difference in
    the leaf's own dtype, squared and summed in f32, the per-leaf sums
    added in order — the JAX package's norm, step for step."""
    total = 0.0
    for k in keys:
        d = upload[k] - reference[k]
        total = total + torch.sum(torch.square(d.to(torch.float32)))
    return torch.as_tensor(total, dtype=torch.float32)


def clip_scale(partials: Sequence[float], norm_clip: float) -> float:
    """``min(1, clip / max(sqrt(sum partials), 1e-12))`` in f32 on the
    host, the partials summed in the order given."""
    total = np.float32(0.0)
    for p in partials:
        total = np.float32(total + np.float32(p))
    norm = np.sqrt(total)
    return float(min(np.float32(1.0),
                     np.float32(norm_clip) / max(norm, np.float32(1e-12))))


def fold_pieces(acc: Tree, upload: Tree, reference: Tree, weight: float,
                scale: Optional[float], clipped: Callable[[str], bool]
                ) -> None:
    """``acc[k] += clip(u[k]) * weight`` in place, one fused multiply-add
    per element; ``clipped(k)`` selects the leaves the clip ``scale``
    applies to (``scale=None``: no clip)."""
    for k in sorted(acc):
        a, u = acc[k], upload[k]
        if scale is not None and clipped(k):
            g = reference[k]
            if u.dtype.is_floating_point:
                u = torch.add(g, u - g, alpha=scale)
            else:   # JAX casts the scale to the leaf's integer dtype
                u = g + (u - g) * int(scale)
        a.add_(u.to(a.dtype), alpha=weight)


def noise_generator(seed: int, step: int, device,
                    shard: Optional[int] = None) -> torch.Generator:
    """A generator seeded from the words of ``fold_in(key(seed), step)``
    (and ``fold_in(., shard)`` for a shard's stream)."""
    key = prng.fold_in(prng.key(seed), int(step) & 0xFFFFFFFF)
    if shard is not None:
        key = prng.fold_in(key, shard)
    gen = torch.Generator(device=device)
    gen.manual_seed((key[0] << 32) | key[1])
    return gen


def divide(acc: Tree, wsum: float, reference: Tree) -> Tree:
    """``acc / wsum`` (an IEEE division by a device scalar) cast to each
    reference leaf's dtype."""
    out = {}
    for k in sorted(acc):
        a = acc[k]
        w = torch.tensor(wsum, dtype=a.dtype, device=a.device)
        out[k] = (a / w).to(reference[k].dtype)
    return out


class StreamingAggregator:
    """O(model)-memory fold-at-arrival (defended) mean.

    Round protocol::

        agg.reset(global_params)          # round open (broadcast)
        agg.fold(upload, num_samples)     # per admitted upload, at arrival
        new_global = agg.finalize(step)   # barrier close

    Trees are the port's flat dicts; an upload may hold host arrays (the
    decoded wire frame), which move to the aggregator's device.
    ``template`` fixes the leaf set and the device (``device`` overrides
    it); ``norm_clip > 0`` clips each upload against the round's
    reference, ``noise_std > 0`` noises the finalize.

    ``sentry``/``device_obs``: the perf recorder's `RecompileSentry` and
    `obs.device.DeviceRecorder`; with the recorder the per-upload fold
    and the finalize are instrumented as ``stream_fold[method]`` and
    ``stream_finalize[method]`` (compile ledger, FLOPs from the work
    table), their signatures noted under ``stream_agg[method]``.
    """

    def __init__(self, template: Tree, *, method: str = "mean",
                 kind: str = "params", norm_clip: float = 0.0,
                 noise_std: float = 0.0, seed: int = 0,
                 reservoir_k: int = 64, trim_frac: float = 0.1,
                 byz_f: int = 0, krum_m: int = 1, gm_iters: int = 8,
                 gm_eps: float = 1e-6, is_weight=default_is_weight_param,
                 device=None, sentry=None, device_obs=None):
        from fedml_tpu_torch.robust.defense import make_defended_aggregate
        if method not in ROBUST_AGG_METHODS:
            raise ValueError(f"unknown streaming aggregation method "
                             f"{method!r}; available: {ROBUST_AGG_METHODS}")
        if kind not in ("params", "delta"):
            raise ValueError(f"kind must be 'params' or 'delta', got {kind!r}")
        if reservoir_k < 1:
            raise ValueError(f"reservoir_k must be >= 1, got {reservoir_k}")
        if norm_clip < 0 or noise_std < 0:
            raise ValueError(f"norm_clip/noise_std must be >= 0, got "
                             f"{norm_clip}/{noise_std}")
        self.method = method
        self.kind = kind
        self.norm_clip = float(norm_clip)
        self.noise_std = float(noise_std)
        self.seed = int(seed)
        self.reservoir_k = int(reservoir_k)
        self.defended = method != "mean" or norm_clip > 0 or noise_std > 0
        self._rule = None
        if method != "mean":
            self._rule = make_defended_aggregate(
                method, trim_frac=trim_frac, byz_f=byz_f, krum_m=krum_m,
                gm_iters=gm_iters, gm_eps=gm_eps, norm_clip=norm_clip,
                noise_std=noise_std, seed=seed, is_weight=is_weight)
        self._keys = tree_keys(template)
        self._weights = [k for k in self._keys if is_weight(k)]
        self._is_weight = is_weight
        if device is None:
            device = next((v.device for v in template.values()
                           if isinstance(v, torch.Tensor)), "cpu")
        self.device = torch.device(device)
        reg = telemetry.get_registry()
        self._c_folds = reg.counter("fedml_stream_folds_total")
        self._c_evict = reg.counter("fedml_stream_evictions_total")
        self._g_reservoir = reg.gauge("fedml_stream_reservoir_fill_total")
        self._h_finalize = reg.histogram("fedml_stream_finalize_seconds")
        self._reference: Optional[Tree] = None
        self._acc: Optional[Tree] = None
        self._wsum = np.float32(0.0)
        self.count = 0
        self.weight_total = 0.0
        # the reservoir: [K, ...] leaves on the device, weight 0 where no
        # upload of this round sits
        self._seen = 0
        self._res_stack: Optional[Tree] = None
        self._res_weights: Optional[np.ndarray] = None
        self._res_rng = np.random.RandomState(seed)
        self._fold_fn = self._fold_one
        self._finalize_fn = (self._finalize_mean if self._rule is None
                             else self._rule)
        if device_obs is not None:
            from fedml_tpu_torch.obs.device import kernel_flops
            d = sum(int(v.numel()) if isinstance(v, torch.Tensor)
                    else int(np.size(v)) for v in template.values())
            family = f"stream_agg[{method}]"
            clip = norm_clip > 0
            self._fold_fn = device_obs.instrument(
                f"stream_fold[{method}]", self._fold_one, sentry=sentry,
                sentry_name=family,
                flops=lambda *a: kernel_flops("stream_fold", d=d, clip=clip))
            self._finalize_fn = device_obs.instrument(
                f"stream_finalize[{method}]", self._finalize_fn,
                sentry=sentry, sentry_name=family,
                flops=(None if self._rule is not None else
                       lambda *a: kernel_flops("stream_finalize", d=d,
                                               sigma=noise_std)))

    @property
    def reference(self) -> Optional[Tree]:
        """The round's clip reference (None between rounds)."""
        return self._reference

    def _on_device(self, tree) -> Tree:
        return {k: as_tensor(tree[k], self.device) for k in self._keys}

    def reset(self, reference: Tree) -> None:
        """Open a round against ``reference`` (the current global);
        ``kind="delta"`` clips against zeros instead."""
        ref = self._on_device(reference)
        if self.kind == "delta":
            ref = {k: torch.zeros_like(v) for k, v in ref.items()}
        self._reference = ref
        self._acc = None
        self._wsum = np.float32(0.0)
        self.count = 0
        self.weight_total = 0.0
        self._seen = 0
        if self._res_weights is not None:
            self._res_weights[:] = 0.0
        self._g_reservoir.set(0)

    def _ensure_acc(self) -> None:
        if self._acc is None:
            self._acc = zeros_acc_like(self._reference)
            self._wsum = np.float32(0.0)

    def _fold_one(self, upload: Tree, weight) -> None:
        scale = None
        if self.norm_clip > 0:
            scale = clip_scale(
                [update_sumsq(upload, self._reference, self._weights).item()],
                self.norm_clip)
        w = np.float32(weight)
        fold_pieces(self._acc, upload, self._reference, float(w), scale,
                    self._is_weight)
        self._wsum = np.float32(self._wsum + w)

    def _ensure_reservoir(self) -> None:
        """The ``[K, ...]`` reservoir, every slot first holding the
        reference (the zero update every rule masks out)."""
        if self._res_stack is not None:
            return
        k = self.reservoir_k
        self._res_stack = {
            key: v[None].repeat((k,) + (1,) * v.dim()).contiguous()
            for key, v in self._reference.items()}
        self._res_weights = np.zeros(k, np.float32)

    def fold(self, upload, weight) -> None:
        """Fold one ADMITTED upload at arrival."""
        if self._reference is None:
            raise RuntimeError("fold() before reset(): the round's clip "
                               "reference is not set")
        if self.method != "mean":
            # check before counting or drawing: a malformed upload fails
            # on every arrival, not only when it wins a slot
            if sorted(upload) != sorted(self._keys):
                raise ValueError("upload does not match the aggregation "
                                 "template (leaf set mismatch)")
            self._fold_reservoir(upload, weight)
            return
        upload = self._on_device(upload)
        self._ensure_acc()
        self._fold_fn(upload, weight)
        self._c_folds.inc()
        self.count += 1
        self.weight_total += float(weight)

    def _fold_reservoir(self, upload, weight) -> None:
        """Algorithm R: the first K uploads fill the slots; upload i > K
        replaces a uniform slot with probability K/i, so at round close
        every upload sits in the reservoir with probability K/n."""
        self._ensure_reservoir()
        self._c_folds.inc()
        self.count += 1
        self.weight_total += float(weight)
        self._seen += 1
        if self._seen <= self.reservoir_k:
            slot = self._seen - 1
        else:
            slot = int(self._res_rng.randint(self._seen))
            self._c_evict.inc()
            if slot >= self.reservoir_k:
                return   # the arriving upload is the one evicted
        for k, buf in self._res_stack.items():
            buf[slot].copy_(as_tensor(upload[k], self.device))
        self._res_weights[slot] = np.float32(weight)
        self._g_reservoir.set(int((self._res_weights > 0).sum()))

    def fold_wave(self, stacked, weights) -> None:
        """Fold a ``[wave, ...]`` stack slot by slot, in slot order — the
        per-upload fold's exact sequence.  Weight-0 slots add an exact
        ``+0.0`` and do not count as folds."""
        if self._reference is None:
            raise RuntimeError("fold_wave() before reset(): the round's "
                               "clip reference is not set")
        if self.method != "mean":
            raise RuntimeError(
                f"fold_wave: only the streaming mean folds pre-stacked "
                f"waves; {self.method!r} needs the per-client population "
                f"— fold() each upload into the reservoir instead")
        stacked = self._on_device(stacked)
        w_host = np.asarray(weights, np.float32)
        self._ensure_acc()
        for i, w in enumerate(w_host):
            self._fold_fn({k: v[i] for k, v in stacked.items()}, w)
        live = int((w_host > 0).sum())
        self._c_folds.inc(live)
        self.count += live
        for w in w_host:   # slot-order sequential host adds
            self.weight_total += float(w)

    def finalize(self, step: int) -> Tree:
        """Close the round: ``acc / wsum`` (+ noise keyed by ``step``).
        Callers must skip aggregation on a round with no folds."""
        if self.count == 0:
            raise RuntimeError("finalize() with no folded uploads; the "
                               "caller must skip aggregation on an empty "
                               "round")
        t0 = time.perf_counter()
        if self._rule is not None:
            out = self._finalize_fn(self._reference, self._res_stack,
                                    self._res_weights.copy(), step)
            self._h_finalize.observe(time.perf_counter() - t0)
            return out
        out = self._finalize_fn(self._acc, float(self._wsum),
                                self._reference, step)
        self._acc = None
        self._h_finalize.observe(time.perf_counter() - t0)
        return out

    def _finalize_mean(self, acc: Tree, wsum: float, reference: Tree,
                       step: int) -> Tree:
        out = divide(acc, wsum, reference)
        if self.noise_std > 0:
            out = add_gaussian_noise(
                out, noise_generator(self.seed, step, self.device),
                self.noise_std)
        return out

    def state_dict(self, include_reference: bool = False
                   ) -> Dict[str, object]:
        """Host snapshot of the fold state: the accumulator leaves in key
        order (their own dtype), ``wsum`` f32, the counts.  A reservoir
        round has no snapshot (its draws are not part of the state).
        ``include_reference`` adds the round's reference leaves: an edge
        aggregator snapshots it, since a respawned edge has no live root
        sync to re-learn the round global from."""
        if self.method != "mean":
            raise RuntimeError(
                f"state_dict: only the streaming mean fold snapshots; "
                f"{self.method!r} rounds are abort-only on crash")
        return {
            "acc": (None if self._acc is None else
                    [self._acc[k].cpu().numpy() for k in self._keys]),
            "wsum": np.float32(self._wsum),
            "count": int(self.count),
            "weight_total": float(self.weight_total),
            **({"reference": [self._reference[k].cpu().numpy()
                              for k in self._keys]}
               if include_reference else {})}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a snapshot mid-round; one that carries a ``reference``
        re-opens the round from it, else the caller has ``reset()`` the
        round first."""
        if self.method != "mean":
            raise RuntimeError("load_state_dict: reservoir rounds are "
                               "abort-only; nothing to restore")
        if state.get("reference") is not None:
            self.reset({k: np.asarray(a)
                        for k, a in zip(self._keys, state["reference"])})
        if self._reference is None:
            raise RuntimeError("load_state_dict before reset(): the round's "
                               "clip reference is not set and the snapshot "
                               "carries none")
        if state.get("acc") is not None:
            self._acc = {k: torch.as_tensor(np.array(a)).to(self.device)
                         for k, a in zip(self._keys, state["acc"])}
            self._wsum = np.float32(state["wsum"])
        self.count = int(state["count"])
        self.weight_total = float(state["weight_total"])
