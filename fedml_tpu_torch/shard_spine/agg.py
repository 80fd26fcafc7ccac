"""The sharded streaming fold: `core.stream_agg.StreamingAggregator`'s
state laid out per `ShardPlan` shard.

Port of ``fedml_tpu/shard_spine/agg.py``.  It speaks the same protocol as
the replicated aggregator (``reset`` / ``fold`` / ``fold_wave`` /
``finalize`` / ``state_dict`` / ``load_state_dict`` / ``count`` /
``weight_total`` / ``reference`` / ``defended`` / ``method``) plus
``fold_slices`` for uploads that arrive as per-shard wire slices.

Fold math (the JAX package's contract):

* **unclipped** — per shard, ``acc_s += u_s * w`` elementwise, the same
  per-element fused multiply-add the replicated fold runs, so sharded and
  replicated accumulators agree bit for bit at any S;
* **clipped** — the clip scale needs the GLOBAL update norm, so it is two
  phase: each shard computes its slice's partial ``sum((u - g)^2)``, the
  host combines the partials (in shard order) into ``min(1, clip /
  ||u - g||)``, and every shard folds ``g + (u - g) * scale``.  At S = 1
  this is the replicated fold bit for bit; at S > 1 the partials sum in
  shard order instead of leaf order, so results agree to float tolerance;
* **finalize** — per shard, ``acc / wsum (+ noise)``: with ``fused`` one
  launch of K2 (`core.fused_agg.make_fused_shard_finalize`, the CUDA
  kernel on the GPU, its plain version on the CPU), else the compose
  (division, then `core.robust.add_gaussian_noise` from a generator keyed
  by ``(seed, step[, shard])``).  At sigma = 0 the two are bit-identical.

``wsum``, ``step`` and the clip scale stay host scalars across shards, as
in the JAX package; each clipped fold reads its S partials back with one
``.item()`` each.  Every shard's state lives on its device (``devices``,
one per shard); with none given all shards share the default device.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.core.fused_agg import make_fused_shard_finalize
from fedml_tpu_torch.core.pytree import Tree, as_tensor, tree_keys
from fedml_tpu_torch.core.robust import add_gaussian_noise
from fedml_tpu_torch.core.stream_agg import (clip_scale, divide,
                                             fold_pieces, noise_generator,
                                             update_sumsq, zeros_acc_like)
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.shard_spine.plan import ShardPlan, _leaf_key, _shard_key

log = logging.getLogger(__name__)


class ShardedStreamingAggregator:
    """O(model/S)-per-shard fold-at-arrival defended mean.

    ``plan``: the layout.  ``template``: the port's flat params dict (its
    device is the default shard device).  ``devices``: one device per
    shard, or None to keep every shard on the default device.  Mean only:
    order-statistic rules need the per-upload population, which a sharded
    fold never materializes.
    """

    def __init__(self, plan: ShardPlan, template: Tree, *,
                 kind: str = "params", norm_clip: float = 0.0,
                 noise_std: float = 0.0, seed: int = 0, fused: bool = False,
                 devices: Optional[Sequence] = None, device=None,
                 sentry=None, device_obs=None):
        if kind != "params":
            raise ValueError(
                f"the sharded spine folds cross-silo params uploads only "
                f"(kind='params'); got kind={kind!r} — the async delta "
                f"path is not sharded")
        if norm_clip < 0 or noise_std < 0:
            raise ValueError(f"norm_clip/noise_std must be >= 0, got "
                             f"{norm_clip}/{noise_std}")
        self.plan = plan
        self.method = "mean"
        self.kind = kind
        self.norm_clip = float(norm_clip)
        self.noise_std = float(noise_std)
        self.seed = int(seed)
        self.fused = bool(fused)
        self.defended = norm_clip > 0 or noise_std > 0
        self._keys = tree_keys(template)
        if device is None:
            device = next((v.device for v in template.values()
                           if isinstance(v, torch.Tensor)), "cpu")
        S = plan.num_shards
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None
                        else [torch.device(device)] * S)
        if len(self.devices) != S:
            raise ValueError(f"{len(self.devices)} devices for {S} shards")
        # per shard: slice key -> counts toward the clip norm
        self._flags = [dict(zip(sorted(self._leaf_keys(s)),
                                plan.slice_weight_flags(s)))
                       for s in range(S)]
        self._finalize_fns = (
            [make_fused_shard_finalize(noise_std=noise_std, seed=seed,
                                       shard_salt=s) for s in range(S)]
            if fused else [self._compose_finalize(s) for s in range(S)])
        self._fold_fns = [fold_pieces] * S
        if device_obs is not None:
            self._instrument(device_obs, sentry)
        if sentry is not None and fused:
            sentry.register("shard_spine[mean]", self)
        reg = telemetry.get_registry()
        self._c_folds = reg.counter("fedml_stream_folds_total")
        self._c_slices = reg.counter("fedml_shard_slices_total")
        self._c_fused = reg.counter("fedml_shard_fused_launches_total")
        self._g_acc_bytes = reg.gauge("fedml_shard_acc_bytes")
        self._h_finalize = reg.histogram("fedml_shard_finalize_seconds")
        self._reference: Optional[List[Tree]] = None
        self._acc: Optional[List[Tree]] = None
        self._wsum = np.float32(0.0)
        self.count = 0
        self.weight_total = 0.0

    def _instrument(self, device_obs, sentry) -> None:
        """Per-shard ``shard_fold[s]`` and ``fused_finalize[s]`` (or
        ``shard_finalize[s]``) in the device observatory, their FLOPs
        from the work table (K2's for the fused finalize)."""
        from fedml_tpu_torch.obs.device import kernel_flops
        family = "shard_spine[mean]"
        label = "fused_finalize" if self.fused else "shard_finalize"
        kernel = "shard_finalize" if self.fused else "stream_finalize"
        clip, sigma = self.norm_clip > 0, self.noise_std
        for s in range(self.plan.num_shards):
            d_all = self.plan.slice_numel(s, floats_only=False)
            d_float = self.plan.slice_numel(s)
            self._fold_fns[s] = device_obs.instrument(
                f"shard_fold[s{s}]", fold_pieces, sentry=sentry,
                sentry_name=family,
                flops=lambda *a, d=d_all: kernel_flops(
                    "stream_fold", d=d, clip=clip))
            self._finalize_fns[s] = device_obs.instrument(
                f"{label}[s{s}]", self._finalize_fns[s], sentry=sentry,
                sentry_name=family,
                flops=lambda *a, d=d_float: kernel_flops(
                    kernel, d=d, sigma=sigma))

    def _cache_size(self) -> int:
        """What the fused finalize built: K2's library, once loaded (the
        recompile sentry's probe)."""
        from fedml_tpu_torch.utils import cuda_build
        return int("shard_finalize" in cuda_build._loaded)

    def _leaf_keys(self, shard: int) -> List[str]:
        return [_leaf_key(i) for i in self.plan.members[shard]]

    def _compose_finalize(self, shard: int):
        noise, seed, S = self.noise_std, self.seed, self.plan.num_shards

        def finalize(acc, wsum, reference, step):
            out = divide(acc, wsum, reference)
            if noise > 0:
                # per-shard streams; at S = 1 the replicated key chain
                gen = noise_generator(seed, step, self.devices[shard],
                                      shard=shard if S > 1 else None)
                out = add_gaussian_noise(out, gen, noise)
            return out

        return finalize

    # -- round lifecycle -----------------------------------------------------
    @property
    def reference(self):
        return self._reference

    def _place(self, shard: int, body) -> Tree:
        """One shard's pieces (host arrays or tensors) on its device."""
        dev = self.devices[shard]
        return {k: as_tensor(v, dev) for k, v in body.items()}

    def _split_body(self, tree) -> List[dict]:
        """Full flat tree -> per-shard slice BODIES."""
        slices = self.plan.split_leaves([tree[k] for k in self._keys])
        return [sl[_shard_key(s)] for s, sl in enumerate(slices)]

    def reset(self, reference: Tree) -> None:
        self._reference = [self._place(s, body) for s, body in
                           enumerate(self._split_body(reference))]
        self._acc = None
        self._wsum = np.float32(0.0)
        self.count = 0
        self.weight_total = 0.0

    def _ensure_acc(self) -> None:
        if self._acc is not None:
            return
        self._acc = [zeros_acc_like(ref) for ref in self._reference]
        self._wsum = np.float32(0.0)
        self._g_acc_bytes.set(max(
            sum(v.numel() * v.element_size() for v in body.values())
            for body in self._acc))

    def _slice_bodies(self, slices: Sequence[dict]) -> List[dict]:
        """Unwrap wire slices (``{"s<idx>": body}``); plain bodies pass
        through."""
        S = self.plan.num_shards
        if len(slices) != S:
            raise ValueError(f"fold_slices needs {S} slices, got "
                             f"{len(slices)}")
        return [sl[_shard_key(s)] if _shard_key(s) in sl else sl
                for s, sl in enumerate(slices)]

    def _scale(self, bodies: List[Tree]) -> Optional[float]:
        """The two-phase clip scale of one upload (None: no clip)."""
        if self.norm_clip <= 0:
            return None
        partials = [
            update_sumsq(bodies[s], self._reference[s],
                         [k for k in sorted(bodies[s]) if self._flags[s][k]]
                         ).item()
            for s in range(self.plan.num_shards)]
        return clip_scale(partials, self.norm_clip)

    def _fold_bodies(self, bodies: List[Tree], weight) -> None:
        scale = self._scale(bodies)
        w = np.float32(weight)
        for s in range(self.plan.num_shards):
            self._fold_fns[s](self._acc[s], bodies[s], self._reference[s],
                              float(w), scale, self._flags[s].__getitem__)
        self._wsum = np.float32(self._wsum + w)

    def fold_slices(self, slices: Sequence[dict], weight) -> None:
        """Fold one ADMITTED upload, delivered as its S shard slices."""
        if self._reference is None:
            raise RuntimeError("fold_slices() before reset(): the "
                               "round's clip reference is not set")
        bodies = [self._place(s, b) for s, b in
                  enumerate(self._slice_bodies(slices))]
        self._ensure_acc()
        self._fold_bodies(bodies, weight)
        self._c_folds.inc()
        self._c_slices.inc(self.plan.num_shards)
        self.count += 1
        self.weight_total += float(weight)

    def fold(self, upload: Tree, weight) -> None:
        """A full flat-tree upload, split on the host and folded per
        shard."""
        self.fold_slices(self._split_body(upload), weight)

    def fold_wave(self, stacked: Tree, weights) -> None:
        """Fold a ``[wave, ...]`` stack slot by slot, in slot order, per
        shard — the per-upload fold's exact sequence.  Weight-0 slots add
        an exact ``+0.0``."""
        if self._reference is None:
            raise RuntimeError("fold_wave() before reset(): the round's "
                               "clip reference is not set")
        w_host = np.asarray(weights, np.float32)
        self._ensure_acc()
        for i, w in enumerate(w_host):
            self._fold_bodies(
                [self._place(s, b) for s, b in enumerate(self._split_body(
                    {k: stacked[k][i] for k in self._keys}))], w)
        live = int((w_host > 0).sum())
        self._c_folds.inc(live)
        self._c_slices.inc(live * self.plan.num_shards)
        self.count += live
        for w in w_host:
            self.weight_total += float(w)

    def finalize(self, step: int) -> Tree:
        """Close the round: per shard ``acc / wsum (+ noise)`` — the
        compose or ONE fused launch per shard — then the exact join back
        to the full flat tree on the first shard's device."""
        if self.count == 0:
            raise RuntimeError("finalize() with no folded uploads; the "
                               "caller must skip aggregation on an empty "
                               "round")
        t0 = time.perf_counter()
        wsum = float(self._wsum)
        out_slices = []
        for s in range(self.plan.num_shards):
            out = self._finalize_fns[s](self._acc[s], wsum,
                                        self._reference[s], int(step))
            if self.fused:
                self._c_fused.inc()
            out_slices.append({_shard_key(s): {
                k: v.to(self.devices[0]) for k, v in out.items()}})
        self._acc = None
        leaves = self.plan.join_slices(out_slices)
        self._h_finalize.observe(time.perf_counter() - t0)
        return dict(zip(self._keys, leaves))

    # -- snapshots -----------------------------------------------------------
    def state_dict(self) -> dict:
        """The sharded accumulator as one flat host leaf list (shard-major,
        slice-key order), plus the plan fingerprint."""
        acc = None
        if self._acc is not None:
            acc = [body[k].cpu().numpy()
                   for body in self._acc for k in sorted(body)]
        return {"acc": acc, "wsum": np.float32(self._wsum),
                "count": int(self.count),
                "weight_total": float(self.weight_total),
                "shard_fp": int(self.plan.fingerprint())}

    def load_state_dict(self, state: dict) -> None:
        if self._reference is None:
            raise RuntimeError("load_state_dict before reset(): the "
                               "round's clip reference is not set")
        snap_fp = state.get("shard_fp")
        if snap_fp is None or int(snap_fp) != int(self.plan.fingerprint()):
            raise ValueError(
                "snapshot was taken under a different shard plan (or by "
                "the replicated fold); restoring it would fold state into "
                "the wrong slots")
        if state.get("acc") is not None:
            flat = [np.asarray(a) for a in state["acc"]]
            pos, acc = 0, []
            for s, ref in enumerate(self._reference):
                body = {}
                for k in sorted(ref):
                    body[k] = flat[pos]
                    pos += 1
                acc.append(self._place(s, {k: np.array(v)
                                           for k, v in body.items()}))
            if pos != len(flat):
                raise ValueError(
                    f"snapshot holds {len(flat)} accumulator pieces but "
                    f"the plan expects {pos}")
            self._acc = acc
            self._wsum = np.float32(state["wsum"])
        self.count = int(state["count"])
        self.weight_total = float(state["weight_total"])
