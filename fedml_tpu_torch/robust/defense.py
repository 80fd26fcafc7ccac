"""The defended aggregate: clip + rule + noise over a static cohort stack.

Port of ``fedml_tpu/robust/defense.py``.  A server stacks the round's
admitted uploads into the static ``[N, ...]`` cohort shape (missing,
rejected or quarantined slots hold a copy of the global with weight 0)
and calls ``fn(global_params, stacked, weights, step)``:

1. **norm-diff clipping** of each slot's update to ``norm_clip``;
2. **aggregation**: the mean, or a `core/byzantine.py` rule, all of which
   ignore weight-0 slots;
3. **weak-DP noise** on the aggregate, keyed by ``step``.

The mean is a sequential fold in cohort order, slot by slot, with the
streaming fold's own functions (``core/stream_agg.py``: the clip scale,
one fused multiply-add per element, the division by a host f32 weight
total) and its noise generator, so stack mode and stream mode give the
same bits when the uploads fold in slot order; a weight-0 slot adds an
exact ``+0.0``.  A Byzantine rule clips every slot against the global
first (`core.robust.clip_update`, slot by slot).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch.core.byzantine import METHODS, make_byzantine_aggregate
from fedml_tpu_torch.core.pytree import Tree, tree_keys, tree_stack
from fedml_tpu_torch.core.robust import (add_gaussian_noise, clip_update,
                                         default_is_weight_param)

ROBUST_AGG_METHODS = ("mean",) + METHODS


def make_defended_aggregate(method: str = "mean", *, trim_frac: float = 0.1,
                            byz_f: int = 0, krum_m: int = 1,
                            gm_iters: int = 8, gm_eps: float = 1e-6,
                            norm_clip: float = 0.0, noise_std: float = 0.0,
                            seed: int = 0,
                            is_weight=default_is_weight_param,
                            sentry=None, device=None) -> Callable:
    """Build ``fn(global_params, stacked, weights, step) -> new_params``.

    ``stacked``: the ``[N, ...]`` cohort tree on the global's device;
    ``weights``: ``[N]`` raw sample counts, 0 for masked slots (callers
    skip aggregation when every weight is 0); ``step`` keys the round's
    noise.

    ``sentry``/``device``: the perf recorder's `RecompileSentry` and
    `obs.device.DeviceRecorder`; with the recorder the returned callable
    is its wrapper, ``defended_aggregate[method]`` in the compile ledger
    (the mean's FLOPs from the work table: a clipped fold a slot and the
    finalize), its signatures noted in the sentry."""
    from fedml_tpu_torch.core import stream_agg as sa

    if method not in ROBUST_AGG_METHODS:
        raise ValueError(f"unknown robust aggregation method {method!r}; "
                         f"available: {ROBUST_AGG_METHODS}")
    if norm_clip < 0 or noise_std < 0:
        raise ValueError(f"norm_clip/noise_std must be >= 0, got "
                         f"{norm_clip}/{noise_std}")
    base = None if method == "mean" else make_byzantine_aggregate(
        method, trim_frac=trim_frac, byz_f=byz_f, krum_m=krum_m,
        gm_iters=gm_iters, gm_eps=gm_eps)

    def _scan_mean(global_params: Tree, stacked: Tree, weights) -> Tree:
        keys = tree_keys(global_params)
        clip_keys = [k for k in keys if is_weight(k)]
        acc = sa.zeros_acc_like(global_params)
        wsum = np.float32(0.0)
        if torch.is_tensor(weights):
            weights = weights.detach().cpu().numpy()
        for i, w in enumerate(np.asarray(weights, np.float32)):
            upload = {k: stacked[k][i] for k in keys}
            scale = None
            if norm_clip > 0:
                scale = sa.clip_scale(
                    [sa.update_sumsq(upload, global_params,
                                     clip_keys).item()], norm_clip)
            sa.fold_pieces(acc, upload, global_params, float(w), scale,
                           is_weight)
            wsum = np.float32(wsum + w)
        return sa.divide(acc, float(wsum), global_params)

    def aggregate(global_params: Tree, stacked: Tree, weights,
                  step: int) -> Tree:
        if base is None:
            out = _scan_mean(global_params, stacked, weights)
        else:
            if norm_clip > 0:
                n = next(iter(stacked.values())).shape[0]
                stacked = tree_stack([clip_update(
                    {k: v[i] for k, v in stacked.items()}, global_params,
                    norm_clip, is_weight) for i in range(n)])
            out = base(stacked, weights)
        if noise_std > 0:
            device = next(iter(out.values())).device
            out = add_gaussian_noise(out, sa.noise_generator(seed, step,
                                                             device),
                                     noise_std)
        return out

    if device is not None:
        from fedml_tpu_torch.obs.device import kernel_flops

        def flops(global_params, stacked, weights, step):
            d = sum(int(v.numel()) for v in global_params.values())
            n = next(iter(stacked.values())).shape[0]
            return (n * kernel_flops("stream_fold", d=d,
                                     clip=norm_clip > 0)
                    + kernel_flops("stream_finalize", d=d,
                                   sigma=noise_std))

        aggregate = device.instrument(
            f"defended_aggregate[{method}]", aggregate, sentry=sentry,
            flops=flops if base is None else None)
    return aggregate
