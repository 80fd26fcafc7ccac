"""The cohort engine: one FL round over a stacked cohort.

Port of ``fedml_tpu/parallel/cohort.py`` (single device; the mesh,
device-resident and scanned-round paths are not ported).  A cohort is a
dict of tensors ``{x, y, mask: [C, S, B, ...], num_samples: [C]}``; the
local trainer runs over its client axis in one of two ways, which give
identical stacked outputs:

* ``"vmap"`` — ``torch.func.vmap`` trains all clients together; convs
  with per-client weights become grouped convs;
* ``"scan"`` — a Python loop trains one client at a time; every conv is a
  dense cuDNN conv.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch.func import vmap

from fedml_tpu_torch.core.pytree import Tree, tree_stack, tree_weighted_mean

CohortData = Dict[str, torch.Tensor]


def client_generator(seed_words: Sequence[int], slot: int,
                     device) -> torch.Generator:
    """The noise generator of one cohort slot in one round, keyed by the
    round's seed words and the slot's index in the cohort."""
    seq = np.random.SeedSequence([int(w) & 0xFFFFFFFF for w in seed_words]
                                 + [0x7FFFFFFF, int(slot)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
    return gen


def train_cohort(local_train, params: Tree, data: CohortData,
                 seed_words: Sequence[int] = (0, 0), transform_update=None,
                 client_axis: str = "vmap"):
    """Run ``local_train`` over the stacked client axis; returns the
    stacked client params and metrics.  ``transform_update(client_params,
    global_params, generator) -> client_params`` runs per client after
    training (the defense hook)."""
    if client_axis not in ("vmap", "scan"):
        raise ValueError(f"client_axis must be 'vmap' or 'scan', "
                         f"got {client_axis!r}")
    n_clients = data["num_samples"].shape[0]
    batches = {k: v for k, v in data.items() if k != "num_samples"}
    if client_axis == "scan":
        outs = [local_train(params, {k: v[i] for k, v in batches.items()})
                for i in range(n_clients)]
        new_params = tree_stack([o[0] for o in outs])
        metrics = tree_stack([o[1] for o in outs])
    else:
        new_params, metrics = vmap(local_train, in_dims=(None, 0))(
            params, batches)
    if transform_update is not None:
        device = data["num_samples"].device
        rows = [transform_update({k: v[i] for k, v in new_params.items()},
                                 params, client_generator(seed_words, i,
                                                          device))
                for i in range(n_clients)]
        new_params = tree_stack(rows)
    return new_params, metrics


def _call_aggregate(aggregate, stacked, weights, global_params, seed_words):
    """Aggregates take (stacked, weights); fused ones that also need the
    round context (clip relative to the global, noise keyed by the round)
    set ``needs_global``."""
    if getattr(aggregate, "needs_global", False):
        return aggregate(stacked, weights, global_params, seed_words)
    return aggregate(stacked, weights)


def make_cohort_step(local_train, aggregate=tree_weighted_mean,
                     transform_update=None, client_axis: str = "vmap"
                     ) -> Callable:
    """Build ``step(global_params, cohort_data, seed_words) -> (new_global,
    metrics)``: train the cohort, apply the per-client hook, aggregate."""

    def step(global_params: Tree, cohort_data: CohortData,
             seed_words: Sequence[int] = (0, 0)):
        stacked, metrics = train_cohort(
            local_train, global_params, cohort_data, seed_words,
            transform_update=transform_update, client_axis=client_axis)
        new_global = _call_aggregate(aggregate, stacked,
                                     cohort_data["num_samples"],
                                     global_params, seed_words)
        return new_global, metrics

    return step


def pad_clients(data: CohortData, n: int) -> CohortData:
    """Zero-pad the leading client axis to a multiple of ``n``; padded rows
    carry mask 0 and weight 0."""
    C = next(iter(data.values())).shape[0]
    if C % n == 0:
        return data
    pad = n - C % n
    return {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            for k, v in data.items()}


def cohort_eval(evaluate):
    """Evaluate one (global) model over a stacked cohort of datasets;
    returns the summed metric dict."""

    def _eval_cohort(params: Tree, data: CohortData) -> Dict[str, torch.Tensor]:
        return evaluate(params, {k: v for k, v in data.items()
                                 if k != "num_samples"})

    return _eval_cohort
