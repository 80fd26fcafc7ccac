"""DP-FedAvg (McMahan et al. 2018) — user-level differential privacy with
an RDP accountant (port of ``fedml_tpu/algorithms/dp_fedavg.py``).

* Each client's update ``Δ_k = θ_k − θ^t`` is clipped to L2 norm
  ``dp_clip`` (S).
* The live cohort slots are averaged uniformly (a sample-weighted mean has
  unbounded per-user sensitivity).
* One Gaussian per leaf with std ``S·z/m`` is added to the averaged
  update, drawn from ``split(fold_in(round key, "DPNZ"), n_leaves)``
  through `core.prng.normal`, the JAX package's ``jax.random.normal``
  stream; the training stream is untouched.
* Cohorts are sampled in secret: without replacement from the run key's
  ``fold_in(key, "DPSG")`` chain (`prng.choice_without_replacement`, JAX's
  ``choice``); full participation keeps the exact arange.
* `core.privacy.RdpAccountant` composes the subsampled Gaussian over the
  rounds (``q = cohort / N``) and every eval row reports ε at
  ``dp_delta``.

The clip, the mean and the noise are plain tensor ops (K1's noise is
another function: murmur and Box–Muller), run in the round's aggregate;
the round goes through FedAvg's host loop, as in the JAX package.  On a
mesh (``mesh=``) each rank clips its own rows, the live count and the
clipped sums are summed over the ranks, and the one central draw comes
from the replicated round key, so every rank adds the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig, bcast,
                                               round_key_of)
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.privacy import RdpAccountant
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.parallel.cohort import (make_cohort_step,
                                             make_sharded_stateful_round,
                                             psum_fn, train_cohort)

# the fold_in streams of the noise draw ("DPNZ") and the secret sampling
# chain ("DPSG")
_NOISE_STREAM = 0x44504E5A
_SAMPLE_STREAM = 0x44505347


@dataclasses.dataclass
class DPFedAvgConfig(FedAvgConfig):
    dp_clip: float = 1.0
    dp_noise_multiplier: float = 1.0
    dp_delta: float = 1e-5
    dp_accounting: str = "fixed_size"   # fixed_size | poisson


def make_dp_aggregate(clip: float, noise_multiplier: float,
                      psum_axis=None):
    """``aggregate(stacked, weights, global_params, seed_words)``: clip
    each client's update, average the live slots uniformly, add one
    Gaussian draw per leaf calibrated to the sensitivity S/m.
    ``psum_axis``: the sum over a mesh axis's ranks for the live count and
    the clipped sums, when the cohort is sharded."""
    allsum = psum_fn(psum_axis)

    def aggregate(stacked: Tree, weights: torch.Tensor, global_params: Tree,
                  seed_words):
        keys = tree_keys(global_params)
        live = (weights > 0).to(torch.float32)
        m = torch.clamp_min(allsum(torch.sum(live)), 1.0)
        deltas = {k: stacked[k] - global_params[k][None] for k in keys}
        sq = sum(torch.sum(torch.square(deltas[k].to(torch.float32)),
                           dim=tuple(range(1, deltas[k].dim())))
                 for k in keys)
        scale = torch.clamp_max(
            clip / torch.clamp_min(torch.sqrt(sq), 1e-12), 1.0) * live
        sums = allsum({k: torch.sum(deltas[k] * bcast(scale, deltas[k].dim())
                                    .to(deltas[k].dtype), 0) for k in keys})
        mean = {k: sums[k] / m.to(deltas[k].dtype) for k in keys}
        nkey = prng.fold_in(round_key_of(seed_words), _NOISE_STREAM)
        leaf_keys = prng.split(nkey, len(keys))
        std = clip * noise_multiplier / m
        device = weights.device
        return {k: global_params[k] + (mean[k] + (std * prng.normal(
                    lk, tuple(mean[k].shape), device)).to(mean[k].dtype))
                for k, lk in zip(keys, leaf_keys)}

    aggregate.needs_global = True
    return aggregate


class DPFedAvg(FedAvg):
    def __init__(self, workload, data, config: DPFedAvgConfig, sink=None,
                 device=None, mesh=None):
        if config.dp_clip <= 0.0:
            raise ValueError("dp_clip must be > 0")
        if config.dp_noise_multiplier < 0.0:
            raise ValueError("dp_noise_multiplier must be >= 0 "
                             "(0 = clipped, non-private FedAvg)")
        if config.dp_accounting not in ("fixed_size", "poisson"):
            raise ValueError(
                f"unknown dp_accounting {config.dp_accounting!r}; use "
                "'fixed_size' (valid for the sampler used) or 'poisson' "
                "(literature approximation)")
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        if mesh is None:
            base_step = make_cohort_step(
                self._local_train,
                aggregate=make_dp_aggregate(cfg.dp_clip,
                                            cfg.dp_noise_multiplier),
                client_axis=cfg.client_axis)
        else:
            local_train = self._local_train

            def core(params, cohort, seed_words=(0, 0), psum_axis=None,
                     index_offset=0):
                stacked, metrics = train_cohort(
                    local_train, params, cohort, seed_words,
                    client_axis=cfg.client_axis, index_offset=index_offset)
                dp_agg = make_dp_aggregate(cfg.dp_clip,
                                           cfg.dp_noise_multiplier,
                                           psum_axis=psum_axis)
                return dp_agg(stacked, cohort["num_samples"], params,
                              seed_words), metrics

            base_step = make_sharded_stateful_round(
                core, mesh, in_specs=(None, "clients", None),
                out_specs=(None, "clients"))
        q = min(cfg.client_num_per_round, data.client_num) / data.client_num
        self.accountant = RdpAccountant(
            q, cfg.dp_noise_multiplier, cfg.dp_delta,
            sampling=("fixed_size_wor" if cfg.dp_accounting == "fixed_size"
                      else "poisson"))
        self._sample_base = prng.fold_in(prng.key(cfg.seed), _SAMPLE_STREAM)

        def counted_step(params, cohort, seed_words=(0, 0)):
            out = base_step(params, cohort, seed_words)
            self.accountant.step()
            return out

        self.cohort_step = counted_step

    def run(self, params=None, checkpointer=None):
        self.accountant.steps = 0
        # the secret sampling chain, from the run key before the loop
        # consumes it (a resume replays the same key -> the same cohorts)
        self._sample_base = prng.fold_in(prng.key(self.cfg.seed),
                                         _SAMPLE_STREAM)
        return super().run(params=params, checkpointer=checkpointer)

    def _sample_round(self, round_idx: int):
        n = self.data.client_num
        m = min(self.cfg.client_num_per_round, n)
        if m >= n:
            return np.arange(n)
        return prng.choice_without_replacement(
            prng.fold_in(self._sample_base, round_idx), n, m)

    def evaluate_global(self, params) -> Dict[str, float]:
        out = super().evaluate_global(params)
        out["dp_epsilon"] = self.accountant.epsilon()
        out["dp_delta"] = self.accountant.delta
        return out

    # the accountant's round count and the secret chain ride the checkpoint
    def _extra_state(self):
        return {"dp_rounds": self.accountant.steps,
                "sample_base": np.asarray(self._sample_base, np.uint32)}

    def _extra_state_template(self, params):
        return {"dp_rounds": 0,
                "sample_base": np.zeros(2, np.uint32)}

    def _load_extra_state(self, extra) -> None:
        self.accountant.steps = int(extra["dp_rounds"])
        if "sample_base" in extra:
            self._sample_base = tuple(int(w) for w in extra["sample_base"])
