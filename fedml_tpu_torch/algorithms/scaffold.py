"""SCAFFOLD (Karimireddy et al. 2020) — control-variate FL that corrects
client drift (port of ``fedml_tpu/algorithms/scaffold.py``).  Option II of
the paper:

    local step:   y ← y − lr·(∇f_i(y) + c − c_i)
    c_i⁺        = c_i − c + (x − y_i)/(K·lr)
    x⁺          = x + Σ_i r_i (y_i − x)          (sample-weighted)
    c⁺          = c + (|S|/N)·mean_{i∈S}(c_i⁺ − c_i)

The control variates ``c_i`` live on the host, stacked ``[client_num_in_
total, ...]``; each round gathers the cohort's rows to the device and
scatters the updated rows back, so the round runs through FedAvg's host
loop (``cohort_step`` is replaced).  The round's client ids are re-derived
from the seeded sampling chain by an internal round counter.

``mesh=`` shards the cohort's rows over the mesh's ``clients`` axis
through `parallel.cohort.make_sharded_stateful_round`: each rank trains its
block (keys of the global slots), the weighted sums and counts are summed
over the ranks, and the updated variates come back gathered, so every rank
scatters the same rows into its own host mirror.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch
from torch.func import grad, vmap

from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                               batch_leaves, bcast,
                                               gather_client_rows,
                                               scatter_client_rows,
                                               zeros_client_state)
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.parallel.cohort import (cohort_rngs, cohort_rows,
                                             make_sharded_stateful_round,
                                             psum_fn)
from fedml_tpu_torch.trainer.local_sgd import (clip_by_global_norm,
                                               step_grad, with_rng_inputs)
from fedml_tpu_torch.trainer.workload import Workload


@dataclasses.dataclass
class ScaffoldConfig(FedAvgConfig):
    pass


def make_scaffold_local(workload: Workload, lr: float, epochs: int):
    """``train(params, data, c_diff, rng=None) -> (y_i, steps_taken)``:
    plain SGD with ``c_diff = c − c_i`` added to every gradient, the
    workload's clip after the correction; fully padded batches freeze the
    carry and do not count toward K.  ``rng``: the step keys of a keyed
    trainer (`with_rng_inputs`)."""
    clip = workload.grad_clip_norm
    grad_fn = grad(lambda p, b, *r: workload.loss_fn(p, b, *r)[0])

    def train(params: Tree, data, c_diff: Tree, rng=None):
        num_steps = data["mask"].shape[0]
        y, k = params, data["mask"].new_zeros(())
        for step in range(epochs * num_steps):
            batch = {n: v[step % num_steps] for n, v in data.items()}
            grads = step_grad(grad_fn, y, batch, rng, step)
            grads = {n: grads[n] + c_diff[n] for n in grads}
            if clip is not None:
                grads = clip_by_global_norm(grads, clip)
            gd = (torch.sum(batch["mask"]) > 0).to(torch.float32)
            y = {n: y[n] - lr * gd * grads[n] for n in tree_keys(y)}
            k = k + gd
        return y, k

    return with_rng_inputs(train, workload, epochs)


class Scaffold(FedAvg):
    def __init__(self, workload, data, config: ScaffoldConfig, sink=None,
                 device=None, mesh=None):
        if config.client_optimizer != "sgd":
            raise ValueError(
                "scaffold's local update is plain SGD with control-variate "
                "correction (Karimireddy'20); --client_optimizer sgd only — "
                "other optimizers would be silently ignored")
        if workload.stateful:
            raise ValueError(
                "scaffold does not support stateful (BatchNorm) workloads: "
                "control variates over running statistics are undefined — "
                "use a GroupNorm model (e.g. resnet18_gn)")
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        self._round_counter = 0
        self.c_global = None
        self.c_locals = None   # stacked [client_num_in_total, ...] host
        local = make_scaffold_local(workload, cfg.lr, cfg.epochs)
        n_total = data.client_num

        def core(params, cohort, c_global, c_cohort, seed_words=(0, 0),
                 psum_axis=None, index_offset=0):
            """One SCAFFOLD round over the cohort, or over a rank's block
            of it with ``psum_axis`` the sum over the ranks."""
            allsum = psum_fn(psum_axis)
            c_diffs = {k: c_global[k][None] - c_cohort[k] for k in c_global}
            rngs = cohort_rngs(local, cohort, seed_words, index_offset)
            extra = () if rngs is None else (rngs,)
            ys, ks = vmap(local, in_dims=(None, 0, 0) + (0,) * len(extra))(
                params, batch_leaves(cohort), c_diffs, *extra)
            w = cohort["num_samples"].to(torch.float32)
            live = (w > 0).to(torch.float32)
            tot = allsum({"w": torch.sum(w), "live": torch.sum(live)})
            ratio = w / torch.clamp_min(tot["w"], 1.0)
            k_safe = torch.clamp_min(ks, 1.0)
            new_c = {k: torch.where(
                         bcast(live, x.dim() + 1) > 0,
                         c_cohort[k] - c_global[k][None]
                         + (x[None] - ys[k])
                         / (bcast(k_safe, x.dim() + 1) * cfg.lr),
                         c_cohort[k])
                     for k, x in params.items()}
            sums = allsum({
                **{"x/" + k: torch.sum((ys[k] - x[None])
                                       * bcast(ratio, x.dim() + 1), 0)
                   for k, x in params.items()},
                **{"c/" + k: torch.sum((new_c[k] - c_cohort[k])
                                       * bcast(live, new_c[k].dim()), 0)
                   for k in c_global}})
            new_params = {k: x + sums["x/" + k] for k, x in params.items()}
            m = torch.clamp_min(tot["live"], 1.0)
            frac = m / n_total
            new_cg = {k: cg + frac * sums["c/" + k] / m
                      for k, cg in c_global.items()}
            return new_params, new_c, new_cg

        self._round_step = core if mesh is None else \
            make_sharded_stateful_round(
                core, mesh, in_specs=(None, "clients", None, "clients", None),
                out_specs=(None, "clients", None))
        self.cohort_step = self._stateful_step

    def run(self, params=None, checkpointer=None):
        # a fresh run restarts the sampling-chain mirror and the variates;
        # a resume restores both through _load_extra_state
        self._round_counter = 0
        self.c_global = None
        self.c_locals = None
        return super().run(params=params, checkpointer=checkpointer)

    def _stateful_step(self, params, cohort, seed_words=(0, 0)):
        if self.c_global is None:
            self.c_global = {k: torch.zeros_like(v)
                             for k, v in params.items()}
            self.c_locals = zeros_client_state(params, self.data.client_num)
        ids = self._sample_round(self._round_counter)
        self._round_counter += 1
        c_cohort = gather_client_rows(self.c_locals, ids,
                                      cohort_rows(cohort),
                                      self._state_device())
        params, new_c, self.c_global = self._round_step(
            params, cohort, self.c_global, c_cohort, seed_words)
        self.c_locals = scatter_client_rows(self.c_locals, ids, new_c)
        return params, {}

    def _extra_state(self):
        return {"c_global": self.c_global, "c_locals": self.c_locals,
                "round_counter": self._round_counter}

    def _extra_state_template(self, params):
        return {"c_global": {k: torch.zeros_like(v)
                             for k, v in params.items()},
                "c_locals": zeros_client_state(params,
                                               self.data.client_num),
                "round_counter": 0}

    def _load_extra_state(self, extra) -> None:
        self.c_global = extra["c_global"]
        self.c_locals = {k: np.asarray(v) for k, v in
                         extra["c_locals"].items()}
        self._round_counter = int(extra["round_counter"])
