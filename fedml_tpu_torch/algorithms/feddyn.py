"""FedDyn (Acar et al. 2021) — dynamic regularization, so the federated
fixed point is the centralized optimum under client drift (port of
``fedml_tpu/algorithms/feddyn.py``).  Algorithm 1 of the paper:

    local:   g = ∇L_k(θ) − λ_k + α(θ − θ^t)   (the clip after it)
    state:   λ_k ← λ_k − α(θ_k − θ^t)          (sampled clients only)
    server:  h ← h − (α/N)·Σ_{k∈S}(θ_k − θ^t)
             θ^{t+1} = mean_{k∈S}(θ_k) − h/α    (uniform mean)

The λ_k live on the host, stacked ``[client_num_in_total, ...]`` (the
SCAFFOLD pattern), so the round runs through FedAvg's host loop.
``mesh=`` shards it over the ``clients`` axis (`parallel.cohort.
make_sharded_stateful_round`): the live count and the live sums are
summed over the ranks and the updated λ rows come back gathered.
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
class FedDynConfig(FedAvgConfig):
    feddyn_alpha: float = 0.01


def make_feddyn_local(workload: Workload, lr: float, epochs: int,
                      alpha: float):
    """``train(theta_ref, lam, data, rng=None) -> theta``: SGD on the
    dynamically regularized objective from the round's global; fully
    padded batches freeze the carry.  A dropout workload's trainer is
    keyed from the client's slot key, as the JAX package's chain."""
    clip = workload.grad_clip_norm
    grad_fn = grad(lambda p, b, *rng: workload.loss_fn(p, b, *rng)[0])

    def train(theta_ref: Tree, lam: Tree, data, rng=None):
        num_steps = data["mask"].shape[0]
        theta = theta_ref
        for step in range(epochs * num_steps):
            batch = {n: v[step % num_steps] for n, v in data.items()}
            grads = step_grad(grad_fn, theta, batch, rng, step)
            grads = {n: grads[n] - lam[n] + alpha * (theta[n] - theta_ref[n])
                     for n in grads}
            if clip is not None:
                grads = clip_by_global_norm(grads, clip)
            gd = (torch.sum(batch["mask"]) > 0).to(torch.float32)
            theta = {n: theta[n] - lr * gd * grads[n]
                     for n in tree_keys(theta)}
        return theta

    return with_rng_inputs(train, workload, epochs)


class FedDyn(FedAvg):
    def __init__(self, workload, data, config: FedDynConfig, sink=None,
                 device=None, mesh=None):
        if config.client_optimizer != "sgd":
            raise ValueError(
                "feddyn's local solver is SGD on the dynamically "
                "regularized objective (Acar'21 Alg. 1); "
                "--client_optimizer sgd only")
        if config.feddyn_alpha <= 0.0:
            raise ValueError("feddyn_alpha must be > 0 (the server step "
                             "divides by it)")
        if workload.stateful:
            raise ValueError(
                "feddyn does not support stateful (BatchNorm) workloads: "
                "the λ correction over running statistics is undefined — "
                "use a GroupNorm model (e.g. resnet18_gn)")
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        alpha = cfg.feddyn_alpha
        n_total = data.client_num
        self._round_counter = 0
        self.h_state = None
        self.lam_locals = None
        local = make_feddyn_local(workload, cfg.lr, cfg.epochs, alpha)

        def core(params, cohort, h, lam_cohort, seed_words=(0, 0),
                 psum_axis=None, index_offset=0):
            allsum = psum_fn(psum_axis)
            rngs = cohort_rngs(local, cohort, seed_words, index_offset)
            extra = () if rngs is None else (rngs,)
            thetas = vmap(local, in_dims=(None, 0, 0) + (0,) * len(extra))(
                params, lam_cohort, batch_leaves(cohort), *extra)
            live = (cohort["num_samples"] > 0).to(torch.float32)
            m_live = torch.clamp_min(allsum(torch.sum(live)), 1.0)
            sums = allsum({
                **{"d/" + k: torch.sum((thetas[k] - x[None])
                                       * bcast(live, thetas[k].dim()), 0)
                   for k, x in params.items()},
                **{"t/" + k: torch.sum(thetas[k]
                                       * bcast(live, thetas[k].dim()), 0)
                   for k in params}})
            new_lam = {k: torch.where(
                           bcast(live, thetas[k].dim()) > 0,
                           lam_cohort[k] - alpha * (thetas[k] - x[None]),
                           lam_cohort[k])
                       for k, x in params.items()}
            new_h = {k: h[k] - alpha * (m_live / n_total)
                     * (sums["d/" + k] / m_live) for k in params}
            new_params = {k: sums["t/" + k] / m_live - new_h[k] / alpha
                          for k in params}
            return new_params, new_lam, new_h

        self._round_step = core if mesh is None else \
            make_sharded_stateful_round(
                core, mesh, in_specs=(None, "clients", None, "clients"),
                out_specs=(None, "clients", None))
        self.cohort_step = self._stateful_step

    def run(self, params=None, checkpointer=None):
        self._round_counter = 0
        self.h_state = None
        self.lam_locals = None
        return super().run(params=params, checkpointer=checkpointer)

    def _stateful_step(self, params, cohort, seed_words=(0, 0)):
        if self.h_state is None:
            self.h_state = {k: torch.zeros_like(v)
                            for k, v in params.items()}
            self.lam_locals = zeros_client_state(params,
                                                 self.data.client_num)
        ids = self._sample_round(self._round_counter)
        self._round_counter += 1
        lam_cohort = gather_client_rows(self.lam_locals, ids,
                                        cohort_rows(cohort),
                                        self._state_device())
        params, new_lam, self.h_state = self._round_step(
            params, cohort, self.h_state, lam_cohort, seed_words)
        self.lam_locals = scatter_client_rows(self.lam_locals, ids, new_lam)
        return params, {}

    def _extra_state(self):
        return {"h_state": self.h_state, "lam_locals": self.lam_locals,
                "round_counter": self._round_counter}

    def _extra_state_template(self, params):
        return {"h_state": {k: torch.zeros_like(v)
                            for k, v in params.items()},
                "lam_locals": zeros_client_state(params,
                                                 self.data.client_num),
                "round_counter": 0}

    def _load_extra_state(self, extra) -> None:
        self.h_state = extra["h_state"]
        self.lam_locals = {k: np.asarray(v)
                           for k, v in extra["lam_locals"].items()}
        self._round_counter = int(extra["round_counter"])
