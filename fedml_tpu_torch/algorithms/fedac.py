"""FedAC — federated accelerated SGD (Yuan & Ma 2020), port of
``fedml_tpu/algorithms/fedac.py``.  The server state is a coupled pair
(x, x^ag); every client runs K local steps of

    x^md = (1/β)·x + (1 − 1/β)·x^ag
    g    = ∇F_i(x^md)
    x^ag ← x^md − η·g
    x    ← (1 − 1/α)·x + (1/α)·x^md − γ·g

and the server sample-weight-averages both sequences.  ``(α=1, β=1, γ=η)``
collapses both onto plain local SGD (FedAvg).  FedAC-I's coupling, for
``fedac_mu > 0``: ``γ = max(sqrt(η/(μK)), η), α = 1/(γμ), β = α + 1``.
The reported model is x^ag (the params); x rides the checkpoint.  The
round runs through FedAvg's host loop; ``mesh=`` shards it over the
``clients`` axis (`parallel.cohort.make_sharded_stateful_round`: the
sample total and both weighted sums are summed over the ranks; x is
replicated server state).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
import zlib

import numpy as np
import torch
from torch.func import grad, vmap

from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                               batch_leaves, bcast)
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.parallel.cohort import (cohort_rngs,
                                             make_sharded_stateful_round,
                                             psum_fn)
from fedml_tpu_torch.server_opt import ServerOptMismatchError
from fedml_tpu_torch.trainer.local_sgd import (clip_by_global_norm,
                                               step_grad, with_rng_inputs)
from fedml_tpu_torch.trainer.workload import Workload


@dataclasses.dataclass
class FedACConfig(FedAvgConfig):
    fedac_mu: float = 0.0     # >0: derive (gamma, alpha, beta) (FedAC-I)
    fedac_gamma: float = 0.0  # explicit knobs (0 -> gamma = lr)
    fedac_alpha: float = 1.0
    fedac_beta: float = 1.0


def fedac_coupling(lr: float, mu: float, k_steps: int):
    """FedAC-I's hyperparameter coupling (Yuan & Ma 2020, Lemma 1)."""
    gamma = max(math.sqrt(lr / (mu * max(k_steps, 1))), lr)
    alpha = 1.0 / (gamma * mu)
    beta = alpha + 1.0
    return gamma, alpha, beta


def make_fedac_local(workload: Workload, lr: float, epochs: int,
                     gamma: float, alpha: float, beta: float):
    """``train(x, x_ag, data, rng=None) -> (x', x_ag')``: K coupled local
    steps; fully padded batches freeze both sequences.  A dropout
    workload's trainer is keyed from the client's slot key, as the JAX
    package's chain."""
    clip = workload.grad_clip_norm
    grad_fn = grad(lambda p, b, *rng: workload.loss_fn(p, b, *rng)[0])

    def train(x: Tree, x_ag: Tree, data, rng=None):
        num_steps = data["mask"].shape[0]
        for step in range(epochs * num_steps):
            batch = {n: v[step % num_steps] for n, v in data.items()}
            x_md = {n: x[n] / beta + (1.0 - 1.0 / beta) * x_ag[n]
                    for n in tree_keys(x)}
            grads = step_grad(grad_fn, x_md, batch, rng, step)
            if clip is not None:
                grads = clip_by_global_norm(grads, clip)
            live = torch.sum(batch["mask"]) > 0
            new_ag = {n: x_md[n] - lr * grads[n] for n in x_md}
            new_x = {n: (1.0 - 1.0 / alpha) * x[n] + x_md[n] / alpha
                     - gamma * grads[n] for n in x_md}
            x_ag = {n: torch.where(live, new_ag[n], x_ag[n]) for n in x_md}
            x = {n: torch.where(live, new_x[n], x[n]) for n in x_md}
        return x, x_ag

    return with_rng_inputs(train, workload, epochs)


class FedAC(FedAvg):
    def __init__(self, workload, data, config: FedACConfig, sink=None,
                 device=None, mesh=None):
        if config.client_optimizer != "sgd":
            raise ValueError(
                "fedac's local update IS the accelerated rule (Yuan&Ma'20 "
                "Alg. 1); --client_optimizer sgd only")
        if workload.stateful:
            raise ValueError(
                "fedac does not support stateful (BatchNorm) workloads: "
                "the coupled sequences over running statistics are "
                "undefined — use a GroupNorm model (e.g. resnet18_gn)")
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        steps = int(self.data.train["x"].shape[1])  # batches per epoch
        if cfg.fedac_mu > 0.0:
            gamma, alpha, beta = fedac_coupling(cfg.lr, cfg.fedac_mu,
                                                cfg.epochs * steps)
        else:
            gamma = cfg.fedac_gamma or cfg.lr
            alpha, beta = cfg.fedac_alpha, cfg.fedac_beta
        if alpha < 1.0 or beta < 1.0:
            hint = ""
            if cfg.fedac_mu > 0.0:
                hint = (f" — derived from --fedac_mu {cfg.fedac_mu}: the "
                        f"coupling needs mu <= 1/lr (= {1.0 / cfg.lr:g}); "
                        "lower --fedac_mu or raise --lr")
            raise ValueError(f"fedac needs alpha >= 1 and beta >= 1 "
                             f"(got alpha={alpha:g}, beta={beta:g}){hint}")
        self.coupling = {"gamma": gamma, "alpha": alpha, "beta": beta}
        self._opt_tag = np.asarray(zlib.crc32(
            f"fedac:{gamma!r}:{alpha!r}:{beta!r}:{cfg.lr!r}".encode()),
            np.int64)
        self._x_state = None   # the coupled x sequence (params == x^ag)
        local = make_fedac_local(workload, cfg.lr, cfg.epochs, gamma,
                                 alpha, beta)

        def core(x_ag, cohort, x, seed_words=(0, 0), psum_axis=None,
                 index_offset=0):
            allsum = psum_fn(psum_axis)
            rngs = cohort_rngs(local, cohort, seed_words, index_offset)
            extra = () if rngs is None else (rngs,)
            xs, ags = vmap(local, in_dims=(None, None, 0) + (0,) * len(extra))(
                x, x_ag, batch_leaves(cohort), *extra)
            w = cohort["num_samples"].to(torch.float32)
            ratio = w / torch.clamp_min(allsum(torch.sum(w)), 1.0)
            sums = allsum({
                **{"ag/" + k: torch.sum(s * bcast(ratio, s.dim()), 0)
                   for k, s in ags.items()},
                **{"x/" + k: torch.sum(s * bcast(ratio, s.dim()), 0)
                   for k, s in xs.items()}})
            return ({k: sums["ag/" + k] for k in ags},
                    {k: sums["x/" + k] for k in xs})

        self._round_step = core if mesh is None else \
            make_sharded_stateful_round(
                core, mesh, in_specs=(None, "clients", None),
                out_specs=(None, None))
        self.cohort_step = self._coupled_step

    def run(self, params=None, checkpointer=None):
        self._x_state = None   # x^0 = x^ag,0
        return super().run(params=params, checkpointer=checkpointer)

    def _coupled_step(self, params, cohort, seed_words=(0, 0)):
        if self._x_state is None:
            self._x_state = {k: v.clone() for k, v in params.items()}
        new_ag, self._x_state = self._round_step(params, cohort,
                                                 self._x_state, seed_words)
        return new_ag, {}

    def _extra_state(self):
        return {"x_state": self._x_state, "opt_tag": self._opt_tag}

    def _extra_state_template(self, params):
        return {"x_state": {k: torch.zeros_like(v)
                            for k, v in params.items()},
                "opt_tag": np.asarray(0, np.int64)}

    def _load_extra_state(self, extra) -> None:
        tag = extra.get("opt_tag")
        if tag is None:
            warnings.warn(
                "fedac: restoring a pre-tag x-sequence snapshot (no "
                "opt_tag recorded) — cannot verify it matches this run's "
                "(gamma, alpha, beta, lr) coupling", stacklevel=2)
        elif int(tag) != int(self._opt_tag):
            raise ServerOptMismatchError(
                f"fedac: snapshot's coupling tag {int(tag)} != this run's "
                f"{int(self._opt_tag)} (gamma={self.coupling['gamma']:g}, "
                f"alpha={self.coupling['alpha']:g}, "
                f"beta={self.coupling['beta']:g}, lr={self.cfg.lr:g}); the "
                f"x sequence is only meaningful under the coupling that "
                f"produced it — rerun with the snapshot's --fedac_* / --lr "
                f"flags or start fresh")
        self._x_state = extra["x_state"]
