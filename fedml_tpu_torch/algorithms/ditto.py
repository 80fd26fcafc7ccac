"""Ditto (Li et al. 2021) — personalized FL (port of
``fedml_tpu/algorithms/ditto.py``).  The global stream is exactly FedAvg
(the base cohort step, unchanged); beside it every client keeps a personal
model ``v_i`` trained on its own data with a proximal pull toward the
round's global:

    v_i ← v_i − η_p·(∇F_i(v_i) + λ(v_i − w^t))    (personal_epochs epochs)

Every ``v_i`` starts at ``w^0``.  The personal models live on the host,
stacked ``[client_num_in_total, ...]``, so the round runs through FedAvg's
host loop.  ``evaluate_global`` adds each client's own model on its own
shard (``personal_*`` columns) to the global metrics.  A dropout
model's personal pass draws its step keys as the JAX package's does:
client ``i`` of the round takes ``fold_in(fold_in(round_key, "DITT"),
slot)`` and the trainer's chain splits it once a step (the global
stream keeps FedAvg's keys).  ``mesh=``: the
global stream is FedAvg's sharded cohort step and the personal pass a
per-rank pass over the rank's rows (`parallel.cohort.
make_sharded_stateful_round`; no sums across clients), its rows gathered
back so every rank mirrors every ``v_i``; the personal evaluation runs on
each rank over all clients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.func import grad, vmap

from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                               batch_leaves, bcast,
                                               gather_client_rows,
                                               round_key_of,
                                               scatter_client_rows,
                                               sweep_eval_chunks,
                                               zeros_client_state)
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.parallel.cohort import (cohort_rngs, cohort_rows,
                                             make_sharded_stateful_round,
                                             pad_clients)
from fedml_tpu_torch.trainer.local_sgd import (clip_by_global_norm,
                                               step_grad, with_rng_inputs)
from fedml_tpu_torch.trainer.workload import Workload
from fedml_tpu_torch.utils.metrics import stats_from_metrics


# the personal pass's fold_in stream (ASCII "DITT"), the JAX package's
_PERSONAL_STREAM = 0x44495454


@dataclasses.dataclass
class DittoConfig(FedAvgConfig):
    ditto_lambda: float = 0.1
    personal_lr: float = 0.0       # 0 -> the global lr
    personal_epochs: int = 0       # 0 -> the global epochs


def make_ditto_local(workload: Workload, lr: float, epochs: int,
                     lam: float):
    """``train(v, w_ref, data, rng=None) -> v'``: SGD on ``∇F_i(v) +
    λ(v − w_ref)``, the clip after the coupling; fully padded batches
    freeze the carry.  A dropout workload's trainer is keyed (``rng``
    ``[epochs * S, 2]``, `trainer.local_sgd.with_rng_inputs`)."""
    clip = workload.grad_clip_norm
    grad_fn = grad(lambda p, b, *rng: workload.loss_fn(p, b, *rng)[0])

    def train(v: Tree, w_ref: Tree, data, rng=None):
        num_steps = data["mask"].shape[0]
        for step in range(epochs * num_steps):
            batch = {n: x[step % num_steps] for n, x in data.items()}
            grads = step_grad(grad_fn, v, batch, rng, step)
            grads = {n: grads[n] + lam * (v[n] - w_ref[n]) for n in grads}
            if clip is not None:
                grads = clip_by_global_norm(grads, clip)
            gd = (torch.sum(batch["mask"]) > 0).to(torch.float32)
            v = {n: v[n] - lr * gd * grads[n] for n in tree_keys(v)}
        return v

    return with_rng_inputs(train, workload, epochs)


class Ditto(FedAvg):
    def __init__(self, workload, data, config: DittoConfig, sink=None,
                 device=None, mesh=None):
        if workload.stateful:
            raise ValueError(
                "ditto does not support stateful (BatchNorm) workloads: "
                "the proximal pull over running statistics is undefined — "
                "use a GroupNorm model (e.g. resnet18_gn)")
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        self._round_counter = 0
        self.v_locals = None
        personal = make_ditto_local(workload, cfg.personal_lr or cfg.lr,
                                    cfg.personal_epochs or cfg.epochs,
                                    cfg.ditto_lambda)

        def personal_core(w_ref, cohort, v_cohort, p_words=(0, 0),
                          psum_axis=None, index_offset=0):
            del psum_axis                   # per client: no sums
            rngs = cohort_rngs(personal, cohort, p_words, index_offset)
            extra = () if rngs is None else (rngs,)
            new_v = vmap(personal, in_dims=(0, None, 0) + (0,) * len(extra))(
                v_cohort, w_ref, batch_leaves(cohort), *extra)
            live = (cohort["num_samples"] > 0).to(torch.float32)
            return {k: torch.where(bcast(live, v.dim()) > 0, new_v[k], v)
                    for k, v in v_cohort.items()}

        self._personal_round = personal_core if mesh is None else \
            make_sharded_stateful_round(
                personal_core, mesh, in_specs=(None, "clients", "clients"),
                out_specs="clients")
        evaluate = self.evaluate
        self._personal_eval = lambda vs, part: {
            k: torch.sum(m, 0) for k, m in vmap(evaluate, in_dims=(0, 0))(
                vs, part).items()}
        self.cohort_step = self._ditto_step

    def run(self, params=None, checkpointer=None):
        self._round_counter = 0
        self.v_locals = None
        return super().run(params=params, checkpointer=checkpointer)

    def _ditto_step(self, params, cohort, seed_words=(0, 0)):
        if self.v_locals is None:
            # the paper's init v_i = w^0, as host buffers
            self.v_locals = {
                k: np.broadcast_to(v.detach().cpu().numpy()[None],
                                   (self.data.client_num,) + tuple(v.shape)
                                   ).copy()
                for k, v in params.items()}
        # the global stream: exactly FedAvg
        new_params, aux = self._base_cohort_step(params, cohort, seed_words)
        ids = self._sample_round(self._round_counter)
        self._round_counter += 1
        v_cohort = gather_client_rows(self.v_locals, ids,
                                      cohort_rows(cohort),
                                      self._state_device())
        p_key = prng.fold_in(round_key_of(seed_words), _PERSONAL_STREAM)
        new_v = self._personal_round(params, cohort, v_cohort, p_key)
        self.v_locals = scatter_client_rows(self.v_locals, ids, new_v)
        return new_params, aux

    def evaluate_personalized(self) -> Dict[str, float]:
        """Sample-weighted metrics of each client's personal model on its
        own train/test shard, swept in ``eval_chunk_clients`` chunks."""
        if self.v_locals is None:
            return {}
        out: Dict[str, float] = {}
        for split, stacked in (("train", self.data.train),
                               ("test", self.data.test)):
            if stacked is None:
                continue
            n_clients = stacked["num_samples"].shape[0]
            chunk = min(self.cfg.eval_chunk_clients or n_clients, n_clients)

            def run_chunk(part, lo):
                v_chunk = pad_clients(
                    {k: torch.from_numpy(np.ascontiguousarray(
                        v[lo:lo + chunk])).to(self.device)
                     for k, v in self.v_locals.items()}, chunk)
                return self._personal_eval(
                    v_chunk, {k: part[k] for k in ("x", "y", "mask")})

            total = sweep_eval_chunks(stacked, chunk, run_chunk, self.device)
            out.update(stats_from_metrics(total,
                                          prefix=f"personal_{split}_"))
        return out

    def evaluate_global(self, params) -> Dict[str, float]:
        out = super().evaluate_global(params)
        out.update(self.evaluate_personalized())
        return out

    def _extra_state(self):
        return {"v_locals": self.v_locals,
                "round_counter": self._round_counter}

    def _extra_state_template(self, params):
        return {"v_locals": zeros_client_state(params,
                                               self.data.client_num),
                "round_counter": 0}

    def _load_extra_state(self, extra) -> None:
        self.v_locals = {k: np.asarray(v)
                         for k, v in extra["v_locals"].items()}
        self._round_counter = int(extra["round_counter"])
