"""FedNova (Wang et al. 2020) — normalized averaging of heterogeneous local
updates (port of ``fedml_tpu/algorithms/fednova.py``).

* The client optimizer: SGD with weight decay, heavy-ball momentum
  (optionally nesterov), FedProx's mu term, the accumulated update
  ``cum_grad += lr·d_p`` and the normalizing scalar ``a_i``, whose update
  depends on momentum and mu as in the reference.
* Aggregation: ``tau_eff = Σ_i p_i·a_i`` (or ``p_i·steps_i`` when mu ≠ 0);
  each client contributes ``p_i·cum_grad_i / a_i``; the server applies
  ``w ← w − tau_eff·Σ_i contribution``, with the optional server momentum
  gmf (``buf ← gmf·buf + cum/lr;  w ← w − lr·buf``).

Two paths, as in the JAX package: the host loop (``_stateful_step``
replaces the cohort step) and a device-round override over the resident
split.  On a CUDA device the override is one captured CUDA graph; the
momentum buffer ``gmf_buf`` lives in persistent tensors the graph updates
in place, read and written only between replays.  ``mesh=`` shards the
host loop's cohort over the ``clients`` axis (`parallel.cohort.
make_sharded_stateful_round`): the sample total, ``tau_eff`` and the
normalised parts are summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.func import grad

from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig, bcast
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.parallel.cohort import (gather_live_cohort,
                                             make_device_round,
                                             make_sharded_stateful_round,
                                             psum_fn, train_cohort)
from fedml_tpu_torch.trainer.local_sgd import step_grad, with_rng_inputs


@dataclasses.dataclass
class FedNovaConfig(FedAvgConfig):
    momentum: float = 0.0
    nesterov: bool = False
    mu: float = 0.0          # FedProx term inside the Nova optimizer
    gmf: float = 0.0         # global (server) momentum factor


def make_fednova_local_trainer(workload, cfg: FedNovaConfig):
    """``train(params, data, rng=None) -> (new_params, aux)``, aux holding
    ``cum_grad``, ``a_i`` and ``local_steps``.  Fully padded batches
    freeze every carry.  ``rng``: the step keys of a keyed trainer
    (`with_rng_inputs`)."""
    lr, m, mu = cfg.lr, cfg.momentum, cfg.mu
    nesterov, wd = cfg.nesterov, cfg.wd
    grad_fn = grad(lambda p, b, *r: workload.loss_fn(p, b, *r)[0])

    def train(params: Tree, data: Dict[str, torch.Tensor], rng=None):
        init_params = params
        keys = tree_keys(params)
        zero = data["mask"].new_zeros(())
        buf = {k: torch.zeros_like(params[k]) for k in keys}
        cum_grad = {k: torch.zeros_like(params[k]) for k in keys}
        counter, a_i = zero, zero
        num_steps = data["mask"].shape[0]
        for step in range(cfg.epochs * num_steps):
            batch = {k: v[step % num_steps] for k, v in data.items()}
            grads = step_grad(grad_fn, params, batch, rng, step)
            got_data = torch.sum(batch["mask"]) > 0
            if wd:
                grads = {k: grads[k] + wd * params[k] for k in keys}
            if m:
                buf = {k: torch.where(got_data, m * buf[k] + grads[k],
                                      buf[k]) for k in keys}
                d_p = ({k: grads[k] + m * buf[k] for k in keys}
                       if nesterov else buf)
            else:
                d_p = grads
            if mu:
                d_p = {k: d_p[k] + mu * (params[k] - init_params[k])
                       for k in keys}
            gd = got_data.to(torch.float32)
            cum_grad = {k: cum_grad[k] + lr * d_p[k] * gd for k in keys}
            params = {k: params[k] - lr * d_p[k] * gd for k in keys}
            if m:
                counter = torch.where(got_data, counter * m + 1.0, counter)
                a_i = torch.where(got_data, a_i + counter, a_i)
            etamu = lr * mu
            if etamu:
                a_i = torch.where(got_data, a_i * (1 - etamu) + 1.0, a_i)
            if not m and not etamu:
                a_i = torch.where(got_data, a_i + 1.0, a_i)
        lead = tuple(range(1, data["mask"].dim()))
        steps_taken = torch.sum(
            (torch.sum(data["mask"], dim=lead) > 0).to(torch.float32)
        ) * cfg.epochs
        return params, {"cum_grad": cum_grad, "a_i": a_i,
                        "local_steps": steps_taken}

    return with_rng_inputs(train, workload, cfg.epochs)


class FedNova(FedAvg):
    def __init__(self, workload, data, config: FedNovaConfig, sink=None,
                 device=None, mesh=None):
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        if cfg.client_axis != "vmap":
            raise ValueError("client_axis is not wired into FedNova's "
                             "custom round; drop --client_axis")
        local_train = make_fednova_local_trainer(workload, cfg)
        self._gmf_buf = None

        def nova_core(global_params: Tree, cohort, gmf_buf,
                      seed_words=(0, 0), psum_axis=None, index_offset=0):
            allsum = psum_fn(psum_axis)
            n = cohort["num_samples"].to(torch.float32)
            _, aux = train_cohort(local_train, global_params, cohort,
                                  seed_words, index_offset=index_offset)
            ratio = n / torch.clamp_min(allsum(torch.sum(n)), 1.0)
            a = torch.clamp_min(aux["a_i"], 1e-12)
            tau_src = aux["local_steps"] if cfg.mu != 0 else aux["a_i"]
            sums = allsum({"tau_eff": torch.sum(ratio * tau_src), **{
                "part/" + k: torch.sum(cg * bcast(ratio / a, cg.dim()), dim=0)
                for k, cg in aux["cum_grad"].items()}})
            cum = {k: sums["tau_eff"] * sums["part/" + k]
                   for k in aux["cum_grad"]}
            if cfg.gmf:
                gmf_buf = {k: cfg.gmf * gmf_buf[k] + cum[k] / cfg.lr
                           for k in cum}
                new = {k: global_params[k] - cfg.lr * gmf_buf[k]
                       for k in cum}
            else:
                new = {k: global_params[k] - cum[k] for k in cum}
            return new, gmf_buf

        self._nova_core = nova_core if mesh is None else \
            make_sharded_stateful_round(
                nova_core, mesh, in_specs=(None, "clients", None, None),
                out_specs=(None, None))
        self.cohort_step = self._stateful_step

        def device_body(params, stacked, ids, live, seed_words=(0, 0)):
            cohort = gather_live_cohort(stacked, ids, live)
            new, buf = nova_core(params, cohort, self._gmf_buf, seed_words)
            for k, v in buf.items():
                self._gmf_buf[k].copy_(v)
            return new, {}

        self._device_state: Dict[str, torch.Tensor] = {}
        self._device_round_override = make_device_round(
            None, cfg.client_num_per_round, body=device_body,
            state=self._device_state,
            keyed=local_train.rng_inputs is not None)

    def run_round(self, params: Tree, round_idx: int, words,
                  use_device_data: bool) -> Tree:
        # the buffer must exist before the device round's first call: a
        # captured graph reads and writes those tensors
        self._ensure_buf(params)
        return super().run_round(params, round_idx, words, use_device_data)

    def _ensure_buf(self, params: Tree) -> None:
        if self._gmf_buf is None:
            self._gmf_buf = {k: torch.zeros_like(v)
                             for k, v in params.items()}
        # the graph's persistent state: the same tensors, by name
        self._device_state.update(self._gmf_buf)

    def _stateful_step(self, params: Tree, cohort, seed_words=(0, 0)):
        self._ensure_buf(params)
        params, buf = self._nova_core(params, cohort, self._gmf_buf,
                                      seed_words)
        for k, v in buf.items():
            self._gmf_buf[k].copy_(v)
        return params, {}

    # the server momentum buffer rides the round checkpoint
    def _extra_state(self):
        return {"gmf_buf": self._gmf_buf}

    def _extra_state_template(self, params):
        return {"gmf_buf": {k: torch.zeros_like(v)
                            for k, v in params.items()}}

    def _load_extra_state(self, extra) -> None:
        self._ensure_buf(extra["gmf_buf"])
        for k, v in extra["gmf_buf"].items():   # in place: the graph reads
            self._gmf_buf[k].copy_(v)           # these tensors

