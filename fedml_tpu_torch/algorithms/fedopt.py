"""FedOpt — server-side adaptive optimization (Reddi et al. 2020), port of
``fedml_tpu/algorithms/fedopt.py``.

The server averages the cohort's models, forms the pseudo-gradient
``Δ = w_old − w_avg`` and steps a server optimizer on it.  The JAX package
names optax transforms; the port writes optax's update rules out as tensor
functions, because ``torch.optim`` places eps and the bias correction
elsewhere, and several optax defaults have no torch counterpart (adagrad's
accumulator starts at 0.1 with eps 1e-7, yogi's sign rule and its 1e-6
initial accumulators, adamw's decay of 1e-4, rmsprop's ``initial_scale``
of 0).

The step runs through FedAvg's ``_server_update`` seam, after the round
and outside it, so the round keeps FedAvg's device-resident (on the GPU,
graphed) path; the scanned path is refused, as the JAX package refuses it.
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.server_opt import ServerOptMismatchError

class Transform(NamedTuple):
    """An optimizer, optax's GradientTransformation over flat dicts:
    ``init(params) -> state``, ``update(grads, state, params) ->
    (updates, state)``."""
    init: Callable[[Tree], dict]
    update: Callable


def _full_like(params: Tree, value: float) -> Tree:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _count(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)


def _bias_correction(moment: Tree, decay: float,
                     count: torch.Tensor) -> Tree:
    bc = 1 - torch.pow(torch.tensor(decay, dtype=torch.float32,
                                    device=count.device),
                       count.to(torch.float32))
    return {k: t / bc.to(t.dtype) for k, t in moment.items()}


def _moment(g: Tree, t: Tree, decay: float, order: int) -> Tree:
    """optax ``update_moment`` (order 1) and ``update_moment_per_elem_norm``
    (order 2): ``(1 − decay)·g^order + decay·t``."""
    return {k: (1 - decay) * (g[k] if order == 1 else torch.square(g[k]))
            + decay * t[k] for k in g}


def _scale(updates: Tree, factor: float) -> Tree:
    return {k: u * factor for k, u in updates.items()}


def sgd(lr: float, momentum) -> Transform:
    """``optax.sgd(lr, momentum=momentum or None)``: the trace ``t ← g +
    m·t`` when momentum is set, then ``−lr``."""
    def init(params):
        return {"trace": _full_like(params, 0.0)} if momentum else {}

    def update(g, state, params):
        if momentum:
            t = {k: g[k] + momentum * state["trace"][k] for k in g}
            return _scale(t, -lr), {"trace": t}
        return _scale(g, -lr), state
    return Transform(init, update)


def decayed_sgd(lr: float, momentum, weight_decay: float) -> Transform:
    """``optax.chain(add_decayed_weights(weight_decay), sgd(lr,
    momentum))``: ``g + wd·w`` into the trace, then ``−lr``."""
    init, sgd_update = sgd(lr, momentum)

    def update(g, state, params):
        g = {k: g[k] + weight_decay * params[k] for k in g}
        return sgd_update(g, state, params)
    return Transform(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``optax.apply_updates``: ``w + u`` leaf by leaf."""
    return {k: params[k] + updates[k] for k in params}


def _adam_update(g, state, b1, b2, eps):
    mu = _moment(g, state["mu"], b1, 1)
    nu = _moment(g, state["nu"], b2, 2)
    count = state["count"] + 1
    mu_hat = _bias_correction(mu, b1, count)
    nu_hat = _bias_correction(nu, b2, count)
    upd = {k: mu_hat[k] / (torch.sqrt(nu_hat[k]) + eps) for k in g}
    return upd, {"count": count, "mu": mu, "nu": nu}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": _count(params), "mu": _full_like(params, 0.0),
                "nu": _full_like(params, 0.0)}

    def update(g, state, params):
        upd, state = _adam_update(g, state, b1, b2, eps)
        return _scale(upd, -lr), state
    return Transform(init, update)


def adamw(lr: float, weight_decay: float = 1e-4) -> Transform:
    """scale_by_adam → add_decayed_weights(1e-4) → −lr."""
    init, _ = adam(lr)

    def update(g, state, params):
        upd, state = _adam_update(g, state, 0.9, 0.999, 1e-8)
        upd = {k: upd[k] + weight_decay * params[k] for k in upd}
        return _scale(upd, -lr), state
    return Transform(init, update)


def adagrad(lr: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Transform:
    """scale_by_rss: the sum of squares starts at 0.1."""
    def init(params):
        return {"sum_of_squares": _full_like(params,
                                             initial_accumulator_value)}

    def update(g, state, params):
        ss = {k: torch.square(g[k]) + state["sum_of_squares"][k] for k in g}
        upd = {k: torch.where(ss[k] > 0, torch.rsqrt(ss[k] + eps),
                              torch.zeros_like(ss[k])) * g[k] for k in g}
        return _scale(upd, -lr), {"sum_of_squares": ss}
    return Transform(init, update)


def rmsprop(lr: float, momentum, decay: float = 0.9,
            eps: float = 1e-8, initial_scale: float = 0.0) -> Transform:
    """scale_by_rms → −lr → the trace (``momentum`` not None)."""
    def init(params):
        out = {"nu": _full_like(params, initial_scale)}
        if momentum is not None:
            out["trace"] = _full_like(params, 0.0)
        return out

    def update(g, state, params):
        nu = _moment(g, state["nu"], decay, 2)
        upd = _scale({k: torch.rsqrt(nu[k] + eps) * g[k] for k in g}, -lr)
        new = {"nu": nu}
        if momentum is not None:
            upd = {k: upd[k] + momentum * state["trace"][k] for k in upd}
            new["trace"] = upd
        return upd, new
    return Transform(init, update)


def yogi(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
         initial_accumulator_value: float = 1e-6) -> Transform:
    """scale_by_yogi: ``v ← v − (1 − b2)·sign(v − g²)·g²``, both moments
    starting at 1e-6, bias-corrected."""
    def init(params):
        return {"count": _count(params),
                "mu": _full_like(params, initial_accumulator_value),
                "nu": _full_like(params, initial_accumulator_value)}

    def update(g, state, params):
        mu = _moment(g, state["mu"], b1, 1)
        nu = {k: state["nu"][k] - (1 - b2) * torch.sign(
                  state["nu"][k] - torch.square(g[k])) * torch.square(g[k])
              for k in g}
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        upd = {k: mu_hat[k] / (torch.sqrt(nu_hat[k]) + eps) for k in g}
        return _scale(upd, -lr), {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


# name -> factory(lr, momentum), the JAX package's registry
SERVER_OPTIMIZERS: Dict[str, Callable[[float, float], Transform]] = {
    "sgd": lambda lr, momentum: sgd(lr, momentum or None),
    "adam": lambda lr, momentum: adam(lr),
    "adagrad": lambda lr, momentum: adagrad(lr),
    "adamw": lambda lr, momentum: adamw(lr),
    "rmsprop": lambda lr, momentum: rmsprop(lr, momentum),
    "yogi": lambda lr, momentum: yogi(lr),
}


@dataclasses.dataclass
class FedOptConfig(FedAvgConfig):
    server_optimizer: str = "sgd"
    server_lr: float = 0.1
    server_momentum: float = 0.0


class FedOpt(FedAvg):
    """FedAvg plus a server optimizer on the pseudo-gradient."""

    def __init__(self, workload, data, config: FedOptConfig, sink=None,
                 device=None, mesh=None):
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        try:
            factory = SERVER_OPTIMIZERS[config.server_optimizer]
        except KeyError:
            raise ValueError(
                f"unknown server optimizer {config.server_optimizer!r}; "
                f"available: {sorted(SERVER_OPTIMIZERS)}") from None
        self._opt_init, self._opt_update = factory(config.server_lr,
                                                   config.server_momentum)
        self.server_opt_state = None
        # the optimizer family and hyperparameters this state belongs to;
        # a snapshot of another configuration is refused
        self._opt_tag = np.asarray(zlib.crc32(
            f"fedopt:{config.server_optimizer}:{config.server_lr!r}:"
            f"{config.server_momentum!r}".encode()), np.int64)
        self._server_update = self._srv_step

    def _srv_step(self, w_old: Tree, w_avg: Tree) -> Tree:
        if self.server_opt_state is None:
            self.server_opt_state = self._opt_init(w_old)
        delta = {k: w_old[k] - w_avg[k] for k in tree_keys(w_old)}
        updates, self.server_opt_state = self._opt_update(
            delta, self.server_opt_state, w_old)
        return {k: (w_old[k] + updates[k]).to(w_old[k].dtype)
                for k in tree_keys(w_old)}

    # the server optimizer's state rides the round checkpoint
    def _extra_state(self):
        return {"server_opt_state": self.server_opt_state,
                "opt_tag": self._opt_tag}

    def _extra_state_template(self, params):
        return {"server_opt_state": self._opt_init(params),
                "opt_tag": np.asarray(0, np.int64)}

    def _load_extra_state(self, extra) -> None:
        tag = extra.get("opt_tag")
        if tag is None:
            warnings.warn(
                "fedopt: restoring a pre-tag server-optimizer snapshot "
                "(no opt_tag recorded) — cannot verify it matches "
                "--server_optimizer/--server_lr/--server_momentum",
                stacklevel=2)
        elif int(tag) != int(self._opt_tag):
            raise ServerOptMismatchError(
                f"fedopt: snapshot's server-optimizer tag {int(tag)} != "
                f"this run's {int(self._opt_tag)} "
                f"(--server_optimizer {self.cfg.server_optimizer} "
                f"--server_lr {self.cfg.server_lr} "
                f"--server_momentum {self.cfg.server_momentum}); "
                f"restoring foreign optimizer state would silently "
                f"continue a different trajectory — rerun with the "
                f"snapshot's server flags or start fresh")
        self.server_opt_state = extra["server_opt_state"]
