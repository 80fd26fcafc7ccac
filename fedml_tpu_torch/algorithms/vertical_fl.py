"""Classical vertical FL: a guest (the labels) and hosts (feature shards)
(port of ``fedml_tpu/algorithms/vertical_fl.py``).

Each round the guest takes one minibatch, computes its logits, adds the
hosts' logits for the same rows, takes the sigmoid-BCE against its
labels (``{-1, +1}`` or ``{0, 1}``, binarised as ``y > 0``) and sends
d(loss)/d(total logits) back to every host; each party then backprops
through its own stack.  Batches advance cyclically and are always full.

`VerticalFL` differentiates the whole multi-party step at once: the
logits' sum is linear, so ``torch.func.grad`` over it gives exactly the
gradients the wire protocol ships.  `VFLHost`, `VFLGuest` and
`run_vfl_protocol` are that protocol, party by party (logits up, the
gradient down, a ``torch.func.vjp`` a party).  Every party's optimizer
is optax's ``add_decayed_weights(wd) -> sgd(lr, momentum)``.

Parties' data are host numpy arrays; the batch goes to the device each
round.  ``device``: None for the card (raises without one), "cpu" for the
CPU.  Weights are drawn on the CPU from ``rng`` (an int seed or a
``torch.Generator``), party by party in order; ``params=`` starts from
given ones (the tests carry the JAX package's init across)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vjp

from fedml_tpu_torch.algorithms.decentralized_online import bce_with_logits
from fedml_tpu_torch.algorithms.fedopt import apply_updates, decayed_sgd
from fedml_tpu_torch.core.pytree import as_tensor
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.trainer.workload import (apply_model, generator_of,
                                              init_module)


@dataclasses.dataclass
class VFLConfig:
    rounds: int = 100            # comm rounds, one batch each
    batch_size: int = 256
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.01
    frequency_of_the_test: int = 10


def _cyclic_batch(rnd: int, batch_size: int, n: int) -> np.ndarray:
    """The round's always-full cyclic minibatch (the index wraps, so
    every round serves batch_size rows of one static shape)."""
    return np.arange(rnd * batch_size, rnd * batch_size + batch_size) \
        % max(1, n)


def _bce_mean(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y01 = (y > 0).to(logits.dtype)
    return torch.mean(bce_with_logits(logits, y01))


class VerticalFL:
    """``party_models``: one module per party (guest first); each maps
    its feature shard to a [B, 1] logit contribution."""

    def __init__(self, party_models: Sequence[Any], cfg: VFLConfig,
                 device=None):
        self.party_models = list(party_models)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt = decayed_sgd(cfg.lr, cfg.momentum, cfg.weight_decay)

        def total_logits(params_list, xs):
            out = 0.0
            for model, p, x in zip(self.party_models, params_list, xs):
                out = out + apply_model(model, p, x)
            return out

        def loss_fn(params_list, xs, y):
            return _bce_mean(total_logits(params_list, xs), y)

        grad_fn = grad_and_value(loss_fn)

        def step(params_list, opt_states, xs, y):
            grads, loss = grad_fn(params_list, xs, y)
            new_params, new_opts = [], []
            for p, s, g in zip(params_list, opt_states, grads):
                u, s = self.opt.update(g, s, p)
                new_params.append(apply_updates(p, u))
                new_opts.append(s)
            return new_params, new_opts, loss

        self._step = step
        self._predict = total_logits

    def init(self, rng=None):
        """Every party's weights, drawn in order from ``rng``, and their
        optimizer states (the modules know their input widths; JAX's init
        takes a batch for them)."""
        gen = generator_of(rng)
        params = [init_module(m, gen, self.device)
                  for m in self.party_models]
        return params, [self.opt.init(p) for p in params]

    def fit(self, train: Sequence[np.ndarray], test: Sequence[np.ndarray],
            rng=None, params: Optional[List[Dict]] = None
            ) -> Dict[str, Any]:
        """train/test: ``[Xa, Xb, ..., y]`` (the loaders' contract)."""
        cfg = self.cfg
        xs_all, y_all = train[:-1], np.asarray(train[-1], np.float32)
        if params is None:
            params, opt_states = self.init(rng)
        else:
            params = [{k: as_tensor(v, self.device) for k, v in p.items()}
                      for p in params]
            opt_states = [self.opt.init(p) for p in params]
        n = len(y_all)
        history: List[Dict[str, float]] = []
        for rnd in range(cfg.rounds):
            idx = _cyclic_batch(rnd, cfg.batch_size, n)
            xs = [as_tensor(x[idx], self.device) for x in xs_all]
            y = as_tensor(y_all[idx], self.device)
            params, opt_states, loss = self._step(params, opt_states, xs, y)
            if (rnd + 1) % cfg.frequency_of_the_test == 0 \
                    or rnd == cfg.rounds - 1:
                m = self.evaluate(params, test)
                m.update({"round": rnd, "train_loss": float(loss)})
                history.append(m)
        return {"params": params, "history": history}

    def evaluate(self, params, test: Sequence[np.ndarray]) -> Dict[str, float]:
        xs = [as_tensor(x, self.device) for x in test[:-1]]
        y = np.asarray(test[-1], np.float32)
        with torch.no_grad():
            logits = self._predict(params, xs).cpu().numpy()
        pred = (logits > 0).astype(np.float32)
        # accuracy on 0/1-ized labels
        y01 = (y > 0).astype(np.float32)
        return {"test_acc": float((pred == y01).mean())}


# ---------------------------------------------------------------------------
# the message protocol, party by party

class VFLHost:
    """A host party: logits up, the gradient down."""

    def __init__(self, model, x: np.ndarray, cfg: VFLConfig, device=None):
        self.model = model
        self.x = x
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt = decayed_sgd(cfg.lr, cfg.momentum, cfg.weight_decay)

    def init(self, rng=None, params: Optional[Dict] = None) -> None:
        self.params = (init_module(self.model, generator_of(rng),
                                   self.device) if params is None else
                       {k: as_tensor(v, self.device)
                        for k, v in params.items()})
        self.opt_state = self.opt.init(self.params)

    def compute_logits(self, idx: np.ndarray) -> np.ndarray:
        self._batch = as_tensor(self.x[idx], self.device)
        with torch.no_grad():
            return apply_model(self.model, self.params,
                               self._batch).cpu().numpy()

    def apply_gradients(self, g_logits: np.ndarray) -> None:
        _, pullback = vjp(lambda q: apply_model(self.model, q, self._batch),
                          self.params)
        (g_p,) = pullback(as_tensor(g_logits, self.device))
        u, self.opt_state = self.opt.update(g_p, self.opt_state, self.params)
        self.params = apply_updates(self.params, u)


class VFLGuest(VFLHost):
    """The guest: a host with the labels and the loss; produces the
    gradient it sends to every host."""

    def __init__(self, model, x: np.ndarray, y: np.ndarray, cfg: VFLConfig,
                 device=None):
        super().__init__(model, x, cfg, device)
        self.y = np.asarray(y, np.float32)
        self._loss_and_grad = grad_and_value(_bce_mean)

    def guest_step(self, host_logits: List[np.ndarray], idx: np.ndarray
                   ) -> np.ndarray:
        guest_logits = self.compute_logits(idx)
        total = as_tensor(sum(host_logits, guest_logits), self.device)
        g, loss = self._loss_and_grad(total, as_tensor(self.y[idx],
                                                     self.device))
        self.last_loss = float(loss)
        g = g.cpu().numpy()
        self.apply_gradients(g)       # the guest backprops its stack too
        return g                      # broadcast to the hosts


def run_vfl_protocol(guest: VFLGuest, hosts: List[VFLHost],
                     rounds: int, batch_size: int, rng=None,
                     params: Optional[List[Dict]] = None) -> List[float]:
    """Drives the wire choreography end to end; returns the guest's loss
    each round.  Weights: drawn from ``rng`` guest first, then each host
    (as `VerticalFL.init` draws them), or ``params`` in that order."""
    gen = generator_of(rng)
    parties = [guest, *hosts]
    for i, p in enumerate(parties):
        p.init(gen, None if params is None else params[i])
    n = len(guest.y)
    losses = []
    for rnd in range(rounds):
        idx = _cyclic_batch(rnd, batch_size, n)
        host_logits = [h.compute_logits(idx) for h in hosts]
        g = guest.guest_step(host_logits, idx)
        for h in hosts:
            h.apply_gradients(g)
        losses.append(guest.last_loss)
    return losses
