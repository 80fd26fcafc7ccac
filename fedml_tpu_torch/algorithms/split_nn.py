"""SplitNN: split learning across a client body and a server head (port of
``fedml_tpu/algorithms/split_nn.py``).

The model is cut into a client half (``body``: x -> activations) and a
server half (``head``: activations -> logits).  Every batch the active
client sends activations and labels up, the server runs the head, takes
the cross-entropy, backprops to the cut and returns the activations'
gradient; clients take turns, round robin, and each hands the trained
body on to the next.

`SplitNNSimulator` differentiates ``head(body(x))`` end to end in one
step on the device: two parameter trees and two optimizers (optax's
``add_decayed_weights(wd) -> sgd(lr, momentum)``), one gradient.
`SplitNNServerActor` and `SplitNNClientActor` run the same two halves
over the message layer (`comm/`), activations up and gradients down per
batch, as numpy on the wire.

``device``: None for the card (raises without one), "cpu" for the CPU.
Weights are drawn on the CPU from ``rng`` (an int seed or a
``torch.Generator``): the body, then the head."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vjp

from fedml_tpu_torch.algorithms.fedopt import apply_updates, decayed_sgd
from fedml_tpu_torch.comm.actors import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.pytree import Tree, as_tensor
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.trainer.workload import (apply_model, generator_of,
                                              init_module)

MSG_ACTS = "splitnn.acts"          # client -> server: activations + labels
MSG_GRADS = "splitnn.grads"        # server -> client: dL/dacts
MSG_DONE = "splitnn.done"


@dataclasses.dataclass
class SplitNNConfig:
    epochs_per_client: int = 1     # epochs a client trains while active
    rounds: int = 1                # full round-robin sweeps over clients
    client_lr: float = 0.1
    server_lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4


def _head_loss(logits: torch.Tensor, y: torch.Tensor, m: torch.Tensor):
    """(masked mean cross-entropy, correct count) of a batch."""
    ce = F.cross_entropy(logits, y.long(), reduction="none")
    loss = torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
    correct = torch.sum((torch.argmax(logits, -1) == y) * m)
    return loss, correct


class SplitModel:
    """The split pair: ``body`` (the client half) maps x -> activations,
    ``head`` (the server half) maps activations -> logits."""

    def __init__(self, body, head):
        self.body = body
        self.head = head

    def init(self, rng=None, device="cpu") -> Tuple[Tree, Tree]:
        """(body, head) weights drawn from ``rng`` (the modules know their
        widths; JAX's init takes a sample for them)."""
        gen = generator_of(rng)
        return (init_module(self.body, gen, device),
                init_module(self.head, gen, device))

    def forward_body(self, body_params, x):
        return apply_model(self.body, body_params, x)

    def forward_head(self, head_params, acts):
        return apply_model(self.head, head_params, acts)


class SplitNNSimulator:
    """On-device split learning: one step trains both halves end to end;
    clients take turns round robin."""

    def __init__(self, split: SplitModel, cfg: SplitNNConfig, device=None):
        self.split = split
        self.cfg = cfg
        self.device = resolve_device(device)
        self.client_opt = decayed_sgd(cfg.client_lr, cfg.momentum,
                                      cfg.weight_decay)
        self.server_opt = decayed_sgd(cfg.server_lr, cfg.momentum,
                                      cfg.weight_decay)

        def loss_fn(body_params, head_params, batch):
            acts = self.split.forward_body(body_params, batch["x"])
            logits = self.split.forward_head(head_params, acts)
            return _head_loss(logits, batch["y"], batch["mask"])

        self._grad = grad_and_value(loss_fn, argnums=(0, 1), has_aux=True)
        self._loss_fn = loss_fn

    def _epoch_step(self, body_params, head_params, body_opt, head_opt,
                    data):
        """One client's epoch over its batches ``data`` ([S, B, ...])."""
        bp, hp, bo, ho = body_params, head_params, body_opt, head_opt
        ms = {"loss": [], "correct": [], "total": []}
        for s in range(data["x"].shape[0]):
            batch = {k: data[k][s] for k in ("x", "y", "mask")}
            (gb, gh), (loss, correct) = self._grad(bp, hp, batch)
            ub, bo = self.client_opt.update(gb, bo, bp)
            uh, ho = self.server_opt.update(gh, ho, hp)
            bp, hp = apply_updates(bp, ub), apply_updates(hp, uh)
            ms["loss"].append(loss)
            ms["correct"].append(correct)
            ms["total"].append(torch.sum(batch["mask"]))
        return bp, hp, bo, ho, {k: torch.stack(v) for k, v in ms.items()}

    def run(self, client_data: List[Dict[str, Any]], rng=None,
            params: Optional[Tuple[Tree, Tree]] = None) -> Dict[str, Any]:
        """client_data: per client ``{"x": [S, B, ...], "y": [S, B],
        "mask"}``.  The active client's trained body is handed to the
        next client.  ``params``: (body, head) to start from instead of
        drawing them from ``rng``."""
        cfg = self.cfg
        data = [{k: as_tensor(v, self.device) for k, v in d.items()}
                for d in client_data]
        if params is None:
            body_params, head_params = self.split.init(rng, self.device)
        else:
            body_params, head_params = (
                {k: as_tensor(v, self.device) for k, v in p.items()}
                for p in params)
        body_opt = self.client_opt.init(body_params)
        head_opt = self.server_opt.init(head_params)
        history = []
        for sweep in range(cfg.rounds):
            for ci, d in enumerate(data):
                for _ in range(cfg.epochs_per_client):
                    body_params, head_params, body_opt, head_opt, ms = \
                        self._epoch_step(body_params, head_params,
                                         body_opt, head_opt, d)
                    history.append({
                        "sweep": sweep, "client": ci,
                        "loss": float(np.mean(ms["loss"].cpu().numpy())),
                        "acc": float(ms["correct"].sum())
                        / max(1.0, float(ms["total"].sum()))})
        return {"body_params": body_params, "head_params": head_params,
                "history": history}

    def evaluate(self, body_params, head_params,
                 data: Dict[str, Any]) -> Dict[str, float]:
        total_loss, total_correct, total = 0.0, 0.0, 0.0
        with torch.no_grad():
            for s in range(data["x"].shape[0]):
                batch = {k: as_tensor(data[k][s], self.device)
                         for k in ("x", "y", "mask")}
                loss, correct = self._loss_fn(body_params, head_params,
                                              batch)
                n = float(batch["mask"].sum())
                total_loss += float(loss) * n
                total_correct += float(correct)
                total += n
        return {"loss": total_loss / max(total, 1.0),
                "acc": total_correct / max(total, 1.0)}


# ---------------------------------------------------------------------------
# the message-layer variant: activations up, gradients down per batch

class SplitNNServerActor(ServerManager):
    """Holds the head; answers every MSG_ACTS with MSG_GRADS."""

    def __init__(self, node_id, transport, split: SplitModel,
                 head_params, cfg: SplitNNConfig, device=None):
        super().__init__(node_id, transport)
        self.split = split
        self.cfg = cfg
        self.device = resolve_device(device)
        self.head_params = {k: as_tensor(v, self.device)
                            for k, v in head_params.items()}
        self.opt = decayed_sgd(cfg.server_lr, cfg.momentum, cfg.weight_decay)
        self.opt_state = self.opt.init(self.head_params)
        self.metrics = {"correct": 0.0, "total": 0.0, "loss_sum": 0.0}

        def loss_fn(hp, a, y, mask):
            return _head_loss(self.split.forward_head(hp, a), y, mask)

        self._grad = grad_and_value(loss_fn, argnums=(0, 1), has_aux=True)

    def register_handlers(self):
        self.register_handler(MSG_ACTS, self._on_acts)
        self.register_handler(MSG_DONE, lambda m: self.finish())

    def _on_acts(self, msg: Message):
        acts, y, mask = (as_tensor(msg.get(k), self.device)
                         for k in ("acts", "y", "mask"))
        (g_hp, g_acts), (loss, correct) = self._grad(self.head_params, acts,
                                                     y, mask)
        updates, self.opt_state = self.opt.update(g_hp, self.opt_state,
                                              self.head_params)
        self.head_params = apply_updates(self.head_params, updates)
        n = float(mask.sum())
        self.metrics["correct"] += float(correct)
        self.metrics["total"] += n
        self.metrics["loss_sum"] += float(loss) * n
        self.send(MSG_GRADS, msg.sender_id, grads=g_acts.cpu().numpy())


class SplitNNClientActor(ClientManager):
    """Holds the body; streams its batches, applying the returned
    gradients."""

    def __init__(self, node_id, transport, split: SplitModel, body_params,
                 data: Dict[str, np.ndarray], server_id: int,
                 cfg: SplitNNConfig, device=None):
        super().__init__(node_id, transport)
        self.split = split
        self.cfg = cfg
        self.device = resolve_device(device)
        self.body_params = {k: as_tensor(v, self.device)
                            for k, v in body_params.items()}
        self.data = data
        self.server_id = server_id
        self.opt = decayed_sgd(cfg.client_lr, cfg.momentum, cfg.weight_decay)
        self.opt_state = self.opt.init(self.body_params)
        self._batch_idx = 0
        self._epoch = 0

    def register_handlers(self):
        self.register_handler(MSG_GRADS, self._on_grads)

    def start_epoch(self):
        self._batch_idx = 0
        self._send_next_batch()

    def _current_batch(self):
        return {k: as_tensor(self.data[k][self._batch_idx], self.device)
                for k in ("x", "y", "mask")}

    def _send_next_batch(self):
        b = self._current_batch()
        self._last_x = b["x"]
        with torch.no_grad():
            acts = self.split.forward_body(self.body_params, b["x"])
        self.send(MSG_ACTS, self.server_id, acts=acts.cpu().numpy(),
                  y=b["y"].cpu().numpy(), mask=b["mask"].cpu().numpy())

    def _on_grads(self, msg: Message):
        g_acts = as_tensor(msg.get("grads"), self.device)
        _, pullback = vjp(lambda bp: self.split.forward_body(
            bp, self._last_x), self.body_params)
        (g_bp,) = pullback(g_acts)
        updates, self.opt_state = self.opt.update(g_bp, self.opt_state,
                                              self.body_params)
        self.body_params = apply_updates(self.body_params, updates)
        self._batch_idx += 1
        if self._batch_idx < self.data["x"].shape[0]:
            self._send_next_batch()
        else:
            self._epoch += 1
            if self._epoch < self.cfg.epochs_per_client:
                self.start_epoch()
            else:
                self.send(MSG_DONE, self.server_id)
