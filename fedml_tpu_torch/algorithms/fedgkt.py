"""FedGKT: group knowledge transfer between the clients' small nets and
the server's large one (port of ``fedml_tpu/algorithms/fedgkt.py``).

Each round:

1. every client trains its small net for ``epochs_client`` epochs with
   CE + α·KL(client ∥ server logits), the KL term off in round 0 (no
   server logits yet);
2. each client extracts its feature maps and logits over its whole local
   set;
3. the server trains its large net over the pooled C·S batches of
   features for ``epochs_server`` epochs with CE + α·KL(server ∥ client
   logits);
4. the server's logits on every client's features are distilled back in
   the next round.

``kd_kl_loss``: ``T²·KL(softmax(teacher/T) + 1e-7 ∥ log_softmax(
student/T))`` per row.  The clients train together under
``torch.func.vmap`` over their stacked nets (each keeps its own; GKT never
averages them); the server's epoch is a loop over its batches.  Both
optimizers are optax's ``sgd(lr, momentum=0.9)``.

``device``: None for the card (raises without one), "cpu" for the CPU.
Weights are drawn on the CPU from ``rng`` (an int seed or a
``torch.Generator``): each client's net in turn, then the server's."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from fedml_tpu_torch.algorithms.fedopt import apply_updates, sgd
from fedml_tpu_torch.core.pytree import Tree, as_tensor, tree_stack
from fedml_tpu_torch.device import resolve_device, synchronize
from fedml_tpu_torch.trainer.workload import (apply_model, generator_of,
                                              init_module)


@dataclasses.dataclass
class FedGKTConfig:
    rounds: int = 10
    epochs_client: int = 1
    epochs_server: int = 1
    lr_client: float = 0.01
    lr_server: float = 0.01
    temperature: float = 3.0
    alpha: float = 1.0           # the KD term's weight
    seed: int = 0

    def __post_init__(self):
        if self.epochs_client < 1 or self.epochs_server < 1:
            raise ValueError("FedGKT requires epochs_client >= 1 and "
                             "epochs_server >= 1 (both phases must run)")


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """The T²-scaled distillation KL per row, the teacher's softmax
    floored by adding 1e-7."""
    T = temperature
    log_p = F.log_softmax(student_logits / T, dim=-1)
    q = F.softmax(teacher_logits / T, dim=-1) + 1e-7
    return T * T * torch.sum(q * (torch.log(q) - log_p), dim=-1)


def _masked_mean(per_row: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_row * m) / torch.clamp(torch.sum(m), min=1.0)


class FedGKT:
    """client_model: module x -> (logits, feature maps); server_model:
    module feature maps -> logits."""

    def __init__(self, client_model, server_model, cfg: FedGKTConfig,
                 device=None):
        self.client_model = client_model
        self.server_model = server_model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.client_opt = sgd(cfg.lr_client, 0.9)
        self.server_opt = sgd(cfg.lr_server, 0.9)
        # the last round's wall time by phase (seconds)
        self.phase_times: List[Dict[str, float]] = []
        self._build()

    def _build(self):
        cfg = self.cfg
        client, server = self.client_model, self.server_model

        def client_loss(cp, batch, server_logits, use_kd):
            logits, _ = apply_model(client, cp, batch["x"])
            ce = F.cross_entropy(logits, batch["y"].long(), reduction="none")
            kd = kd_kl_loss(logits, server_logits, cfg.temperature)
            return _masked_mean(ce + cfg.alpha * use_kd * kd, batch["mask"])

        client_grad = grad_and_value(client_loss)
        opt_update = self.client_opt.update

        def client_round(cp, opt_state, data, server_logits, use_kd):
            """One client's epochs over its batches, then its features and
            logits over its whole local set."""
            for _ in range(cfg.epochs_client):
                losses = []
                for s in range(data["x"].shape[0]):
                    batch = {k: v[s] for k, v in data.items()}
                    g, loss = client_grad(cp, batch, server_logits[s],
                                          use_kd)
                    updates, opt_state = opt_update(g, opt_state, cp)
                    cp = apply_updates(cp, updates)
                    losses.append(loss)
                loss = torch.stack(losses).mean()
            logits, feats = apply_model(
                client, cp, data["x"].reshape((-1,) + data["x"].shape[2:]))
            return cp, opt_state, loss, feats, logits

        # every client trains at once over the stacked client axis
        self._clients_round = vmap(client_round,
                                   in_dims=(0, 0, 0, 0, None))

        def server_loss(sp, feats, labels, client_logits, mask):
            logits = apply_model(server, sp, feats)
            ce = F.cross_entropy(logits, labels.long(), reduction="none")
            kd = kd_kl_loss(logits, client_logits, cfg.temperature)
            return _masked_mean(ce + cfg.alpha * kd, mask)

        server_grad = grad_and_value(server_loss)

        def server_epoch(sp, opt_state, feats, labels, client_logits, mask):
            losses = []
            for i in range(feats.shape[0]):
                g, loss = server_grad(sp, feats[i], labels[i],
                                      client_logits[i], mask[i])
                updates, opt_state = self.server_opt.update(g, opt_state, sp)
                sp = apply_updates(sp, updates)
                losses.append(loss)
            return sp, opt_state, torch.stack(losses).mean()

        self._server_epoch = server_epoch

    def _server_infer(self, sp, feats):
        with torch.no_grad():
            return apply_model(self.server_model, sp, feats)

    def init(self, rng=None, cohort: Optional[Dict[str, Any]] = None
             ) -> Tuple[Tree, Any, Tree, Any]:
        """Per-client nets (stacked ``[C, ...]``) and one server net, with
        their optimizer states.  ``cohort``: stacked ``{"x": [C, S, B,
        ...], ...}``, for the client count."""
        gen = generator_of(rng, self.cfg.seed)
        C = cohort["x"].shape[0]
        client_params = tree_stack([init_module(self.client_model, gen,
                                                self.device)
                                    for _ in range(C)])
        server_params = init_module(self.server_model, gen, self.device)
        return (client_params, vmap(self.client_opt.init)(client_params),
                server_params, self.server_opt.init(server_params))

    def run(self, cohort: Dict[str, Any], rng=None,
            params: Optional[Tuple[Tree, Tree]] = None) -> Dict[str, Any]:
        """``params``: (stacked client nets, server net) to start from
        instead of drawing them from ``rng``."""
        cfg = self.cfg
        dev = self.device
        data = {k: as_tensor(cohort[k], dev) for k in ("x", "y", "mask")}
        if params is None:
            client_params, client_opt, server_params, server_opt = \
                self.init(rng, data)
        else:
            client_params, server_params = (
                {k: as_tensor(v, dev) for k, v in p.items()} for p in params)
            client_opt = vmap(self.client_opt.init)(client_params)
            server_opt = self.server_opt.init(server_params)
        C, S, B = data["x"].shape[:3]
        num_classes = self.client_model.num_classes
        server_logits = torch.zeros((C, S, B, num_classes), device=dev)
        history: List[Dict[str, float]] = []
        for rnd in range(cfg.rounds):
            use_kd = 0.0 if rnd == 0 else 1.0
            t0 = time.perf_counter()
            client_params, client_opt, c_loss, feats, c_logits = \
                self._clients_round(client_params, client_opt, data,
                                    server_logits, use_kd)
            synchronize(dev)
            t1 = time.perf_counter()
            # all clients' features pooled into one server dataset
            fs = feats.reshape((C * S, B) + tuple(feats.shape[2:]))
            ys = data["y"].reshape(C * S, B)
            cls = c_logits.reshape(C * S, B, num_classes)
            ms = data["mask"].reshape(C * S, B)
            for _ in range(cfg.epochs_server):
                server_params, server_opt, s_loss = self._server_epoch(
                    server_params, server_opt, fs, ys, cls, ms)
            synchronize(dev)
            t2 = time.perf_counter()
            # distilled back: each client's server logits for next round
            s_logits = self._server_infer(
                server_params, fs.reshape((-1,) + tuple(fs.shape[2:])))
            server_logits = s_logits.reshape(C, S, B, num_classes)
            synchronize(dev)
            t3 = time.perf_counter()
            self.phase_times.append({"clients": t1 - t0, "server": t2 - t1,
                                     "distil": t3 - t2})
            history.append({"round": rnd,
                            "client_loss": float(torch.mean(c_loss)),
                            "server_loss": float(s_loss)})
        return {"client_params": client_params,
                "server_params": server_params, "history": history}

    def evaluate(self, client_params, server_params,
                 cohort: Dict[str, Any]) -> Dict[str, float]:
        """End-to-end accuracy: client features -> server logits."""
        dev = self.device
        correct, total = 0.0, 0.0
        x, y, mask = (as_tensor(cohort[k], dev) for k in ("x", "y", "mask"))
        C, S = x.shape[:2]
        with torch.no_grad():
            for c in range(C):
                cp = {k: v[c] for k, v in client_params.items()}
                for s in range(S):
                    _, feats = apply_model(self.client_model, cp, x[c, s])
                    logits = apply_model(self.server_model, server_params,
                                         feats)
                    pred = torch.argmax(logits, -1)
                    m = mask[c, s]
                    correct += float(torch.sum((pred == y[c, s]) * m))
                    total += float(torch.sum(m))
        return {"acc": correct / max(total, 1.0)}
