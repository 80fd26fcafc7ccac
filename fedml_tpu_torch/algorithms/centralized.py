"""Centralized (non-federated) baseline trainer (port of
``fedml_tpu/algorithms/centralized.py``).

Trains one model on the pooled dataset with the federated clients'
optimizer and loss.  It is the oracle of the full-batch equivalence:
full-batch, E=1, full-participation FedAvg follows this trainer's
trajectory."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree
from fedml_tpu_torch.trainer.local_sgd import make_evaluator, make_local_trainer
from fedml_tpu_torch.trainer.workload import Workload, make_client_optimizer
from fedml_tpu_torch.utils.metrics import stats_from_metrics


class CentralizedTrainer:
    def __init__(self, workload: Workload, lr: float,
                 client_optimizer: str = "sgd", wd: float = 0.0,
                 epochs_per_call: int = 1):
        self.workload = workload
        opt = make_client_optimizer(client_optimizer, lr, wd)
        self.local_train = make_local_trainer(workload, opt, epochs_per_call)
        self.evaluate = make_evaluator(workload)

    def round_keys(self, rng: Optional[prng.Key], rounds: int):
        """The key of each call: ``rng, r = split(rng)`` per round from
        ``rng`` (``key(0)`` when None), as the JAX trainer's."""
        rng = rng if rng is not None else prng.key(0)
        keys = []
        for _ in range(rounds):
            rng, r = prng.split(rng)
            keys.append(r)
        return keys

    def train_rounds(self, params: Tree, data: Dict, rounds: int,
                     rng: Optional[prng.Key] = None) -> Tree:
        """``rounds`` sequential optimizer restarts over the same pooled
        data (``{x, y, mask: [S, B, ...]}``), as each FedAvg round restarts
        the client optimizer.  A keyed trainer (dropout) draws its step
        keys from each round's key (`round_keys`)."""
        device = next(iter(params.values())).device
        batches = {k: torch.as_tensor(data[k]).to(device)
                   for k in ("x", "y", "mask")}
        rng_inputs = getattr(self.local_train, "rng_inputs", None)
        for r in self.round_keys(rng, rounds):
            extra = ()
            if rng_inputs is not None:
                key = torch.tensor([r], dtype=torch.int64, device=device)
                extra = (rng_inputs(key, batches["mask"].shape[0])[0],)
            params, _ = self.local_train(params, batches, *extra)
        return params

    def metrics(self, params: Tree, data: Dict) -> Dict[str, float]:
        device = next(iter(params.values())).device
        batch = {k: torch.as_tensor(data[k]).to(device)
                 for k in ("x", "y", "mask")}
        return stats_from_metrics(self.evaluate(params, batch))
