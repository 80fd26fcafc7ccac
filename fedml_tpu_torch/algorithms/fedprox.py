"""FedProx (Li et al. 2020) — FedAvg with a proximal term in local
training (port of ``fedml_tpu/algorithms/fedprox.py``).

The local objective is ``F_k(w) + (mu/2)·||w − w_global||²``, so each local
step's gradient gets ``mu·(w − w_global)``.  That is FedProx's only
difference from FedAvg, so it rides FedAvg's machinery through the
``local_train`` seam: the device-resident round (on the GPU one captured
CUDA graph) and the scanned rounds.
"""

from __future__ import annotations

import dataclasses

from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import make_client_optimizer


@dataclasses.dataclass
class FedProxConfig(FedAvgConfig):
    mu: float = 0.1


class FedProx(FedAvg):
    def __init__(self, workload, data, config: FedProxConfig, sink=None,
                 device=None, mesh=None):
        opt = make_client_optimizer(config.client_optimizer, config.lr,
                                    config.wd)
        local_train = make_local_trainer(workload, opt, config.epochs,
                                         prox_mu=config.mu)
        super().__init__(workload, data, config, sink=sink, device=device,
                         local_train=local_train, mesh=mesh)
