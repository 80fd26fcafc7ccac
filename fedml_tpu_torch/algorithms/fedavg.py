"""FedAvg — the standalone round loop (port of
``fedml_tpu/algorithms/fedavg.py``, the host-gather path).

Each round: seeded client sampling, a host gather of the cohort onto the
device, the cohort step (local SGD per client + aggregate), then an
evaluation over all clients every ``frequency_of_the_test`` rounds and on
the last one.  Checkpoint/resume, ``rounds_per_dispatch`` (scanned rounds)
and meshes are not ported yet; the config refuses them by name."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data.stacking import (FederatedData, gather_cohort,
                                           to_device)
from fedml_tpu_torch.device import resolve_device, synchronize
from fedml_tpu_torch.parallel.cohort import (cohort_eval, make_cohort_step,
                                             pad_clients)
from fedml_tpu_torch.trainer.local_sgd import make_evaluator, make_local_trainer
from fedml_tpu_torch.trainer.workload import Workload, make_client_optimizer
from fedml_tpu_torch.utils.metrics import stats_from_metrics

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FedAvgConfig:
    comm_round: int = 10
    client_num_per_round: int = 10
    epochs: int = 1
    batch_size: int = 10
    lr: float = 0.03
    client_optimizer: str = "sgd"
    wd: float = 0.0
    frequency_of_the_test: int = 5
    seed: int = 0
    rounds_per_dispatch: int = 1
    client_axis: str = "vmap"
    eval_chunk_clients: int = 1024

    def __post_init__(self):
        if self.rounds_per_dispatch != 1:
            raise NotImplementedError(
                "rounds_per_dispatch > 1 (scanned rounds) is not ported yet; "
                "it arrives with the scanned/mesh-path slice (ROADMAP Queue 1)")


def sweep_eval_chunks(stacked, chunk: int, run_chunk, device):
    """Slice the stacked client axis into [chunk]-row pieces (the last one
    zero-padded to the chunk size), call ``run_chunk(part, lo)`` on each
    and sum the metric dicts, which are exact under chunking."""
    total = None
    n_clients = stacked["num_samples"].shape[0]
    for lo in range(0, n_clients, chunk):
        part = to_device({k: v[lo:lo + chunk] for k, v in stacked.items()},
                         device)
        m = run_chunk(pad_clients(part, chunk), lo)
        total = m if total is None else {k: total[k] + m[k] for k in total}
    return total


def evaluate_global(eval_cohort, data: FederatedData, params: Tree,
                    chunk: int, device) -> Dict[str, float]:
    """Weighted train/test metrics of ``params`` over all clients, swept in
    chunks of ``chunk`` clients when the corpus is larger."""
    out: Dict[str, float] = {}
    for split, stacked in (("train", data.train), ("test", data.test)):
        if stacked is None:
            continue
        if chunk and stacked["num_samples"].shape[0] > chunk:
            m = sweep_eval_chunks(
                stacked, chunk, lambda part, lo: eval_cohort(params, part),
                device)
        else:
            m = eval_cohort(params, to_device(stacked, device))
        out.update(stats_from_metrics(m, prefix=f"{split}_"))
    return out


def round_keys(seed: int, drew_init: bool) -> Iterator[prng.Key]:
    """The round keys of the JAX package's ``FedAvg.run``: from
    ``key(seed)``, one ``split`` for the init when the run draws its own
    weights, then one ``split`` per round."""
    rng = prng.key(seed)
    if drew_init:
        rng, _ = prng.split(rng)
    while True:
        rng, round_key = prng.split(rng)
        yield round_key


def round_seed_words(seed: int, round_idx: int,
                     drew_init: bool = True) -> Tuple[int, int]:
    """The two int32 words that key one round's defense noise: the first
    two words of that round's key, as the JAX package's fused aggregate
    takes them."""
    keys = round_keys(seed, drew_init)
    for _ in range(round_idx):
        next(keys)
    return prng.key_words_int32(next(keys))


class FedAvg:
    def __init__(self, workload: Workload, data: FederatedData,
                 config: FedAvgConfig, sink=None, device=None):
        self.workload = workload
        self.data = data
        self.cfg = config
        self.sink = sink  # optional MetricsSink
        self.device = resolve_device(device)
        opt = make_client_optimizer(config.client_optimizer, config.lr,
                                    config.wd)
        self._local_train = make_local_trainer(workload, opt, config.epochs)
        self.cohort_step = make_cohort_step(self._local_train,
                                            client_axis=config.client_axis)
        self.evaluate = make_evaluator(workload)
        self._eval_cohort = cohort_eval(self.evaluate)
        self.history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []

    def _sample_round(self, round_idx: int):
        return sample_clients(round_idx, self.data.client_num,
                              self.cfg.client_num_per_round)

    def init_params(self) -> Tree:
        """Fresh weights from ``cfg.seed``, drawn on the CPU, so a seed
        gives the same init on every device."""
        return self.workload.init(torch.Generator().manual_seed(self.cfg.seed),
                                  self.device)

    def run(self, params: Optional[Tree] = None) -> Tree:
        cfg = self.cfg
        keys = round_keys(cfg.seed, drew_init=params is None)
        if params is None:
            params = self.init_params()
        params = {k: v.to(self.device) for k, v in params.items()}
        for round_idx in range(cfg.comm_round):
            t0 = time.perf_counter()
            ids = self._sample_round(round_idx)
            cohort = gather_cohort(self.data.train, ids,
                                   pad_to=cfg.client_num_per_round,
                                   device=self.device)
            params, _ = self.cohort_step(params, cohort,
                                         prng.key_words_int32(next(keys)))
            synchronize(self.device)
            round_s = time.perf_counter() - t0
            self.round_times.append(round_s)

            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == cfg.comm_round - 1):
                stats = self.evaluate_global(params)
                stats.update(round=round_idx, round_s=round_s)
                logger.info("round %d: %s", round_idx, stats)
                self.history.append(stats)
                if self.sink is not None:
                    self.sink.log(stats, step=round_idx)
        return params

    def evaluate_global(self, params: Tree) -> Dict[str, float]:
        """Weighted train/test metrics over all clients, swept in chunks of
        ``eval_chunk_clients`` clients when the corpus is larger."""
        return evaluate_global(self._eval_cohort, self.data, params,
                               self.cfg.eval_chunk_clients, self.device)
