"""TurboAggregate: multi-group ring secure aggregation (So et al. 2020).

Port of ``fedml_tpu/algorithms/turboaggregate.py``.  Each round samples
``group_num * clients_per_group`` clients and splits them into groups:

- **in-group privacy**: each group trains its clients through the cohort
  engine (local SGD, vmap client axis) and aggregates them through the
  uint32 pairwise-masking aggregator (``secure/secagg.py``), so no single
  update is seen unmasked; the ``cuda`` backend runs the fused
  quantize + mask kernel, one launch per leaf per group;
- **cross-group redundancy**: a group's partial aggregate can be
  LCC-encoded into shares held by the next group and decoded from the
  survivors (``dropped_groups`` simulates lost hops), in numpy as in JAX;
- the group partials are combined sample-weighted.

Keys follow the JAX package's threefry chain (``core/prng.py``): group g
of round r masks with ``fold_in(fold_in(key(seed), r), g)``, so one seed
gives the same masks in both packages.
"""

from __future__ import annotations

import dataclasses
import logging
import secrets
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import evaluate_global
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree, tree_keys, tree_weighted_mean
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data.stacking import FederatedData, gather_cohort
from fedml_tpu_torch.device import resolve_device, synchronize
from fedml_tpu_torch.parallel.cohort import cohort_eval, train_cohort
from fedml_tpu_torch.secure.field import P_DEFAULT, lcc_decode, lcc_encode
from fedml_tpu_torch.secure.secagg import (SecureCohortAggregator,
                                           ring_budget_scale,
                                           validate_ring_budget)
from fedml_tpu_torch.trainer.local_sgd import make_evaluator, make_local_trainer
from fedml_tpu_torch.trainer.workload import Workload, make_client_optimizer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TurboAggregateConfig:
    comm_round: int = 10
    group_num: int = 4            # ring length L
    clients_per_group: int = 4
    drop_tolerance: int = 1       # T: tolerated dropouts per hop
    epochs: int = 1
    lr: float = 0.03
    client_optimizer: str = "sgd"
    seed: int = 0
    # clip * scale must stay within the centered field range P//2, and
    # clients_per_group * clip * scale within the uint32 ring; None derives
    # the largest power-of-two scale satisfying both
    quant_scale: Optional[float] = None
    quant_clip: float = 2.0**14
    secagg_backend: str = "torch"   # "cuda": fused quantize + mask kernel
    # secret entropy for the LCC masking chunks; None = fresh per instance.
    # It must stay secret from share holders.
    privacy_key: Optional[int] = None
    eval_chunk_clients: int = 1024


class TurboAggregate:
    """Group-ring secure FedAvg simulator."""

    def __init__(self, workload: Workload, data: FederatedData,
                 config: TurboAggregateConfig, sink=None, device=None):
        self.workload = workload
        self.data = data
        self.cfg = config
        self.sink = sink
        self.device = resolve_device(device)
        if config.quant_scale is None:
            self.quant_scale = ring_budget_scale(config.clients_per_group,
                                                 config.quant_clip)
            while config.quant_clip * self.quant_scale > P_DEFAULT // 2:
                self.quant_scale /= 2.0
            if self.quant_scale < 1.0:
                raise ValueError(
                    f"no usable fixed-point scale: clients_per_group="
                    f"{config.clients_per_group} at clip="
                    f"{config.quant_clip} cannot satisfy both the uint32 "
                    f"ring and the LCC field range")
        else:
            validate_ring_budget(config.clients_per_group,
                                 config.quant_clip, config.quant_scale)
            self.quant_scale = config.quant_scale
        if config.quant_clip * self.quant_scale > P_DEFAULT // 2:
            raise ValueError(
                "quant_clip*quant_scale exceeds the centered field range "
                f"P//2={P_DEFAULT // 2}: a clipped element at +clip would "
                "decode with flipped sign on the dropout-recovery path")
        self._privacy_key = (config.privacy_key if config.privacy_key
                             is not None else secrets.randbits(63))
        opt = make_client_optimizer(config.client_optimizer, config.lr)
        self._local_train = make_local_trainer(workload, opt, config.epochs)
        self.secagg = SecureCohortAggregator(
            config.clients_per_group, self.quant_scale, config.quant_clip,
            backend=config.secagg_backend)
        self._eval_cohort = cohort_eval(make_evaluator(workload))
        self.history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []

    def init_params(self) -> Tree:
        """Fresh weights from ``cfg.seed``, drawn on the CPU."""
        return self.workload.init(torch.Generator().manual_seed(self.cfg.seed),
                                  self.device)

    # -- one group's secure cohort aggregate --------------------------------
    def group_keys(self, round_idx: int) -> List[prng.Key]:
        """The masking key of each group of round ``round_idx``."""
        rng_round = prng.fold_in(prng.key(self.cfg.seed), round_idx)
        return [prng.fold_in(rng_round, g) for g in range(self.cfg.group_num)]

    def group_ids(self, round_idx: int) -> List[np.ndarray]:
        """The sampled clients of each group (an empty group, possible when
        the corpus is smaller than the cohort, carries no weight)."""
        cfg = self.cfg
        ids = sample_clients(round_idx, self.data.client_num,
                             cfg.group_num * cfg.clients_per_group)
        return [ids[g * cfg.clients_per_group:(g + 1) * cfg.clients_per_group]
                for g in range(cfg.group_num)]

    def masked_group_sum(self, params: Tree, cohort, round_key: prng.Key):
        """Local SGD over the group, then its weighted mean through the
        masks; returns the mean and the group's sample count."""
        # a dropout model's clients are keyed fold_in(round_key, i)
        trained, _ = train_cohort(self._local_train, params, cohort,
                                  round_key)
        num = cohort["num_samples"].to(torch.float32)
        mean = self.secagg.aggregate_stacked(trained, num, round_key)
        return mean, float(num.sum())

    def train_round(self, params: Tree, round_idx: int,
                    dropped_groups: Optional[List[int]] = None) -> Tree:
        """One ring pass: every group securely aggregates, then the group
        partials are combined sample-weighted.  The partials of
        ``dropped_groups`` are discarded and recovered from LCC shares."""
        cfg = self.cfg
        dropped = set(dropped_groups or ())
        if len(dropped) > cfg.drop_tolerance:
            raise ValueError(f"{len(dropped)} dropped groups exceed the "
                             f"design tolerance {cfg.drop_tolerance}")
        means: List[Tree] = []
        weights: List[float] = []
        keys = self.group_keys(round_idx)
        for g, gids in enumerate(self.group_ids(round_idx)):
            if len(gids) == 0:
                continue
            cohort = gather_cohort(self.data.train, gids,
                                   pad_to=cfg.clients_per_group,
                                   device=self.device)
            mean, n = self.masked_group_sum(params, cohort, keys[g])
            means.append(self._lcc_recover(mean, round_idx, g)
                         if g in dropped else mean)
            weights.append(n)
        return tree_weighted_mean(means, torch.tensor(weights,
                                                      dtype=torch.float32))

    def _lcc_recover(self, mean: Tree, round_idx: int, g: int) -> Tree:
        """A group partial through LCC: flatten (JAX's leaf order),
        quantize into the field, encode into ``clients_per_group`` shares,
        decode from the last N - T of them, and undo the quantization."""
        cfg = self.cfg
        keys = tree_keys(mean)
        vec = np.concatenate([mean[k].detach().cpu().numpy().ravel()
                              for k in keys]).astype(np.float64)
        q = np.mod(np.round(vec * self.quant_scale).astype(np.int64),
                   P_DEFAULT)
        q2 = np.pad(q, (0, (-len(q)) % 2)).reshape(-1, 2)
        n, k_chunks, t = cfg.clients_per_group, 2, cfg.drop_tolerance
        # after T member dropouts, the surviving N-T shares must still
        # reach the K+T needed to interpolate the coding polynomial
        if n - t < k_chunks + t:
            raise ValueError(
                f"clients_per_group={n} cannot tolerate T={t} dropouts with "
                f"K={k_chunks} data chunks (need N >= K + 2T = "
                f"{k_chunks + 2 * t})")
        # fresh secret randomness per (round, group): the masking chunks
        # must be unpredictable to share holders and never reused
        share_rng = np.random.RandomState(np.random.MT19937(
            np.random.SeedSequence([self._privacy_key, round_idx, g])))
        shares = lcc_encode(q2.T, n, k_chunks, t, p=P_DEFAULT, rng=share_rng)
        survivors = list(range(t, n))
        decoded = lcc_decode(shares[survivors], n, k_chunks, t, survivors,
                             p=P_DEFAULT)
        # decoded rows are the K interleaved chunks (row i = q[i::K])
        vec_q = decoded.T.reshape(-1)[:len(q)]
        signed = np.where(vec_q > P_DEFAULT // 2, vec_q - P_DEFAULT, vec_q)
        flat = torch.as_tensor(
            (signed.astype(np.float64) / self.quant_scale).astype(np.float32))
        out, lo = {}, 0
        for k in keys:
            size = mean[k].numel()
            out[k] = flat[lo:lo + size].reshape(mean[k].shape).to(
                mean[k].device)
            lo += size
        return out

    def run(self, params: Optional[Tree] = None) -> Tree:
        cfg = self.cfg
        if params is None:
            params = self.init_params()
        params = {k: v.to(self.device) for k, v in params.items()}
        for round_idx in range(cfg.comm_round):
            t0 = time.perf_counter()
            params = self.train_round(params, round_idx)
            synchronize(self.device)
            round_s = time.perf_counter() - t0
            self.round_times.append(round_s)
        stats = self.evaluate_global(params)
        stats.update(round=cfg.comm_round - 1,
                     round_s=self.round_times[-1] if self.round_times else 0.0)
        logger.info("round %d: %s", cfg.comm_round - 1, stats)
        self.history.append(stats)
        if self.sink is not None:
            self.sink.log(stats, step=cfg.comm_round - 1)
        return params

    def evaluate_global(self, params: Tree) -> Dict[str, float]:
        return evaluate_global(self._eval_cohort, self.data, params,
                               self.cfg.eval_chunk_clients, self.device)
