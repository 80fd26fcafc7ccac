"""FedAvg-Robust — defenses at aggregation time (port of
``fedml_tpu/algorithms/fedavg_robust.py``).

``defense`` is ``none``, ``norm_diff_clipping``, ``weak_dp`` or one of
the Byzantine rules of ``core/byzantine.py`` (``coordinate_median``,
``trimmed_mean``, ``krum``, ``multi_krum``, ``geometric_median``), which
replace the aggregate itself.  ``defense_backend`` picks how clip and
noise run:

* ``"torch"`` (twin of the JAX package's ``"xla"``): per-client
  ``clip_update`` + ``add_gaussian_noise`` before the weighted mean;
* ``"cuda"`` (twin of ``"pallas"``): the fused clip + noise + mean kernel
  (``core/fused_agg.py``); a Byzantine rule has its own aggregate and
  refuses it.

Every defense keeps the per-round host loop: the device-resident round
serves the base cohort step only, as in the JAX package.  On a mesh
(``mesh=``) clip and noise run as the per-client hook of the sharded
cohort step (each client's noise keyed by its global slot); the Byzantine
rules, which need the whole cohort on one rank, and the fused ``cuda``
backend, whose clip norm spans the cohort, are refused there as the JAX
package refuses them."""

from __future__ import annotations

import dataclasses
import logging

from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.core.byzantine import METHODS as BYZANTINE_RULES
from fedml_tpu_torch.core.byzantine import make_byzantine_aggregate
from fedml_tpu_torch.core.fused_agg import make_fused_robust_aggregate
from fedml_tpu_torch.core.robust import add_gaussian_noise, clip_update
from fedml_tpu_torch.parallel.cohort import make_cohort_step

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FedAvgRobustConfig(FedAvgConfig):
    defense: str = "weak_dp"
    norm_bound: float = 5.0
    stddev: float = 0.025        # reference default for weak DP
    defense_backend: str = "torch"   # "torch" | "cuda"
    trim_frac: float = 0.1       # trimmed_mean: fraction cut per side
    byz_f: int = 0               # krum: assumed Byzantine count
    krum_m: int = 1              # multi_krum: how many updates to average
    gm_iters: int = 8            # geometric_median: Weiszfeld iterations
    gm_eps: float = 1e-6         # geometric_median: smoothing floor


def check_krum(cfg, client_num: int) -> None:
    """Multi-Krum's bound on the live cohort, ``m <= n - f - 2`` (the
    cohort is capped at the dataset's client count); below ``n = 2f + 3``
    Krum's resilience guarantee lapses, which only warns."""
    m = cfg.krum_m if cfg.defense == "multi_krum" else 1
    n = min(cfg.client_num_per_round, client_num)
    max_m = n - cfg.byz_f - 2
    if m > max_m:
        raise ValueError(
            f"multi-Krum needs m <= n - f - 2 = {n} - {cfg.byz_f} - 2 = "
            f"{max_m}, got m={m}: selecting that many updates can include "
            f"Byzantine ones, silently degenerating to a plain mean")
    if n < 2 * cfg.byz_f + 3:
        log.warning("krum robustness guarantee needs n >= 2f + 3 (n=%d, "
                    "f=%d): selection may be defeatable by a coordinated "
                    "near-majority of Byzantine silos", n, cfg.byz_f)


class FedAvgRobust(FedAvg):
    DEFENSES = ("norm_diff_clipping", "weak_dp", "none") + BYZANTINE_RULES

    def __init__(self, workload, data, config: FedAvgRobustConfig, sink=None,
                 device=None, mesh=None):
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        cfg = config
        if cfg.defense not in self.DEFENSES:
            raise ValueError(f"unknown defense {cfg.defense!r}; "
                             f"available: {self.DEFENSES}")
        if cfg.defense_backend not in ("torch", "cuda"):
            raise ValueError(
                f"unknown defense_backend {cfg.defense_backend!r}; "
                f"available: ('torch', 'cuda')")
        if cfg.defense in BYZANTINE_RULES:
            if mesh is not None:
                raise ValueError(
                    f"defense {cfg.defense!r} needs the full cohort on one "
                    "chip (sorts / pairwise distances); drop --mesh_clients")
            if cfg.defense_backend == "cuda":
                raise ValueError(
                    "defense_backend='cuda' fuses clip+noise+mean; "
                    f"Byzantine rule {cfg.defense!r} has its own aggregate "
                    "— use the torch backend")
            if cfg.defense in ("krum", "multi_krum"):
                check_krum(cfg, data.client_num)
            self.cohort_step = make_cohort_step(
                self._local_train, aggregate=make_byzantine_aggregate(
                    cfg.defense, trim_frac=cfg.trim_frac, byz_f=cfg.byz_f,
                    krum_m=cfg.krum_m, gm_iters=cfg.gm_iters,
                    gm_eps=cfg.gm_eps),
                client_axis=cfg.client_axis)
            return
        clip = cfg.defense in ("norm_diff_clipping", "weak_dp")
        noise = cfg.stddev if cfg.defense == "weak_dp" else 0.0

        if cfg.defense_backend == "cuda" and cfg.defense != "none":
            if mesh is not None:
                raise ValueError("defense_backend='cuda' does not shard "
                                 "over a mesh; drop --mesh_clients or use "
                                 "the torch backend")
            fused = make_fused_robust_aggregate(
                norm_bound=cfg.norm_bound if clip else None, noise_std=noise)
            self.cohort_step = make_cohort_step(
                self._local_train, aggregate=fused,
                client_axis=cfg.client_axis)
            return

        def transform(client_params, global_params, generator):
            p = client_params
            if clip:
                p = clip_update(p, global_params, cfg.norm_bound)
            if noise:
                p = add_gaussian_noise(p, generator, noise)
            return p

        self.cohort_step = make_cohort_step(
            self._local_train,
            transform_update=None if cfg.defense == "none" else transform,
            client_axis=cfg.client_axis, mesh=mesh)
