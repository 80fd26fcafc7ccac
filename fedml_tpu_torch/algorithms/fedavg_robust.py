"""FedAvg-Robust — defenses at aggregation time (port of
``fedml_tpu/algorithms/fedavg_robust.py``).

``defense`` is ``none``, ``norm_diff_clipping`` or ``weak_dp``.
``defense_backend`` picks how they run:

* ``"torch"`` (twin of the JAX package's ``"xla"``): per-client
  ``clip_update`` + ``add_gaussian_noise`` before the weighted mean;
* ``"cuda"`` (twin of ``"pallas"``): the fused clip + noise + mean kernel
  (``core/fused_agg.py``), one launch per float leaf.

The Byzantine rules are refused until their slice is ported."""

from __future__ import annotations

import dataclasses

from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.core.fused_agg import make_fused_robust_aggregate
from fedml_tpu_torch.core.robust import add_gaussian_noise, clip_update
from fedml_tpu_torch.parallel.cohort import make_cohort_step

BYZANTINE_RULES = ("coordinate_median", "trimmed_mean", "krum", "multi_krum",
                   "geometric_median")


@dataclasses.dataclass
class FedAvgRobustConfig(FedAvgConfig):
    defense: str = "weak_dp"
    norm_bound: float = 5.0
    stddev: float = 0.025        # reference default for weak DP
    defense_backend: str = "torch"   # "torch" | "cuda"


class FedAvgRobust(FedAvg):
    DEFENSES = ("norm_diff_clipping", "weak_dp", "none")

    def __init__(self, workload, data, config: FedAvgRobustConfig, sink=None,
                 device=None):
        super().__init__(workload, data, config, sink=sink, device=device)
        cfg = config
        if cfg.defense in BYZANTINE_RULES:
            raise NotImplementedError(
                f"defense {cfg.defense!r} is a Byzantine aggregation rule; "
                f"those arrive with the Byzantine-rules slice of the port "
                f"(ROADMAP Queue 1)")
        if cfg.defense not in self.DEFENSES:
            raise ValueError(f"unknown defense {cfg.defense!r}; "
                             f"available: {self.DEFENSES}")
        if cfg.defense_backend not in ("torch", "cuda"):
            raise ValueError(
                f"unknown defense_backend {cfg.defense_backend!r}; "
                f"available: ('torch', 'cuda')")
        clip = cfg.defense in ("norm_diff_clipping", "weak_dp")
        noise = cfg.stddev if cfg.defense == "weak_dp" else 0.0

        if cfg.defense_backend == "cuda" and cfg.defense != "none":
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
            client_axis=cfg.client_axis)
