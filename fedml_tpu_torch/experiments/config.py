"""The experiment config of the port (the subset of
``fedml_tpu/experiments/config.py`` this slice runs, same flag names and
defaults).  ``defense_backend`` and ``secagg_backend`` take the port's
names: ``torch`` (twin of ``xla``) and ``cuda`` (twin of ``pallas``)."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class ExperimentConfig:
    algo: str = "fedavg"
    model: str = "lr"
    dataset: str = "mnist"
    data_dir: Optional[str] = None       # None => hermetic synthetic twin
    client_num_in_total: int = 1000
    client_num_per_round: int = 10
    batch_size: int = 10
    client_optimizer: str = "sgd"
    lr: float = 0.03
    wd: float = 0.001
    epochs: int = 1
    comm_round: int = 10
    frequency_of_the_test: int = 5
    rounds_per_dispatch: int = 1         # >1 is not ported (refused)
    ci: int = 0                          # eval only at round 0 and the end
    seed: int = 0

    norm_bound: float = 5.0              # robust: clip threshold
    stddev: float = 0.025                # robust: weak-DP noise
    defense: str = "weak_dp"             # robust: none|norm_diff_clipping|weak_dp
    defense_backend: str = "torch"       # robust: "torch" | "cuda" (fused)

    group_num: int = 2                   # turboaggregate: groups per round
    drop_tolerance: int = 1              # turboaggregate
    secagg_backend: str = "torch"        # turboaggregate: "torch" | "cuda"

    mesh_clients: int = 0                # >0 is not ported (refused)
    client_axis: str = "vmap"            # "vmap" | "scan"
    eval_chunk_clients: int = 1024       # evaluate_global clients per call
    platform: Optional[str] = None       # None/"gpu" -> cuda; "cpu"
    run_dir: Optional[str] = None        # metrics.jsonl + summary.json here
    checkpoint_dir: Optional[str] = None  # not ported (refused)
    log_stdout: bool = True


def build_parser() -> argparse.ArgumentParser:
    """One flag per config field."""
    p = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch",
        description="federated learning experiments, PyTorch/CUDA port")
    for f in dataclasses.fields(ExperimentConfig):
        name = "--" + f.name
        default = f.default
        if f.type in ("Optional[str]", Optional[str]):
            p.add_argument(name, type=str, default=default)
        elif isinstance(default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true"),
                           default=default)
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def config_from_argv(argv=None) -> ExperimentConfig:
    return ExperimentConfig(**vars(build_parser().parse_args(argv)))
