"""``python -m fedml_tpu_torch`` — the port's entry point.

Runs ``fedavg``, ``fedavg_robust`` and ``turboaggregate`` on the hermetic
twins, on the GPU unless ``--platform cpu`` is given, writes
``metrics.jsonl`` and ``summary.json`` into ``--run_dir`` and prints one
final JSON summary line.  Examples, the FEMNIST-CNN configurations of the
defended FedAvg and of secure FedAvg:

    python -m fedml_tpu_torch --algo fedavg_robust --model cnn_fedavg \\
        --dataset femnist --defense weak_dp --defense_backend cuda \\
        --client_num_in_total 3400 --client_num_per_round 10 \\
        --batch_size 20 --lr 0.1 --epochs 1 --comm_round 3
    python -m fedml_tpu_torch --algo turboaggregate --model cnn_fedavg \\
        --dataset femnist --client_num_in_total 3400 \\
        --client_num_per_round 10 --group_num 2 --batch_size 20 --lr 0.1 \\
        --epochs 1 --comm_round 3 --secagg_backend cuda
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Callable, Dict

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.experiments.config import (ExperimentConfig,
                                                config_from_argv)
from fedml_tpu_torch.experiments.models import create_workload, sample_shape_of
from fedml_tpu_torch.utils.metrics import MetricsSink

logger = logging.getLogger("fedml_tpu_torch")

RUNNERS: Dict[str, Callable] = {}


def runner(name: str):
    def deco(fn):
        RUNNERS[name] = fn
        return fn
    return deco


def load_experiment_data(cfg: ExperimentConfig):
    from fedml_tpu_torch.data import load_data
    return load_data(cfg.dataset, data_dir=cfg.data_dir,
                     batch_size=cfg.batch_size,
                     num_clients=cfg.client_num_in_total, seed=cfg.seed)


def _fedavg_cfg_kwargs(cfg: ExperimentConfig) -> Dict[str, Any]:
    freq = max(cfg.comm_round, 1) if cfg.ci else cfg.frequency_of_the_test
    return dict(comm_round=cfg.comm_round,
                client_num_per_round=cfg.client_num_per_round,
                epochs=cfg.epochs, batch_size=cfg.batch_size, lr=cfg.lr,
                client_optimizer=cfg.client_optimizer, wd=cfg.wd,
                frequency_of_the_test=freq, seed=cfg.seed,
                rounds_per_dispatch=cfg.rounds_per_dispatch,
                client_axis=cfg.client_axis,
                eval_chunk_clients=cfg.eval_chunk_clients)


def _make_workload(cfg: ExperimentConfig, data):
    return create_workload(cfg.model, cfg.dataset, data.class_num,
                           sample_shape_of(data))


def _summary(algo, params) -> Dict[str, Any]:
    """The last eval row, the steady round rate (rounds after the first,
    which carries the warm-up) and whether every parameter is finite."""
    out = dict(algo.history[-1]) if algo.history else {}
    steady = algo.round_times[1:] or algo.round_times
    out["rounds_per_s"] = len(steady) / sum(steady) if steady else 0.0
    out["params_finite"] = all(
        bool(v.isfinite().all()) for v in params.values())
    return out


@runner("fedavg")
def run_fedavg(cfg, data, sink):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    algo = FedAvg(_make_workload(cfg, data), data,
                  FedAvgConfig(**_fedavg_cfg_kwargs(cfg)), sink=sink,
                  device=cfg.platform)
    return _summary(algo, algo.run())


@runner("fedavg_robust")
def run_fedavg_robust(cfg, data, sink):
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    algo = FedAvgRobust(_make_workload(cfg, data), data, FedAvgRobustConfig(
        defense=cfg.defense, norm_bound=cfg.norm_bound, stddev=cfg.stddev,
        defense_backend=cfg.defense_backend, **_fedavg_cfg_kwargs(cfg)),
        sink=sink, device=cfg.platform)
    return _summary(algo, algo.run())


def turboaggregate_config(cfg: ExperimentConfig):
    """The JAX runner's mapping: groups of ``max(2, per_round //
    group_num)`` clients."""
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateConfig
    return TurboAggregateConfig(
        comm_round=cfg.comm_round, group_num=cfg.group_num,
        clients_per_group=max(2, cfg.client_num_per_round // cfg.group_num),
        drop_tolerance=cfg.drop_tolerance, epochs=cfg.epochs, lr=cfg.lr,
        client_optimizer=cfg.client_optimizer, seed=cfg.seed,
        secagg_backend=cfg.secagg_backend,
        eval_chunk_clients=cfg.eval_chunk_clients)


@runner("turboaggregate")
def run_turboaggregate(cfg, data, sink):
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregate
    algo = TurboAggregate(_make_workload(cfg, data), data,
                          turboaggregate_config(cfg), sink=sink,
                          device=cfg.platform)
    return _summary(algo, algo.run())


def check_config(cfg: ExperimentConfig) -> None:
    """Refuse, by name, what the port does not run yet."""
    if cfg.algo not in RUNNERS:
        raise KeyError(f"--algo {cfg.algo!r} is not ported yet; the port "
                       f"has {sorted(RUNNERS)}")
    if cfg.mesh_clients:
        raise NotImplementedError(
            "--mesh_clients is not ported yet; the mesh paths arrive with "
            "the scanned/mesh-path slice (ROADMAP Queue 1)")
    if cfg.checkpoint_dir:
        raise NotImplementedError(
            "--checkpoint_dir is not ported yet; checkpoint/resume arrives "
            "with its own slice (ROADMAP Queue 1)")


def main(argv=None) -> Dict[str, Any]:
    cfg = argv if isinstance(argv, ExperimentConfig) \
        else config_from_argv(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    check_config(cfg)
    device = resolve_device(cfg.platform)
    cfg = dataclasses.replace(cfg, platform=str(device))
    data = load_experiment_data(cfg)
    logger.info("algo=%s model=%s dataset=%s clients=%d device=%s",
                cfg.algo, cfg.model, cfg.dataset, data.client_num, device)
    with MetricsSink(cfg.run_dir, stdout=cfg.log_stdout,
                     name=cfg.algo) as sink:
        sink.log({"config": dataclasses.asdict(cfg)})
        summary = RUNNERS[cfg.algo](cfg, data, sink)
        sink.log({"final": summary})
    print(json.dumps({"algo": cfg.algo, "dataset": cfg.dataset,
                      "model": cfg.model,
                      **{k: v for k, v in summary.items()
                         if isinstance(v, (int, float, str))}}))
    return summary


if __name__ == "__main__":
    main()
