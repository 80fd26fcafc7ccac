"""``python -m fedml_tpu_torch`` — the port's entry point.

Runs ``fedavg``, ``fedavg_robust`` (``--backdoor``), ``turboaggregate``,
``cross_silo``, ``async_fl``, ``hierarchical``, ``cross_device``,
``centralized``, the stateful cohort algorithms
(``fedopt``, ``fedprox``, ``fednova``, ``scaffold``, ``feddyn``,
``ditto``, ``fedac``, ``dp_fedavg``) and the decentralized, split and
vertical ones (``decentralized``, ``decentralized_online``, ``split_nn``,
``vfl``, ``fedgkt``) on the hermetic twins, or on the
files under ``--data_dir`` (LEAF json, TFF h5, the CIFAR pickles and
CINIC-10 folders partitioned by ``--partition_method homo|hetero`` and
``--partition_alpha``, ImageNet and Landmarks), on the GPU
unless ``--platform cpu`` is given, writes ``metrics.jsonl`` and
``summary.json`` into ``--run_dir`` and prints one final JSON summary
line.  Examples, the
FEMNIST-CNN configurations of the defended FedAvg, of secure FedAvg and of
the live cross-silo federation with the sharded spine, FedAvg on the
transformer LM over the Shakespeare twin, and the cross-device engine on
the CNN and on BASELINE config 4:

    python -m fedml_tpu_torch --algo fedavg_robust --model cnn_fedavg \\
        --dataset femnist --defense weak_dp --defense_backend cuda \\
        --client_num_in_total 3400 --client_num_per_round 10 \\
        --batch_size 20 --lr 0.1 --epochs 1 --comm_round 3
    python -m fedml_tpu_torch --algo turboaggregate --model cnn_fedavg \\
        --dataset femnist --client_num_in_total 3400 \\
        --client_num_per_round 10 --group_num 2 --batch_size 20 --lr 0.1 \\
        --epochs 1 --comm_round 3 --secagg_backend cuda
    python -m fedml_tpu_torch --algo cross_silo --silo_backend local \\
        --model cnn_fedavg --dataset femnist --client_num_in_total 3400 \\
        --client_num_per_round 10 --batch_size 20 --lr 0.1 --epochs 1 \\
        --agg_mode stream --model_shards 4 --fused_finalize on \\
        --norm_clip 5.0 --agg_noise_std 0.025 --comm_round 3
    python -m fedml_tpu_torch --algo fedavg --model transformer \\
        --dataset shakespeare --client_num_in_total 715 \\
        --client_num_per_round 10 --batch_size 4 --lr 1.0 --epochs 1 \\
        --comm_round 3
    python -m fedml_tpu_torch --algo cross_device --model cnn_fedavg \\
        --dataset femnist --client_num_in_total 3400 \\
        --client_num_per_round 1000 --wave_size 256 --local_alg fedprox \\
        --batch_size 20 --lr 0.1 --epochs 1 --comm_round 3
    python -m fedml_tpu_torch --algo cross_device --model resnet18_gn \\
        --dataset fed_cifar100 --client_num_in_total 500 \\
        --client_num_per_round 10 --local_alg fednova --batch_size 20 \\
        --lr 0.1 --epochs 1 --comm_round 3

Plain FedAvg keeps the train split on the device when it fits and, with
``--rounds_per_dispatch K``, runs K rounds a call (on the GPU as replays
of one captured CUDA graph); ``--checkpoint_dir`` saves round checkpoints
and resumes from the latest.  ``--defense`` takes the Byzantine rules
(``krum --byz_f 1``, ...), and the live cross-silo server takes
``--robust_agg`` in both ``--agg_mode stack`` and ``stream`` (with
``--stream_reservoir K``).  The cross-silo server takes ``--checkpoint_dir``
(resume), ``--journal`` (mid-round resume), ``--dead_after_s`` (the failure
detector) and ``--chaos_*`` (seeded faults on the hub, threaded drive);
``--secagg pairwise`` runs the live federation under secure aggregation
(masked uploads, dropout recovery through the pair-secret shares) and
``--server_opt momentum|adam|fedac`` steps the finalized mean through a
server optimizer.  ``--algo cross_device`` (or ``--cross_device``) trains
each round's sampled cohort in waves of ``--wave_size`` clients folded
into the streaming mean, with ``--local_alg
sgd|fedprox|scaffold|fednova`` and ``--sampler numpy|jax``.
The live path also takes ``--edge_aggregators E`` (an edge tier, with
``--secagg grouped`` masking per edge block), ``--wire_compression
topk|int8`` (``--error_feedback true``), ``--adversary "2:scale:20"``,
``--min_quorum``/``--adaptive_deadline``/``--partition_frac`` (the
reliability tracker) and ``--ingest_pipeline true``; ``--algo async_fl``
runs FedBuff-style versions of ``--async_goal`` uploads, and ``--algo
hierarchical`` the two-tier simulation (``--group_num``,
``--group_comm_round``):

    python -m fedml_tpu_torch --algo async_fl --model cnn_fedavg \\
        --dataset femnist --client_num_in_total 3400 \\
        --client_num_per_round 10 --async_goal 5 --agg_mode stream \\
        --norm_clip 5.0 --batch_size 20 --lr 0.1 --comm_round 6

The live paths (``cross_silo``, ``async_fl``, ``cross_device``) take the
observability flags: ``--perf`` (one ``perf.jsonl`` line a round in
``--run_dir``, or at ``--perf_ledger``), ``--perf_strict`` (a re-capture
or rebuild after round 0 raises), ``--device_obs`` (each line's device
section: memory, the compile ledger, FLOPs and MFU against the card's
peak), ``--health`` (``health.jsonl``), ``--slo "name=value,..."``,
``--adaptive true`` (needs ``--health``), ``--telemetry true``
(``telemetry.{json,prom}``; ``--prom_port`` serves ``/metrics``),
``--trace_dir`` (the round spans as Perfetto JSON) and, on every
algorithm, ``--profile_dir`` (a ``torch.profiler`` Chrome trace);
``python -m fedml_tpu_torch.obs.report --run_dir DIR --trace_dir DIR``
renders them.

``--silo_backend grpc`` runs one node per process:

    python -m fedml_tpu_torch --algo cross_silo --silo_backend grpc \\
        --node_id 0 --client_num_per_round 2 ...   # the server
    python -m fedml_tpu_torch --algo cross_silo --silo_backend grpc \\
        --node_id 1 --client_num_per_round 2 ...   # silo 1, and so on
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.device import resolve_device, synchronize
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
    """Registry dispatch with the JAX package's kwargs: the CIFAR family's
    loaders take ``client_num``, ``--partition_method``,
    ``--partition_alpha`` and the seed.  Every twin also takes
    ``num_clients`` (``--client_num_in_total``), which an on-disk loader
    drops; the JAX package's CIFAR twins keep their default of 8 clients
    instead."""
    from fedml_tpu_torch.data import load_data
    kw: Dict[str, Any] = {"batch_size": cfg.batch_size,
                          "num_clients": cfg.client_num_in_total,
                          "seed": cfg.seed}
    if cfg.dataset in ("cifar10", "cifar100", "cinic10"):
        kw.update(client_num=cfg.client_num_in_total,
                  partition_method=cfg.partition_method,
                  partition_alpha=cfg.partition_alpha)
    return load_data(cfg.dataset, data_dir=cfg.data_dir, **kw)


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
                           sample_shape_of(data),
                           compute_dtype=cfg.compute_dtype,
                           attn_block_size=cfg.attn_block_size,
                           attn_flash=cfg.attn_flash,
                           moe_experts=cfg.moe_experts)


def _summary(algo, params) -> Dict[str, Any]:
    """The last eval row, the steady round rate and ms (rounds after the
    first, which carries the warm-up: their mean, median, least and
    largest), whether every parameter is finite, the params' sha256 and
    the device.  On a mesh also the world, its backend, every rank's
    params sha256 (comma-separated, rank order) and the steady ms a round
    spent in collectives (mean, median, least, largest)."""
    from fedml_tpu_torch.parallel.mesh import params_sha256
    out = dict(algo.history[-1]) if algo.history else {}
    steady = algo.round_times[1:] or algo.round_times
    out["rounds_per_s"] = len(steady) / sum(steady) if steady else 0.0
    out["round_ms"] = 1e3 * sum(steady) / len(steady) if steady else 0.0
    out.update(_spread("round_ms", [1e3 * t for t in steady]))
    out["params_finite"] = all(
        bool(v.isfinite().all()) for v in params.values())
    out["params_sha256"] = params_sha256(params)
    out["device"] = str(algo.device)
    mesh = getattr(algo, "rank_mesh", None)
    if mesh is not None:
        coll = algo.collective_times[1:] or algo.collective_times
        out.update(
            world_size=mesh.world_size, dist_backend=str(mesh.backend),
            mesh_shape="x".join(f"{a}={n}" for a, n in mesh.shape.items()),
            rank_params_sha256=",".join(mesh.gather_hashes(params)),
            collective_ms_per_round=sum(coll) / len(coll) if coll else 0.0)
        out.update(_spread("collective_ms", coll))
        p2p = algo.p2p_times[1:] or algo.p2p_times
        if any(p2p):
            out["collective_ms_p2p_per_round"] = sum(p2p) / len(p2p)
            out.update(_spread("collective_ms_p2p", p2p))
    return out


def _spread(name: str, xs) -> Dict[str, float]:
    """The median, least and largest of ``xs`` as ``<name>_median`` /
    ``_min`` / ``_max`` (nothing for no value)."""
    if not len(xs):
        return {}
    return {f"{name}_median": float(np.median(xs)),
            f"{name}_min": float(min(xs)), f"{name}_max": float(max(xs))}


def make_checkpointer(cfg: ExperimentConfig, writer: bool = True):
    """The run's `RoundCheckpointer`; ``writer`` False (a mesh rank other
    than 0) resumes from the run's checkpoints and writes none."""
    if not cfg.checkpoint_dir:
        return None
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer

    class Reader(RoundCheckpointer):
        def save(self, round_idx, state) -> None:
            pass

    return (RoundCheckpointer if writer else Reader)(
        cfg.checkpoint_dir, save_every=cfg.checkpoint_every,
        async_save=cfg.checkpoint_async,
        keep_last_n=cfg.checkpoint_keep_last_n)


def _run_with_checkpoints(cfg, algo, extra=None):
    """Run ``algo`` with the run's checkpointer; its summary, and
    ``extra(params)``'s entries when given."""
    mesh = getattr(algo, "rank_mesh", None)
    ckpt = make_checkpointer(cfg, writer=mesh is None or mesh.rank == 0)
    try:
        params = algo.run(checkpointer=ckpt)
    finally:
        if ckpt is not None:
            ckpt.close()
    out = _summary(algo, params)
    if extra is not None:
        out.update(extra(params))
    return out


def _first_cohort(data, n: int):
    """The deterministic cohort of the first n clients, on the CPU (the
    runners whose algorithm takes one cohort: FedGKT)."""
    from fedml_tpu_torch.data.stacking import gather_cohort
    ids = np.arange(min(n, data.client_num))
    return gather_cohort(data.train, ids, pad_to=n)


def _image_sample_shape(cfg, data, algo: str):
    shape = sample_shape_of(data)
    if len(shape) != 3:
        raise ValueError(
            f"--algo {algo} needs image-shaped data [H, W, C]; dataset "
            f"{cfg.dataset!r} yields {shape}. Try --dataset femnist or "
            f"cifar10.")
    return shape


@runner("fedavg")
def run_fedavg(cfg, data, sink, mesh=None):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    if cfg.mesh_sequence > 0:
        return _run_with_checkpoints(cfg, sp_fedavg_algo(cfg, data, sink,
                                                         mesh))
    algo = FedAvg(_make_workload(cfg, data), data,
                  FedAvgConfig(**_fedavg_cfg_kwargs(cfg)), sink=sink,
                  device=cfg.platform, mesh=mesh)
    return _run_with_checkpoints(cfg, algo)


def sp_fedavg_algo(cfg, data, sink, mesh):
    """``--mesh_sequence``: FedAvg whose rounds train over the ``[clients,
    sequence]`` mesh of the run's ranks (`parallel.sequence`: ring
    attention, the loss's counts and the gradients summed over the
    sequence axis inside each client, the weighted mean over both axes).
    Init and evaluation run the dense workload on each rank, as in the
    JAX runner (``main.py:436-443``); the summary's collective figures are
    the sequence mesh's (``collective_ms_p2p*``: the ring's shifts)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.parallel.sequence import (make_sp_cohort_step,
                                                   make_sp_nwp_workload)
    from fedml_tpu_torch.trainer.workload import make_client_optimizer
    if not cfg.attn_block_size:
        logger.warning(
            "--mesh_sequence without --attn_block_size: init/eval run "
            "single-chip attention (auto-blockwise past 1024 tokens "
            "when a block of 64-512 divides T, DENSE O(T^2) scores "
            "otherwise); set --attn_block_size to pin the "
            "memory-efficient path")
    wl = _make_workload(cfg, data)
    algo = FedAvg(wl, data, FedAvgConfig(**_fedavg_cfg_kwargs(cfg)),
                  sink=sink, device=mesh.device)
    algo.cohort_step = make_sp_cohort_step(
        make_sp_nwp_workload(wl.model, mesh),
        make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd),
        cfg.epochs, mesh)
    algo.rank_mesh = mesh
    return algo


# the stateful cohort algorithms: --algo -> builder(cfg) -> (class, config)
ALGOS: Dict[str, Callable] = {}


def algo(name: str):
    """Register an algorithm builder and the runner that runs it."""
    def deco(fn):
        ALGOS[name] = fn
        RUNNERS[name] = lambda cfg, data, sink, mesh=None: \
            _run_with_checkpoints(cfg, build_algo(cfg, data, sink, mesh))
        return fn
    return deco


def build_algo(cfg: ExperimentConfig, data, sink=None, mesh=None):
    """The algorithm object ``--algo`` names, as its runner builds it."""
    cls, config = ALGOS[cfg.algo](cfg)
    return cls(_make_workload(cfg, data), data, config, sink=sink,
               device=cfg.platform, mesh=mesh)


@algo("fedprox")
def fedprox_algo(cfg):
    from fedml_tpu_torch.algorithms.fedprox import FedProx, FedProxConfig
    return FedProx, FedProxConfig(mu=cfg.mu, **_fedavg_cfg_kwargs(cfg))


@algo("fedopt")
def fedopt_algo(cfg):
    from fedml_tpu_torch.algorithms.fedopt import FedOpt, FedOptConfig
    return FedOpt, FedOptConfig(
        server_optimizer=cfg.server_optimizer, server_lr=cfg.server_lr,
        server_momentum=cfg.server_momentum, **_fedavg_cfg_kwargs(cfg))


@algo("fednova")
def fednova_algo(cfg):
    from fedml_tpu_torch.algorithms.fednova import FedNova, FedNovaConfig
    return FedNova, FedNovaConfig(mu=cfg.mu if cfg.mu else 0.0, gmf=cfg.gmf,
                                  **_fedavg_cfg_kwargs(cfg))


@algo("scaffold")
def scaffold_algo(cfg):
    from fedml_tpu_torch.algorithms.scaffold import Scaffold, ScaffoldConfig
    return Scaffold, ScaffoldConfig(**_fedavg_cfg_kwargs(cfg))


@algo("feddyn")
def feddyn_algo(cfg):
    from fedml_tpu_torch.algorithms.feddyn import FedDyn, FedDynConfig
    return FedDyn, FedDynConfig(feddyn_alpha=cfg.feddyn_alpha,
                                **_fedavg_cfg_kwargs(cfg))


@algo("ditto")
def ditto_algo(cfg):
    from fedml_tpu_torch.algorithms.ditto import Ditto, DittoConfig
    return Ditto, DittoConfig(
        ditto_lambda=cfg.ditto_lambda, personal_lr=cfg.personal_lr,
        personal_epochs=cfg.personal_epochs, **_fedavg_cfg_kwargs(cfg))


@algo("fedac")
def fedac_algo(cfg):
    from fedml_tpu_torch.algorithms.fedac import FedAC, FedACConfig
    return FedAC, FedACConfig(
        fedac_mu=cfg.fedac_mu, fedac_gamma=cfg.fedac_gamma,
        fedac_alpha=cfg.fedac_alpha, fedac_beta=cfg.fedac_beta,
        **_fedavg_cfg_kwargs(cfg))


@algo("dp_fedavg")
def dp_fedavg_algo(cfg):
    from fedml_tpu_torch.algorithms.dp_fedavg import DPFedAvg, DPFedAvgConfig
    return DPFedAvg, DPFedAvgConfig(
        dp_clip=cfg.dp_clip, dp_noise_multiplier=cfg.dp_noise_multiplier,
        dp_delta=cfg.dp_delta, dp_accounting=cfg.dp_accounting,
        **_fedavg_cfg_kwargs(cfg))


@runner("cross_device")
def run_cross_device(cfg, data, sink, mesh=None):
    """The cross-device wave engine (`algorithms.cross_device`): the
    seeded sampler picks the round's clients, static waves train on the
    card (on a mesh, each wave's slots over its ranks) and fold into the
    streaming mean at wave completion."""
    algo = cross_device_algo(cfg, data, sink, mesh)
    try:
        return _run_with_checkpoints(cfg, algo)
    finally:
        if algo.perf is not None:
            algo.perf.close()   # join the RSS sampler thread


def cross_device_algo(cfg: ExperimentConfig, data, sink=None, mesh=None):
    """The runner's `CrossDevice` for ``cfg``; with ``--server_opt``, the
    optimizer's template is the run's initial global.  ``--ingest_pipeline``
    folds the waves on one worker, ``--wave_adversary`` poisons wave
    summaries; the engine's ``degrade`` seam is an API seam, as in the
    JAX runner.  ``mesh``: the wave mesh (``--mesh_clients``); every rank
    keeps the recorders, rank 0 alone writes their ledgers."""
    from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                         CrossDeviceConfig)
    wl = _make_workload(cfg, data)
    writer = mesh is None or mesh.rank == 0
    perf = make_perf(cfg, resolve_device(cfg.platform), mesh=mesh)
    server_opt = None
    if cfg.server_opt != "plain":
        server_opt = make_server_opt(cfg, wl.init(
            torch.Generator().manual_seed(cfg.seed),
            resolve_device(cfg.platform)), perf=perf)
    # wave summaries are params-like trees: norms and alignment read
    # them against the round's global
    health = make_health(cfg, "params", write=writer)
    # the cohort lever widens up to the population; epochs and the wave
    # width stay pinned (static shapes of the wave program)
    controller = make_controller(
        cfg, cohort=cfg.client_num_per_round, epochs=cfg.epochs,
        wave_size=cfg.wave_size, max_cohort=data.client_num)
    return CrossDevice(
        wl, data, CrossDeviceConfig(
            wave_size=cfg.wave_size, local_alg=cfg.local_alg,
            sampler=cfg.sampler, mu=cfg.mu, norm_clip=cfg.norm_clip,
            agg_noise_std=cfg.agg_noise_std, admission=cfg.admission,
            norm_screen_k=cfg.norm_screen_k,
            norm_screen_window=cfg.norm_screen_window,
            norm_screen_min_history=cfg.norm_screen_min_history,
            wave_adversary=cfg.wave_adversary,
            **_fedavg_cfg_kwargs(cfg)),
        sink=sink, device=cfg.platform, server_opt=server_opt,
        # submit_wait cannot overflow (backpressure paces the waves), so
        # no fault feed is wired
        ingest=make_ingest(cfg, None), perf=perf, health=health,
        slo=make_slo(cfg), controller=controller, mesh=mesh)


@runner("centralized")
def run_centralized(cfg, data, sink):
    """Centralized training on the pooled train split (BASELINE.md's
    correctness oracle): one `CentralizedTrainer` call a round, keyed by
    ``split`` from ``key(seed)`` per round; train (and test) metrics
    every ``frequency_of_the_test`` rounds and on the last, logged as the
    JAX runner logs them."""
    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    from fedml_tpu_torch.core import prng
    wl = _make_workload(cfg, data)
    trainer = CentralizedTrainer(wl, lr=cfg.lr,
                                 client_optimizer=cfg.client_optimizer,
                                 wd=cfg.wd, epochs_per_call=cfg.epochs)
    device = resolve_device(cfg.platform)
    params = wl.init(torch.Generator().manual_seed(cfg.seed), device)
    rng = prng.key(cfg.seed)
    round_times, stats = [], {}
    for r in range(cfg.comm_round):
        t0 = time.perf_counter()
        rng, rr = prng.split(rng)
        params = trainer.train_rounds(params, data.train_global, 1, rr)
        synchronize(device)
        round_times.append(time.perf_counter() - t0)
        if r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1:
            stats = {"train_" + k: v for k, v in trainer.metrics(
                params, data.train_global).items()}
            if data.test_global is not None:
                stats.update({"test_" + k: v for k, v in trainer.metrics(
                    params, data.test_global).items()})
            stats["round"] = r
            sink.log(stats, step=r)
    steady = round_times[1:] or round_times
    return {**stats,
            "rounds_per_s": len(steady) / sum(steady) if steady else 0.0,
            "params_finite": all(bool(v.isfinite().all())
                                 for v in params.values())}


def fedavg_robust_config(cfg: ExperimentConfig):
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustConfig
    return FedAvgRobustConfig(
        defense=cfg.defense, norm_bound=cfg.norm_bound, stddev=cfg.stddev,
        defense_backend=cfg.defense_backend, trim_frac=cfg.trim_frac,
        byz_f=cfg.byz_f, krum_m=cfg.krum_m, gm_iters=cfg.gm_iters,
        gm_eps=cfg.gm_eps, **_fedavg_cfg_kwargs(cfg))


def backdoor_data(cfg: ExperimentConfig, data):
    """``--backdoor``: (data with the first ``--attacker_num`` clients'
    train shards poisoned, the targeted set stamped from the honest
    clients' masked eval rows), as the JAX runner builds them."""
    from fedml_tpu_torch.algorithms.backdoor import (make_targeted_test_set,
                                                     poison_federated_data)
    _image_sample_shape(cfg, data, "fedavg_robust --backdoor")
    attackers = list(range(min(cfg.attacker_num, data.client_num)))
    eval_src = data.test if data.test is not None else data.train
    honest = np.arange(len(attackers), data.client_num)
    x_eval = np.asarray(eval_src["x"])[honest]
    y_eval = np.asarray(eval_src["y"])[honest]
    m_eval = np.asarray(eval_src["mask"])[honest].reshape(-1) > 0
    x_eval = x_eval.reshape((-1,) + x_eval.shape[3:])[m_eval]
    y_eval = y_eval.reshape(-1)[m_eval]
    targeted = make_targeted_test_set(
        x_eval, y_eval, cfg.target_label, trigger_size=cfg.trigger_size)
    data = poison_federated_data(
        data, attackers, cfg.target_label, cfg.poison_frac,
        cfg.trigger_size, seed=cfg.seed)
    return data, targeted


@runner("fedavg_robust")
def run_fedavg_robust(cfg, data, sink, mesh=None):
    """The defended FedAvg; ``--backdoor`` poisons the first
    ``--attacker_num`` clients and reports ``backdoor_acc``, the global's
    targeted-task accuracy."""
    from fedml_tpu_torch.algorithms.backdoor import targeted_accuracy
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    targeted = None
    if cfg.backdoor:
        data, targeted = backdoor_data(cfg, data)
    wl = _make_workload(cfg, data)
    algo = FedAvgRobust(wl, data, fedavg_robust_config(cfg), sink=sink,
                        device=cfg.platform, mesh=mesh)
    if targeted is None:
        return _run_with_checkpoints(cfg, algo)

    def backdoor_acc(params):
        acc = targeted_accuracy(wl, params, targeted)
        sink.log({"backdoor_acc": acc}, step=cfg.comm_round - 1)
        return {"backdoor_acc": acc}

    return _run_with_checkpoints(cfg, algo, extra=backdoor_acc)


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


class RoundKeyChain:
    """The live servers' round keys (JAX ``main.py``'s ``_round_rng``):
    the chain starts at ``split(key(seed))[0]`` and advances one ``split``
    a round, the round's key the second half; asking again for the last
    round returns its key, and a round before it (a resume) restarts the
    chain from the seed.  A lock guards the chain: chaos mode trains its
    silos on threads that share it.  ``silo_key(r, silo_id)`` is silo
    ``silo_id``'s key of round ``r``, ``fold_in(key_r, silo_id - 1)``."""

    def __init__(self, seed: int):
        from fedml_tpu_torch.core import prng
        self._prng = prng
        self._seed = int(seed)
        self._lock = threading.Lock()
        self._reset()

    def _reset(self) -> None:
        self._next = 0
        self._rng = self._prng.split(self._prng.key(self._seed))[0]
        self._last = None

    def __call__(self, round_idx: int):
        with self._lock:
            if round_idx < self._next - 1:
                self._reset()
            if round_idx == self._next - 1:
                return self._last
            while self._next <= round_idx:
                self._rng, self._last = self._prng.split(self._rng)
                self._next += 1
            return self._last

    def silo_key(self, round_idx: int, silo_id: int):
        return self._prng.fold_in(self(round_idx), silo_id - 1)


def _silo_training_setup(cfg, data, wl, device, init_params=None,
                         perf=None):
    """The initial global and the per-silo ``train_fn(params, client_idx,
    round_idx)`` factory ``make_train_fn(silo_id, shard_transform=None)``:
    each silo trains its sampled client's shard on ``device`` with the
    local trainer, keyed for a dropout model by `RoundKeyChain`'s
    ``silo_key(round_idx, silo_id)``.  ``init_params`` (a flat dict)
    replaces the seeded init, as a test does to carry the JAX package's
    weights across.

    Each silo gets a workload of its own: ``functional_call`` swaps the
    parameters of the module it is given in place, so silos training on
    their own threads (the threaded drive) must not share one module.

    ``perf``: the perf recorder; each silo's trainer registers as
    ``train_fn`` (the device observatory counts its FLOPs on the first
    call), inside the trainer telemetry of ``--telemetry``."""
    from fedml_tpu_torch.core.pytree import as_tensor
    from fedml_tpu_torch.trainer.local_sgd import (instrument_train_fn,
                                                   make_local_trainer)
    from fedml_tpu_torch.trainer.workload import make_client_optimizer
    round_keys = RoundKeyChain(cfg.seed)

    def make_train_fn(silo_id, shard_transform=None):
        local = make_local_trainer(
            silo_workload(cfg, data, device),
            make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd),
            cfg.epochs)
        rng_inputs = local.rng_inputs
        if perf is not None:
            local = perf.instrument_jit("train_fn", local)
        local = instrument_train_fn(local, epochs=cfg.epochs)

        # shard_transform(shard, client_idx, round_idx): the adversary's
        # data-poisoning seam, before training
        def train_fn(params, client_idx, round_idx):
            shard = {k: data.train[k][client_idx] for k in ("x", "y", "mask")}
            if shard_transform is not None:
                shard = shard_transform(shard, client_idx, round_idx)
            shard = {k: torch.as_tensor(v).to(device)
                     for k, v in shard.items()}
            rng = ()
            if rng_inputs is not None:
                key = round_keys.silo_key(round_idx, silo_id)
                rng = (rng_inputs(torch.tensor([key], dtype=torch.int64,
                                                device=device),
                                  shard["mask"].shape[0])[0],)
            new, _ = local({k: as_tensor(v, device)
                            for k, v in params.items()}, shard, *rng)
            return new, float(data.train["num_samples"][client_idx])
        return train_fn

    if init_params is None:
        init_params = wl.init(torch.Generator().manual_seed(cfg.seed), device)
    return {k: v.to(device) for k, v in init_params.items()}, make_train_fn


def pp_stages(cfg: ExperimentConfig, device):
    """``--mesh_stages``' stage devices for a silo training on ``device``:
    the CPU for every stage, or the visible cards round robin (on one
    card every stage shares it, where the JAX package refuses)."""
    from fedml_tpu_torch.parallel.pipeline import make_stage_mesh
    return make_stage_mesh(cfg.mesh_stages, device=device)


def pp_workload(cfg: ExperimentConfig, data, device):
    """``--mesh_stages``: silo-local GPipe over the transformer's block
    stack (`parallel.pipeline`), at the dense `TransformerLM`'s widths in
    stacked form (the block count grows to one a stage past the default
    2), ``--moe_experts`` composing; JAX ``main.py:696-726``."""
    from fedml_tpu_torch.parallel.pipeline import (PipelineLM,
                                                   make_pp_nwp_workload)
    if cfg.model != "transformer":
        raise ValueError("--mesh_stages requires --model transformer "
                         "(the stacked-block PipelineLM)")
    shape = sample_shape_of(data)
    if len(shape) != 1:
        raise ValueError(f"--mesh_stages needs a sequence dataset "
                         f"(next-word prediction); got sample shape {shape}")
    plm = PipelineLM(vocab_size=data.class_num, d_model=128, n_heads=4,
                     n_layers=max(2, cfg.mesh_stages), d_ff=512,
                     max_len=2048, moe_experts=cfg.moe_experts)
    n_micro = cfg.pp_microbatches or cfg.mesh_stages
    if cfg.batch_size % n_micro:
        raise ValueError(f"--batch_size {cfg.batch_size} must divide into "
                         f"{n_micro} GPipe microbatches (--pp_microbatches)")
    return make_pp_nwp_workload(plm, pp_stages(cfg, device), n_micro=n_micro)


def silo_workload(cfg: ExperimentConfig, data, device):
    """A silo's workload: the pipelined one under ``--mesh_stages``."""
    if cfg.mesh_stages > 0:
        return pp_workload(cfg, data, device)
    return _make_workload(cfg, data)


def silo_key(seed: int, round_idx: int, silo_id: int):
    """The JAX runner's per-silo local-training key: ``fold_in(round key,
    silo_id - 1)`` on `FedAvg.run`'s split chain (one split for the init,
    one per round)."""
    from fedml_tpu_torch.algorithms.fedavg import round_keys
    from fedml_tpu_torch.core import prng
    keys = round_keys(seed, drew_init=True)
    for _ in range(round_idx):
        next(keys)
    return prng.fold_in(next(keys), silo_id - 1)


def _robust_setup(cfg: ExperimentConfig, template, kind: str = "params",
                  perf=None):
    """The replicated path's admission pipeline (``--admission auto`` arms
    it whenever a defense flag is set) and aggregation: ``(admission,
    defended, stream)``.  ``--agg_mode stream`` gives a streaming fold
    (the mean, or a rule over its reservoir); stack mode gives the
    defended aggregate over the staged cohort when a defense flag is set,
    else None (the plain weighted mean).  ``kind="delta"``: async uploads
    are deltas, screened by their own norm and clipped against zero.
    ``perf``: the perf recorder, whose sentry and device observatory the
    fold or the defended aggregate report to."""
    from fedml_tpu_torch.core.pytree import nest, to_host
    from fedml_tpu_torch.core.stream_agg import StreamingAggregator
    from fedml_tpu_torch.robust import AdmissionPipeline
    from fedml_tpu_torch.robust.defense import make_defended_aggregate

    robust_on = (cfg.robust_agg != "mean" or cfg.norm_clip > 0
                 or cfg.agg_noise_std > 0)
    admission = None
    if cfg.admission == "on" or (cfg.admission == "auto" and robust_on):
        admission = AdmissionPipeline(
            to_host(nest(template)), kind=kind,
            max_num_samples=cfg.max_num_samples, norm_k=cfg.norm_screen_k,
            norm_window=cfg.norm_screen_window,
            norm_min_history=cfg.norm_screen_min_history,
            trust=_trust_tracker(cfg))
    rule = dict(trim_frac=cfg.trim_frac, byz_f=cfg.byz_f, krum_m=cfg.krum_m,
                gm_iters=cfg.gm_iters, gm_eps=cfg.gm_eps,
                norm_clip=cfg.norm_clip, noise_std=cfg.agg_noise_std,
                seed=cfg.seed)
    sentry = perf.sentry if perf is not None else None
    device = perf.device if perf is not None else None
    if cfg.agg_mode == "stream":
        return admission, None, StreamingAggregator(
            template, method=cfg.robust_agg, kind=kind,
            reservoir_k=cfg.stream_reservoir, sentry=sentry,
            device_obs=device, **rule)
    defended = (make_defended_aggregate(cfg.robust_agg, sentry=sentry,
                                        device=device, **rule)
                if robust_on else None)
    return admission, defended, None


def _trust_tracker(cfg: ExperimentConfig):
    from fedml_tpu_torch.robust import TrustTracker
    return TrustTracker(strikes_to_quarantine=cfg.strikes_to_quarantine,
                        quarantine_rounds=cfg.quarantine_rounds,
                        probation_rounds=cfg.probation_rounds)


def _compose_extra_state(named):
    """Several named ``(get_fn, set_fn)`` pairs as the one ``extra_state``
    checkpoint hook: the saved tree is a dict keyed by name; a restored
    tree missing a name warns and restores what is there."""
    named = [(n, gs) for n, gs in named if gs is not None]
    if not named:
        return None

    def get():
        return {name: g() for name, (g, _) in named}

    def set_(tree):
        if not hasattr(tree, "get"):
            logger.warning("checkpoint extra-state is not the named-dict "
                           "schema (pre-composition checkpoint?); "
                           "skipping extra-state restore")
            return
        for name, (_, set_fn) in named:
            sub = tree.get(name)
            if sub is None:
                logger.warning("checkpoint extra-state has no %r entry; "
                               "that subsystem starts fresh", name)
                continue
            set_fn(sub)

    return (get, set_)


def make_journal(cfg: ExperimentConfig, subdir: Optional[str] = None):
    """The round journal under ``--journal_dir`` (or ``run_dir/journal``
    with ``--journal``); only the server node journals.  Under the edge
    topology each edge gets its own ``edge{e}`` subdirectory."""
    if not (cfg.journal or cfg.journal_dir):
        return None
    if cfg.silo_backend != "local" and cfg.node_id != 0:
        return None  # a gRPC silo has no fold state to journal
    import os
    from fedml_tpu_torch.utils.journal import RoundJournal
    path = cfg.journal_dir or os.path.join(cfg.run_dir or ".", "journal")
    if subdir:
        path = os.path.join(path, subdir)
    if not cfg.checkpoint_dir:
        logger.warning("--journal without --checkpoint_dir: mid-round "
                       "recovery needs the round-boundary checkpoint to "
                       "resume against; the journal will record but a "
                       "restarted server starts from round 0")
    elif cfg.checkpoint_every != 1:
        logger.warning("--journal with --checkpoint_every %d: mid-round "
                       "recovery only engages when the crashed round "
                       "directly follows a checkpointed one; set "
                       "--checkpoint_every 1 for full coverage",
                       cfg.checkpoint_every)
    return RoundJournal(path, snapshot_every=cfg.journal_snapshot_every,
                        node=subdir or f"node{cfg.node_id}")


def make_server_opt(cfg: ExperimentConfig, template, plan=None, perf=None):
    """The live server-optimizer seam; ``plain`` gives None (the actor
    then assigns the finalize verbatim).  ``perf``: the perf recorder,
    which ledgers the step."""
    if cfg.server_opt == "plain":
        return None
    from fedml_tpu_torch.server_opt import ServerOptimizer
    return ServerOptimizer(
        cfg.server_opt, template, lr=cfg.server_lr,
        momentum=cfg.server_momentum, beta1=cfg.server_adam_beta1,
        beta2=cfg.server_adam_beta2, eps=cfg.server_adam_eps,
        fedac_mu=cfg.fedac_mu, fedac_gamma=cfg.fedac_gamma,
        fedac_alpha=cfg.fedac_alpha, fedac_beta=cfg.fedac_beta,
        local_steps=cfg.epochs, plan=plan,
        sentry=perf.sentry if perf is not None else None,
        device=perf.device if perf is not None else None)


def make_perf(cfg: ExperimentConfig, device, mesh=None):
    """The perf flight recorder (`obs.perf`) of a live run: one
    ``perf.jsonl`` line a round at ``--perf_ledger`` (or
    ``run_dir/perf.jsonl``).  ``--perf_strict`` and ``--device_obs``
    imply it.  Only the server node records (a gRPC silo returns None);
    the runner owns ``close()``.  On a ``mesh`` every rank records (the
    device section's memory is a sum over the ranks' cards, one
    ``all_reduce`` at each read) and rank 0 alone writes the ledger."""
    if not (cfg.perf or cfg.perf_ledger or cfg.perf_strict
            or cfg.device_obs):
        return None
    if cfg.silo_backend != "local" and cfg.node_id != 0:
        return None
    import os
    from fedml_tpu_torch.obs import DeviceRecorder, PerfRecorder
    path = cfg.perf_ledger or os.path.join(
        cfg.metrics_dir or cfg.run_dir or ".", "perf.jsonl")
    return PerfRecorder(
        path if mesh is None or mesh.rank == 0 else None,
        node=f"node{cfg.node_id}", strict_recompiles=cfg.perf_strict,
        device=(DeviceRecorder(device=device, mesh=mesh)
                if cfg.device_obs else None))


def make_health(cfg: ExperimentConfig, kind: str, suppress_payload=None,
                write: bool = True):
    """The learning-health observatory (`obs.health`) of a live run: a
    ``health.jsonl`` line a round at ``--health_ledger`` (or
    ``run_dir/health.jsonl``); the drift-alarm thresholds ride the
    ``--slo`` spec (its ``health_*`` names).  Only the server node
    accumulates; ``write`` False (a mesh rank other than 0) keeps no
    ledger file."""
    if not (cfg.health or cfg.health_ledger):
        return None
    if cfg.silo_backend != "local" and cfg.node_id != 0:
        return None
    import os
    from fedml_tpu_torch.obs import HealthAccumulator
    from fedml_tpu_torch.obs.health import HEALTH_SLOS
    from fedml_tpu_torch.obs.perf import parse_slo_spec
    path = cfg.health_ledger or os.path.join(
        cfg.metrics_dir or cfg.run_dir or ".", "health.jsonl")
    spec = parse_slo_spec(cfg.slo) if cfg.slo else {}
    return HealthAccumulator(
        kind=kind, node=f"node{cfg.node_id}",
        ledger_path=path if write else None,
        thresholds={k: v for k, v in spec.items() if k in HEALTH_SLOS},
        suppress_payload=suppress_payload)


def make_slo(cfg: ExperimentConfig):
    """The SLO evaluator over the telemetry registry (`obs.perf`),
    evaluated once a round; None when telemetry is off (every objective
    would read vacuously healthy)."""
    from fedml_tpu_torch.obs import telemetry
    if not telemetry.get_registry().enabled:
        if cfg.slo:
            logger.warning("--slo given but telemetry is disabled; the "
                           "objectives need --telemetry true")
        return None
    from fedml_tpu_torch.obs.perf import SloEvaluator, parse_slo_spec
    return SloEvaluator(
        thresholds=parse_slo_spec(cfg.slo) if cfg.slo else None)


def make_controller(cfg: ExperimentConfig, *, cohort, epochs, wave_size=0,
                    max_cohort=None, epochs_live=False):
    """The health-driven adaptive round controller (``--adaptive``)."""
    if not cfg.adaptive:
        return None
    from fedml_tpu_torch.server_opt import AdaptiveController
    return AdaptiveController(
        cohort=cohort, epochs=epochs, wave_size=wave_size,
        min_cohort=cfg.adapt_min_cohort, max_cohort=max_cohort,
        patience=cfg.adapt_patience, epochs_live=epochs_live)


def secagg_setup(cfg: ExperimentConfig, data, init, device):
    """``--secagg pairwise|grouped``: ``(root server, masked admission
    factory, make_silo_secagg(masking id), make_edge_secagg(node))``.

    Pairwise: the whole cohort is one masking group served by the root's
    `SecAggServer` (the edge factory is None).  Grouped: each edge runs
    the protocol for its block with ``noise_std=0`` and the root stays
    plaintext (its root server is None), so the DP noise is added once,
    by the root's finalize over the edge means.  The admission is
    ``kind="masked"`` (the norm screen moves to the unmasked sum).  Every
    silo masks ``n_i / weight_cap <= 1``, with the cap the largest client
    size."""
    import numpy as np
    from fedml_tpu_torch.core.pytree import nest, to_host
    from fedml_tpu_torch.robust import AdmissionPipeline
    from fedml_tpu_torch.secure.protocol import (SecAggClient, SecAggServer,
                                                 masked_template)
    weight_cap = float(np.max(data.train["num_samples"]))

    def server(node, noise_std):
        return SecAggServer(
            threshold=cfg.secagg_threshold, clip=cfg.secagg_clip,
            weight_cap=weight_cap, norm_clip=cfg.norm_clip,
            noise_std=noise_std, seed=cfg.seed,
            norm_screen_k=cfg.norm_screen_k,
            norm_screen_window=cfg.norm_screen_window,
            norm_screen_min_history=cfg.norm_screen_min_history,
            node=node, device=device)

    def masked_admission():
        if cfg.admission == "off":
            return None
        return AdmissionPipeline(
            masked_template(to_host(nest(init))), kind="masked",
            max_num_samples=cfg.max_num_samples, trust=_trust_tracker(cfg))

    make_silo = lambda g: SecAggClient(g, device=device)  # noqa: E731
    if cfg.secagg == "pairwise":
        return server("server", cfg.agg_noise_std), masked_admission, \
            make_silo, None
    return None, masked_admission, make_silo, \
        (lambda node: server(node, 0.0))


def degrade_setup(cfg: ExperimentConfig, n_silos: int, mode: str = "sync"):
    """The reliability tracker (``--min_quorum`` / ``--adaptive_deadline``
    / ``--partition_frac``, `robust.degrade`), with the JAX package's
    gates (JAX ``main.py:256-321``).  ``mode``: ``"sync"`` (the round
    barrier) or ``"async"`` (the re-task watchdog; the barrier flags are
    refused)."""
    wanted = (cfg.min_quorum > 0 or cfg.adaptive_deadline
              or cfg.partition_frac > 0)
    if not wanted:
        return None
    if not 0.0 < cfg.min_quorum <= 1.0 and cfg.min_quorum != 0.0:
        raise ValueError(
            f"--min_quorum must be in (0, 1] (a cohort fraction), got "
            f"{cfg.min_quorum}")
    if mode == "async":
        if cfg.min_quorum > 0 or cfg.partition_frac > 0:
            raise ValueError(
                "--min_quorum/--partition_frac adjudicate the sync round "
                "barrier; the async server has no barrier to close — "
                "only --adaptive_deadline (the watchdog analog) applies")
        if not cfg.retask_timeout_s:
            raise ValueError(
                "--adaptive_deadline under --algo async_fl adapts the "
                "re-task watchdog and needs --retask_timeout_s > 0 (the "
                "ceiling and cold-start fallback)")
    elif mode == "sync":
        if cfg.straggler_policy != "drop":
            raise ValueError(
                "--min_quorum/--adaptive_deadline/--partition_frac "
                "adjudicate the close-early deadline, which only the "
                "'drop' straggler policy has; use --straggler_policy "
                "drop (wait never closes early, abort never degrades "
                "gracefully)")
        if (cfg.adaptive_deadline or cfg.partition_frac > 0) \
                and not cfg.round_timeout_s:
            raise ValueError(
                "--adaptive_deadline/--partition_frac need "
                "--round_timeout_s > 0: the static timeout is the "
                "deadline's ceiling and the cold-start fallback, and "
                "without a timer the deadline can never fire")
    if cfg.partition_frac > 0 and not 0.0 < cfg.partition_frac <= 1.0:
        raise ValueError(
            f"--partition_frac must be in (0, 1] (a cohort fraction), "
            f"got {cfg.partition_frac}")
    if cfg.partition_frac > 0 and cfg.min_quorum > 0 \
            and cfg.partition_frac > 1.0 - cfg.min_quorum + 1e-9:
        raise ValueError(
            f"--partition_frac {cfg.partition_frac} exceeds the quorum "
            f"gap 1 - min_quorum = {1.0 - cfg.min_quorum:.3f}: a miss "
            f"that large already blocks the quorum, so the partition "
            f"hold would be unreachable dead code — lower "
            f"--partition_frac or --min_quorum")
    from fedml_tpu_torch.robust.degrade import ReliabilityTracker
    return ReliabilityTracker(
        n_silos, min_quorum=cfg.min_quorum,
        adaptive_deadline=cfg.adaptive_deadline,
        deadline_floor_s=cfg.deadline_floor_s,
        deadline_quantile=cfg.deadline_quantile,
        deadline_slack=cfg.deadline_slack,
        partition_frac=cfg.partition_frac,
        partition_max_holds=cfg.partition_max_holds)


def adversary_train_fns(cfg: ExperimentConfig, data, make_train_fn,
                        n_silos: int):
    """Wrap the silo train-fn factory with ``--adversary``
    (`robust.adversary`): listed silos run their seeded attack over the
    real message path; every other silo is untouched."""
    if not cfg.adversary:
        return make_train_fn
    from fedml_tpu_torch.robust.adversary import (
        make_backdoor_shard_transform, make_malicious_train_fn,
        parse_adversary_spec)
    adversaries = parse_adversary_spec(cfg.adversary)
    bad = sorted(s for s in adversaries if s > n_silos)
    if bad:
        raise ValueError(f"--adversary names silos {bad} but the "
                         f"deployment has only {n_silos} silos (ids 1.."
                         f"{n_silos})")

    def wrapped(silo_id):
        atk = adversaries.get(silo_id)
        if atk is None:
            return make_train_fn(silo_id)
        transform = None
        if atk.kind == "backdoor":
            shape = sample_shape_of(data)
            if len(shape) != 3:
                raise ValueError(
                    f"--algo --adversary backdoor (silo {silo_id}) needs "
                    f"image-shaped data [H, W, C]; dataset {cfg.dataset!r} "
                    f"yields {shape}. Try --dataset femnist or cifar10.")
            target = int(atk.param) if atk.param >= 0 else cfg.target_label
            transform = make_backdoor_shard_transform(
                target, trigger_size=cfg.trigger_size,
                poison_frac=cfg.poison_frac, seed=cfg.seed)
        return make_malicious_train_fn(
            atk, make_train_fn(silo_id, transform), silo_id, seed=cfg.seed)

    return wrapped


class WireCodec:
    """``--wire_compression topk|int8`` (`comm.compress`, numpy on the
    host: a wire-boundary op never bounces the model through the card):
    silos send the compressed DELTA to the synced global, the server
    decodes it against its host global.  With ``--error_feedback`` each
    silo's residual is carried into its next delta and settled by the
    server's accepted-silo ack; on the local hub the residuals ride the
    server's round checkpoint (``extra_state``)."""

    def __init__(self, cfg: ExperimentConfig, init, n_silos: int):
        from fedml_tpu_torch.comm.compress import ErrorFeedback, tree_map
        from fedml_tpu_torch.core.pytree import nest, to_host
        self.cfg = cfg
        self.ef = ErrorFeedback()
        self.wire_bytes = 0       # compressed bytes received
        self.raw_bytes = 0        # their decoded size
        self.ef_extra = None
        if cfg.error_feedback and cfg.silo_backend == "local":
            template = tree_map(lambda v: np.zeros_like(np.asarray(v)),
                                to_host(nest(init)))
            silos = tuple(range(1, n_silos + 1))
            self.ef_extra = (lambda: self.ef.state_dict(silos, template),
                             self.ef.load_state_dict)
        from fedml_tpu_torch.obs import telemetry
        reg = telemetry.get_registry()
        self._c_comp = reg.counter("fedml_comm_compressed_bytes_total")
        self._c_raw = reg.counter("fedml_comm_raw_bytes_total")
        self._h_ratio = reg.histogram(
            "fedml_comm_compression_ratio_total",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0))

    def encode(self, silo: int):
        """Silo ``silo``'s ``encode_upload(upload, global)``."""
        from fedml_tpu_torch.algorithms.async_fl import delta_encoder
        from fedml_tpu_torch.comm.compress import (compress_update,
                                                   decompress_update)
        cfg = self.cfg

        def encode(new_params, global_params):
            delta = delta_encoder(new_params, global_params)
            if cfg.error_feedback:
                delta = self.ef.apply(silo, delta)
            payload = compress_update(delta, cfg.wire_compression,
                                      cfg.topk_frac)
            if cfg.error_feedback:
                self.ef.record(silo, delta, decompress_update(payload, delta))
            return payload
        return encode

    def on_accepted(self, silo: int):
        if not self.cfg.error_feedback:
            return None
        return lambda accepted: self.ef.resolve(silo, accepted)

    def decode(self, payload, host_global):
        """The server's ``decode_upload``: the global plus the decoded
        delta, as a nested host tree."""
        from fedml_tpu_torch.comm.compress import (decompress_update,
                                                   tree_map, wire_bytes)
        compressed = wire_bytes(payload)
        self.wire_bytes += compressed
        delta = decompress_update(payload, host_global)
        raw = wire_bytes(delta)
        self.raw_bytes += raw
        self._c_comp.inc(compressed)
        self._c_raw.inc(raw)
        if raw:
            self._h_ratio.observe(compressed / raw)
        return tree_map(np.add, host_global, delta)


def make_ingest(cfg: ExperimentConfig, degrade, spine=None, init=None,
                device=None, perf=None):
    """``--ingest_pipeline``: one fold worker a shard; overflow feeds the
    tracker's dead letters (a network fault).  With ``init`` the workers
    get pinned arenas templated on the exact slice layout the wire ships
    (masked uploads keep the host decode: a ciphertext norm is noise)."""
    if not cfg.ingest_pipeline:
        return None
    from fedml_tpu_torch.comm.ingest import IngestArena, IngestPipeline
    ingest = IngestPipeline(
        num_shards=spine.num_shards if spine is not None else 1,
        depth=cfg.ingest_queue_depth,
        fault_feed=((lambda reason, detail:
                     degrade.note_dead_letter(reason))
                    if degrade is not None else None))
    if init is not None and cfg.secagg == "off":
        from fedml_tpu_torch.core.pytree import nest, to_host
        host = to_host(nest(init))
        if spine is not None:
            arenas = [IngestArena(sl, device=spine.agg.devices[s],
                                  name=f"ingest_s{s}", perf=perf)
                      for s, sl in enumerate(spine.broadcast_slices(host))]
        else:
            arenas = [IngestArena(host, device=device, perf=perf)]
        ingest.attach_arenas(arenas)
    return ingest


def chaos_on(cfg: ExperimentConfig) -> bool:
    return any((cfg.chaos_drop, cfg.chaos_delay, cfg.chaos_dup,
                cfg.chaos_reorder, cfg.chaos_corrupt))


def make_chaos_plan(cfg: ExperimentConfig):
    """The seeded fault plan every hub endpoint's `ChaosTransport` draws
    from (FINISH and the straggler timer's self-message are immune)."""
    from fedml_tpu_torch.algorithms.cross_silo import MsgType
    from fedml_tpu_torch.comm.chaos import ChaosPlan, LinkChaos
    return ChaosPlan(
        seed=cfg.chaos_seed,
        default=LinkChaos(drop_prob=cfg.chaos_drop,
                          delay_prob=cfg.chaos_delay,
                          max_delay_s=cfg.chaos_max_delay_s,
                          dup_prob=cfg.chaos_dup,
                          reorder_prob=cfg.chaos_reorder,
                          corrupt_prob=cfg.chaos_corrupt),
        # ROUND_TIMEOUT rides the server's own chaotic link (0, 0):
        # dropping it would disarm the only re-arm path
        immune_types=(MsgType.S2C_FINISH, MsgType.ROUND_TIMEOUT))


def grpc_transport(cfg: ExperimentConfig, n_silos: int, degrade=None):
    """This process's endpoint of the gRPC mesh (``--node_id``), in a
    `ResilientTransport` with ``--silo_retries``; the server's dead
    letters feed ``degrade`` as network evidence."""
    from fedml_tpu_torch.comm.grpc_transport import (GrpcTransport,
                                                     load_ip_table)
    table = (load_ip_table(cfg.ip_config) if cfg.ip_config
             else {i: "127.0.0.1" for i in range(n_silos + 1)})
    transport = GrpcTransport(cfg.node_id, table, base_port=cfg.base_port,
                              max_message_mb=cfg.grpc_max_message_mb,
                              idle_timeout_s=cfg.silo_idle_timeout_s,
                              workers=cfg.grpc_workers)
    if cfg.silo_retries > 0:
        from fedml_tpu_torch.comm.resilient import (ResilientTransport,
                                                    RetryPolicy)
        transport = ResilientTransport(
            transport, RetryPolicy(max_attempts=cfg.silo_retries),
            seed=cfg.seed,
            fault_feed=((lambda reason, msg:
                         degrade.note_dead_letter(reason))
                        if degrade is not None and cfg.node_id == 0
                        else None))
    return transport


class ServeWhileTrain:
    """The serve-while-train block of a live run's server node (JAX
    ``main.py``'s ``--serve_port`` block): a `ModelRegistry` on the run's
    device behind a `ServeFrontend` (or, with ``--serve_workers`` > 1, a
    `ServeWorkerPool`), and ``publish(params, version)`` for the actor's
    hook — through the `ReleaseController` with ``--release_gate`` (a
    `ShadowSampler` tapping every worker's admitted traffic, the health
    observatory, the held-out eval), straight into the registry without.
    The first live model warms every bucket on a thread off the round
    path.  ``stop()`` drains the frontend.  The forward runs on a model
    module of its own (`serve.registry.module_apply`): the request
    threads must not swap parameters into the training workload's.  The
    gate scores a candidate's test accuracy with the federation's
    ``eval_cohort`` on the round path, as the JAX package's
    ``_release_eval_fn`` does."""

    def __init__(self, cfg, data, device, eval_cohort, slo=None,
                 health=None):
        import os
        from fedml_tpu_torch.serve import (MicroBatcher, ModelRegistry,
                                           ReleaseController, ServeFrontend,
                                           ServeWorkerPool, ShadowSampler)
        from fedml_tpu_torch.serve.registry import (module_apply,
                                                    pipeline_apply)
        self.cfg = cfg
        # under --mesh_stages the global is PipelineLM's stacked tree
        apply_fn = (pipeline_apply(silo_workload(cfg, data, device).model)
                    if cfg.mesh_stages > 0
                    else module_apply(_make_workload(cfg, data).model))
        self.registry = ModelRegistry(apply_fn, device=device)
        batcher_kw = dict(
            buckets=tuple(int(b) for b in cfg.serve_buckets.split(",")),
            max_delay_s=cfg.serve_batch_delay_ms / 1e3,
            queue_depth=cfg.serve_queue_depth,
            default_deadline_s=cfg.serve_deadline_ms / 1e3,
            best_effort_headroom=cfg.serve_best_effort_headroom)
        self.shadow = None
        if cfg.release_gate:
            # one sampler on every worker's batcher: the gate replays
            # real admitted traffic
            self.shadow = ShadowSampler(every=cfg.release_shadow_every,
                                        slots=cfg.release_shadow_slots)
            batcher_kw["shadow"] = self.shadow
        if cfg.serve_workers > 1:
            self.frontend = ServeWorkerPool(
                self.registry, port=cfg.serve_port,
                workers=cfg.serve_workers, slo=slo, health=health,
                **batcher_kw).start()
            self._warm = self.frontend.warmup
        else:
            batcher = MicroBatcher(self.registry, slo=slo, **batcher_kw)
            self.frontend = ServeFrontend(
                self.registry, batcher, port=cfg.serve_port, slo=slo,
                health=health).start()
            self._warm = batcher.warmup
        self.release = None
        if cfg.release_gate:
            self.release = ReleaseController(
                self.registry, shadow=self.shadow, health=health,
                eval_fn=self._scorer(eval_cohort, data, device),
                divergence_budget=cfg.release_divergence_budget,
                eval_tolerance=cfg.release_eval_tolerance,
                cooldown_s=cfg.release_cooldown_s,
                backoff=cfg.release_backoff,
                max_cooldown_s=cfg.release_max_cooldown_s,
                journal_path=os.path.join(
                    cfg.metrics_dir or cfg.run_dir or ".", "release.jsonl"))
        self._sample_x = np.asarray(data.train["x"][0, 0, 0])
        self.warmer = None

    @staticmethod
    def _scorer(eval_cohort, data, device):
        """Test accuracy of a candidate (higher is better), the test
        split put on ``device`` once; None without a test split (the eval
        signal then passes vacuously and says so)."""
        if data.test is None:
            return None
        from fedml_tpu_torch.core.pytree import flatten_nested
        from fedml_tpu_torch.data.stacking import to_device
        from fedml_tpu_torch.utils.metrics import stats_from_metrics
        test = to_device(data.test, device)

        def score(params):
            flat = {k: torch.as_tensor(v).to(device)
                    for k, v in flatten_nested(params).items()}
            return stats_from_metrics(eval_cohort(flat, test))["acc"]

        return score

    @property
    def port(self) -> int:
        return self.frontend.port

    def publish(self, params, version: int) -> None:
        if self.release is not None:
            # canary -> shadow/health/eval verdict -> promote or roll
            # back; the cross-silo hook's version IS the producing round
            self.release.offer(params, version, round_idx=version)
        else:
            self.registry.publish(params, version)
        if self.registry.current() is None or self.warmer is not None:
            return   # nothing live yet, or already warming
        import threading
        self.warmer = threading.Thread(
            target=self._warm, args=(self._sample_x,), daemon=True,
            name="serve-warmup")
        self.warmer.start()

    def stop(self) -> None:
        """Drain: queued requests still answer, then the listener
        closes."""
        if self.warmer is not None:
            self.warmer.join(timeout=60)
        self.frontend.stop(drain=True)


class CrossSiloFederation:
    """Distributed FedAvg over the actor/transport layer.

    ``--silo_backend local``: the server and ``client_num_per_round`` silo
    actors in-process on one `LocalHub` (every frame through the wire
    codec), driven by the synchronous pump — or, with ``--chaos_*`` (each
    endpoint in a `ChaosTransport`), by the threaded drive: every actor
    on its own thread, silos heartbeating every ``--heartbeat_s``.
    ``transport_factory(node_id) -> Transport`` replaces the hub (an
    `MqttTransport` per node over one broker, say) and takes the threaded
    drive.  ``--silo_backend grpc``: this process is node ``--node_id``
    of a gRPC mesh (0 the server, 1..N silos).

    ``--model_shards S`` runs the sharded spine: per-shard slice frames,
    per-shard admission and fold, and one K2 launch per shard per round
    with ``--fused_finalize on`` (or ``auto`` on the GPU).
    ``--checkpoint_dir`` checkpoints every closed round (the trust ledger,
    the shard layout, the optimizer, the EF residuals and the tracker ride
    ``extra_state``) and resumes from it; ``--journal``/``--journal_dir``
    adds the round journal; ``--dead_after_s`` the failure detector.
    ``--secagg pairwise`` the live secure aggregation (`secure.protocol`),
    and ``--server_opt`` the server-optimizer seam (its state sharded
    along the spine's plan).  ``--edge_aggregators E`` puts E
    `EdgeAggregatorActor`s between the silos and the root (hub address
    plan: root 0, edges 1..E, silo g at E+g), with ``--secagg grouped``
    masking per edge block.  ``--wire_compression`` compresses the
    uploads (`WireCodec`), ``--adversary`` attacks listed silos,
    ``--min_quorum``/``--adaptive_deadline``/``--partition_frac`` the
    reliability tracker, ``--ingest_pipeline`` the pipelined receive
    path.  ``--perf``/``--device_obs``/``--health``/``--slo``/
    ``--adaptive`` the observatories and the controller (server node
    only).  ``faultline``: the server's `robust.faultline.Faultline`.

    Built, then ``run()``; ``server.params`` is the global.
    ``init_params`` (a flat dict) replaces the seeded init."""

    def __init__(self, cfg, data, sink, init_params=None,
                 transport_factory=None, faultline=None):
        from fedml_tpu_torch.algorithms.cross_silo import (FailureDetector,
                                                           FedAvgClientActor,
                                                           FedAvgServerActor)
        from fedml_tpu_torch.parallel.cohort import cohort_eval
        from fedml_tpu_torch.shard_spine import build_shard_spine
        from fedml_tpu_torch.trainer.local_sgd import make_evaluator

        self.cfg, self.data, self.sink = cfg, data, sink
        self.device = resolve_device(cfg.platform)
        self.perf = perf = make_perf(cfg, self.device)
        self.slo = make_slo(cfg)
        # under pairwise masking the root sees only ciphertext: the
        # payload-derived health statistics are suppressed by name
        health = make_health(
            cfg, "params",
            suppress_payload=("secagg_pairwise_masking"
                              if cfg.secagg == "pairwise" else None))
        wl = silo_workload(cfg, data, self.device)
        init, make_train_fn = _silo_training_setup(
            cfg, data, wl, self.device, init_params, perf=perf)
        n_silos = min(cfg.client_num_per_round, data.client_num)
        make_train_fn = adversary_train_fns(cfg, data, make_train_fn,
                                            n_silos)
        spine = None
        if cfg.model_shards > 0:
            spine = build_shard_spine(
                init, num_shards=cfg.model_shards, norm_clip=cfg.norm_clip,
                noise_std=cfg.agg_noise_std, seed=cfg.seed,
                fused=cfg.fused_finalize,
                max_num_samples=cfg.max_num_samples,
                norm_k=cfg.norm_screen_k, norm_window=cfg.norm_screen_window,
                norm_min_history=cfg.norm_screen_min_history,
                trust=_trust_tracker(cfg),
                sentry=perf.sentry if perf is not None else None,
                device_obs=perf.device if perf is not None else None)
            admission, defended, stream = None, None, spine.agg
        else:
            admission, defended, stream = _robust_setup(cfg, init,
                                                        perf=perf)
        self.secagg = None
        make_silo_secagg = lambda g: None  # noqa: E731
        make_edge_secagg = masked_admission = None
        if cfg.secagg != "off":
            (self.secagg, masked_admission, make_silo_secagg,
             make_edge_secagg) = secagg_setup(cfg, data, init, self.device)
            if cfg.secagg == "pairwise":
                # the ring fold replaces the stream and the stack
                admission = masked_admission()
                defended = stream = None
        n_edges = cfg.edge_aggregators
        if n_edges > 0:
            if not 1 <= n_edges <= n_silos:
                raise ValueError(f"--edge_aggregators {n_edges} must be in "
                                 f"1..{n_silos} (every edge needs a silo)")
            if cfg.wire_compression != "none" or cfg.error_feedback:
                raise ValueError(
                    "--wire_compression/--error_feedback are not wired "
                    "through the edge tier (the root would try to "
                    "decompress an edge's raw mean)")
            if cfg.dead_after_s > 0:
                raise ValueError(
                    "--dead_after_s: silo heartbeats terminate at their "
                    "edge; the root failure detector would declare every "
                    "edge dead")
            if admission is not None and admission.max_num_samples > 0:
                # the root sees each edge's block SUM as its num_samples:
                # scale the root's cap by the largest block (the edges'
                # own pipelines keep the per-silo cap)
                admission.max_num_samples *= -(-n_silos // n_edges)
        self.codec = (WireCodec(cfg, init, n_silos)
                      if cfg.wire_compression != "none" else None)
        self.server_opt = make_server_opt(
            cfg, init, plan=spine.plan if spine is not None else None,
            perf=perf)
        controller = make_controller(
            cfg, cohort=n_edges if n_edges > 0 else n_silos,
            epochs=cfg.epochs)
        # under the edge topology the root's cohort is the edge tier
        self.degrade = degrade_setup(cfg, n_edges if n_edges > 0
                                     else n_silos)
        # the trust ledger and the shard layout are checkpointed state: a
        # resumed server keeps strikes and quarantine sentences, and
        # refuses a checkpoint of another layout
        trust = (admission.trust if admission is not None
                 else spine.admission.trust if spine is not None else None)
        n_trust = n_edges if n_edges > 0 and admission is not None \
            else n_silos
        self.checkpointer = make_checkpointer(cfg)
        self.journal = make_journal(cfg)
        self.detector = None
        if cfg.dead_after_s > 0:
            self.detector = FailureDetector(
                suspect_after_s=cfg.suspect_after_s or cfg.dead_after_s / 2,
                dead_after_s=cfg.dead_after_s)
        extra_state = _compose_extra_state([
            ("ef", self.codec.ef_extra if self.codec is not None else None),
            ("trust", None if trust is None else
             (lambda: trust.state_dict(n_trust), trust.load_state_dict)),
            ("shard", None if spine is None else
             (spine.checkpoint_state, spine.restore_checkpoint_state)),
            ("server_opt", None if self.server_opt is None else
             (self.server_opt.state_dict,
              self.server_opt.load_state_dict)),
            ("adapt", None if controller is None else
             (controller.state_dict, controller.load_state_dict)),
            ("degrade", None if self.degrade is None else
             (self.degrade.state_dict, self.degrade.load_state_dict))])
        self.ingest = make_ingest(cfg, self.degrade, spine=spine, init=init,
                                  device=self.device, perf=perf)
        self._eval_cohort = cohort_eval(make_evaluator(wl))
        self._freq = (max(cfg.comm_round, 1) if cfg.ci
                      else cfg.frequency_of_the_test)
        self.history: list = []
        self.round_times: list = []
        self._t0 = time.perf_counter()
        timeout = cfg.round_timeout_s or None
        # serve-while-train: only the server node holds the global
        self.serving = None
        if cfg.serve_port > 0 and (cfg.silo_backend == "local"
                                   or cfg.node_id == 0):
            self.serving = ServeWhileTrain(cfg, data, self.device,
                                           self._eval_cohort, slo=self.slo,
                                           health=health)

        def make_server(transport):
            return FedAvgServerActor(
                transport, init, data.client_num,
                n_edges if n_edges > 0 else n_silos, cfg.comm_round,
                on_round_done=self._on_round_done,
                straggler_policy=cfg.straggler_policy,
                round_timeout_s=timeout,
                min_silo_frac=cfg.min_silo_frac, admission=admission,
                stream_agg=stream, shard_wire=spine, aggregate_fn=defended,
                failure_detector=self.detector,
                checkpointer=self.checkpointer, extra_state=extra_state,
                journal=self.journal, faultline=faultline,
                secagg=self.secagg, server_opt=self.server_opt,
                degrade=self.degrade, ingest=self.ingest,
                decode_upload=(self.codec.decode if self.codec is not None
                               else None),
                perf=perf, health=health, controller=controller,
                publish=(self.serving.publish if self.serving is not None
                         else None))

        def make_silo(node_id, transport, g, server_id=0, heartbeat=None):
            codec = self.codec
            return FedAvgClientActor(
                node_id, transport, make_train_fn(g), server_id=server_id,
                heartbeat_interval_s=heartbeat,
                secagg=make_silo_secagg(node_id),
                encode_upload=codec.encode(g) if codec is not None else None,
                on_accepted=codec.on_accepted(g) if codec is not None
                else None)

        self.hub = None
        self.chaos_plan = None
        self.server = None
        self.silos: list = []
        self.edges: list = []
        if cfg.silo_backend == "grpc":
            self.drive = "grpc"
            transport = grpc_transport(cfg, n_silos, self.degrade)
            if cfg.node_id == 0:
                self.server = make_server(transport)
            else:
                self.silos = [make_silo(cfg.node_id, transport, cfg.node_id,
                                        heartbeat=cfg.heartbeat_s or None)]
            return
        if transport_factory is None:
            from fedml_tpu_torch.comm.local import LocalHub
            self.hub = LocalHub(codec_roundtrip=True)
            transport_factory = self.hub.transport
        wrap = lambda t: t  # noqa: E731
        if chaos_on(cfg):
            from fedml_tpu_torch.comm.chaos import ChaosTransport
            self.chaos_plan = make_chaos_plan(cfg)
            wrap = lambda t: ChaosTransport(t, self.chaos_plan)  # noqa: E731
        # chaos delivers delayed and reordered frames on wall-clock
        # timers, which the pump cannot wait for; a wire transport has
        # its own receive loop
        self.drive = ("threaded" if self.chaos_plan is not None
                      or self.hub is None else "pump")
        threaded = self.drive == "threaded"
        self.server = make_server(wrap(transport_factory(0)))
        edge_of: Dict[int, int] = {}
        if n_edges > 0:
            self.edges = self._build_edges(
                cfg, data, init, n_silos, n_edges, admission,
                masked_admission, make_edge_secagg, timeout,
                lambda e: wrap(transport_factory(e)), edge_of,
                health is not None)
        self.silos = [make_silo(
            n_edges + g, wrap(transport_factory(n_edges + g)), g,
            server_id=edge_of.get(g, 0),
            heartbeat=(cfg.heartbeat_s or None) if threaded else None)
            for g in range(1, n_silos + 1)]
        if not threaded:
            for actor in [self.server] + self.edges + self.silos:
                actor.register_handlers()

    @staticmethod
    def _build_edges(cfg, data, init, n_silos, n_edges, admission,
                     masked_admission, make_edge_secagg, timeout,
                     transport_of, edge_of, health: bool = False):
        """The edge tier: E edges over ``array_split`` blocks of the
        cohort; each screens its silos with its own pipeline (masked
        under grouped SecAgg) and folds a plain clipped mean (the robust
        rule and the noise run once, at the root).  ``health``: each edge
        gets a statistics-only accumulator whose rollup rides its frame
        to the root's observatory."""
        from fedml_tpu_torch.obs import HealthAccumulator
        from fedml_tpu_torch.algorithms.hierarchical import (
            EdgeAggregatorActor)
        from fedml_tpu_torch.core.pytree import nest, to_host
        from fedml_tpu_torch.core.stream_agg import StreamingAggregator
        from fedml_tpu_torch.robust import AdmissionPipeline
        edges = []
        blocks = np.array_split(np.arange(1, n_silos + 1), n_edges)
        for e, block in enumerate(blocks, start=1):
            edge_admission = None
            if make_edge_secagg is not None:
                edge_admission = masked_admission()
            elif admission is not None:
                edge_admission = AdmissionPipeline(
                    to_host(nest(init)), kind="params",
                    max_num_samples=cfg.max_num_samples,
                    norm_k=cfg.norm_screen_k,
                    norm_window=cfg.norm_screen_window,
                    norm_min_history=cfg.norm_screen_min_history,
                    trust=_trust_tracker(cfg))
            # the edge flushes its partial fold before the root's timer
            # fires: half the root timeout, a quarter for a masked edge
            # (up to three timed stages)
            edge_timeout = None
            if timeout:
                edge_timeout = (timeout / 4 if make_edge_secagg is not None
                                else timeout / 2)
            edge_health = None
            if health:
                # under grouped masking the edge sees only ciphertext:
                # its payload statistics are suppressed by name
                edge_health = HealthAccumulator(
                    kind="params", node=f"edge{e}", alarms=False,
                    suppress_payload=("secagg_grouped_masking"
                                      if make_edge_secagg is not None
                                      else None))
            edges.append(EdgeAggregatorActor(
                e, transport_of(e),
                {n_edges + int(g): int(g) for g in block},
                cohort_total=n_silos, client_num_in_total=data.client_num,
                stream_agg=(None if make_edge_secagg is not None
                            else StreamingAggregator(
                                init, method="mean", kind="params",
                                norm_clip=cfg.norm_clip, seed=cfg.seed)),
                admission=edge_admission,
                secagg=(make_edge_secagg(f"edge{e}")
                        if make_edge_secagg is not None else None),
                journal=make_journal(cfg, subdir=f"edge{e}"),
                timeout_s=edge_timeout, health=edge_health))
            for g in block:
                edge_of[int(g)] = e
        return edges

    @property
    def wire_stats(self) -> Dict[str, int]:
        """Compressed and decoded bytes the server received."""
        if self.codec is None:
            return {"bytes": 0, "raw_bytes": 0}
        return {"bytes": self.codec.wire_bytes,
                "raw_bytes": self.codec.raw_bytes}

    def _on_round_done(self, r, params):
        from fedml_tpu_torch.algorithms.fedavg import evaluate_global
        synchronize(self.device)
        self.round_times.append(time.perf_counter() - self._t0)
        if self.slo is not None:
            self.slo.evaluate()   # rolling: gauges update, breaches count
        if r % self._freq == 0 or r == self.cfg.comm_round - 1:
            stats = evaluate_global(self._eval_cohort, self.data, params,
                                    self.cfg.eval_chunk_clients, self.device)
            stats.update(round=r, round_s=self.round_times[-1])
            if self.codec is not None:
                # compressed bytes received since the last eval round
                stats["upload_bytes"] = self.codec.wire_bytes
            logger.info("round %d: %s", r, stats)
            self.history.append(stats)
            self.sink.log(stats, step=r)
        self._t0 = time.perf_counter()   # evaluation is not round time

    def _run_threaded(self, join_timeout_s: float = 30.0) -> None:
        import threading
        actors = self.edges + self.silos
        threads = [threading.Thread(target=a.run, daemon=True,
                                    name=f"node-{a.node_id}")
                   for a in actors]
        for th in threads:
            th.start()
        try:
            for edge in self.edges:
                edge.resume()
            self.server.register_handlers()
            self.server.start()
            self.server.transport.run()  # until the last round's FINISH
        finally:
            for th in threads:
                th.join(timeout=join_timeout_s)
            for actor in actors:
                actor.finish()   # idempotent: stragglers past FINISH
            for th in threads:
                th.join(timeout=5)

    def run(self) -> Dict[str, Any]:
        """Drive the federation to its end; the last evaluation, the
        steady round rate (rounds after the first) and whether the global
        is finite.  A gRPC silo node runs until FINISH and returns {}."""
        server = self.server
        if server is None:
            self.silos[0].run()
            return {}
        try:
            self._t0 = time.perf_counter()
            if self.drive == "pump":
                for edge in self.edges:
                    # a journaled edge left mid-round resumes its block
                    edge.resume()
                server.start()
                self.hub.pump(idle_hook=(self.ingest.drain
                                         if self.ingest is not None
                                         else None))
            elif self.drive == "threaded":
                self._run_threaded()
            else:
                server.register_handlers()
                server.start()
                server.transport.run()
        finally:
            server.finish()   # idempotent; joins the straggler timer
            if self.checkpointer is not None:
                self.checkpointer.close()
            if self.perf is not None:
                self.perf.close()   # join the RSS sampler thread
            if self.serving is not None:
                # drain on shutdown: training's end never drops traffic
                self.serving.stop()
        if server.round_idx < self.cfg.comm_round and not server.aborted:
            raise RuntimeError(f"the federation stalled at round "
                               f"{server.round_idx} of {self.cfg.comm_round}")
        steady = self.round_times[1:] or self.round_times
        out = dict(self.history[-1]) if self.history else {}
        out["rounds_per_s"] = len(steady) / sum(steady) if steady else 0.0
        out["round_ms"] = 1e3 * sum(steady) / len(steady) if steady else 0.0
        out.update(_spread("round_ms", [1e3 * t for t in steady]))
        out["params_finite"] = all(bool(v.isfinite().all())
                                   for v in server.params.values())
        from fedml_tpu_torch.parallel.mesh import params_sha256
        out["params_sha256"] = params_sha256(server.params)
        if self.cfg.mesh_stages > 0:
            out["stage_devices"] = ",".join(
                str(d) for d in pp_stages(self.cfg, self.device))
        return out


@runner("cross_silo")
def run_cross_silo(cfg, data, sink):
    return CrossSiloFederation(cfg, data, sink).run()


class AsyncFederation:
    """FedBuff-style asynchronous federation (`algorithms.async_fl`) on
    the local hub, pump-driven: no barrier, the server applies every
    ``--async_goal`` uploads (default ``n_silos // 2``) as one version
    with ``(1+staleness)^-alpha`` discounts and re-tasks the consumed
    silos; ``--comm_round`` counts versions.  The silos upload deltas
    (`async_fl.delta_encoder`); admission screens them as
    ``kind="delta"``.  The trust ledger, the server optimizer and the
    reliability tracker ride the version checkpoint; ``--journal``
    resumes a version left mid-flight; ``--perf``/``--health``/``--slo``
    instrument the versions.  ``init_params`` replaces the seeded init;
    ``faultline`` arms the server's crash points.

    Built, then ``run()``; ``server.params`` is the global."""

    def __init__(self, cfg, data, sink, init_params=None, faultline=None):
        from fedml_tpu_torch.algorithms.async_fl import (AsyncFedServerActor,
                                                         delta_encoder)
        from fedml_tpu_torch.algorithms.cross_silo import FedAvgClientActor
        from fedml_tpu_torch.comm.local import LocalHub
        from fedml_tpu_torch.parallel.cohort import cohort_eval
        from fedml_tpu_torch.trainer.local_sgd import make_evaluator

        if cfg.wire_compression != "none" or cfg.error_feedback:
            raise ValueError(
                "--wire_compression/--error_feedback are not wired into "
                "--algo async_fl yet (the async server consumes raw "
                "deltas); running on would silently send uncompressed "
                "uploads")
        if cfg.silo_backend != "local":
            raise ValueError(
                "--algo async_fl currently deploys over the local hub only; "
                f"--silo_backend {cfg.silo_backend!r} would silently be "
                "ignored (the actors are transport-agnostic — the gRPC "
                "wiring mirrors cross_silo's when needed)")
        self.cfg, self.data, self.sink = cfg, data, sink
        self.device = resolve_device(cfg.platform)
        self.perf = perf = make_perf(cfg, self.device)
        self.slo = make_slo(cfg)
        # async deltas ARE the updates: health reads them raw
        health = make_health(cfg, "delta")
        wl = _make_workload(cfg, data)
        init, make_train_fn = _silo_training_setup(
            cfg, data, wl, self.device, init_params, perf=perf)
        n_silos = min(cfg.client_num_per_round, data.client_num)
        goal = cfg.async_goal or max(1, n_silos // 2)
        make_train_fn = adversary_train_fns(cfg, data, make_train_fn,
                                            n_silos)
        if cfg.edge_aggregators > 0:
            raise ValueError("--edge_aggregators is a cross_silo (sync "
                             "barrier) topology; the async server consumes "
                             "per-silo deltas directly")
        admission, defended, stream = _robust_setup(cfg, init, kind="delta",
                                                    perf=perf)
        self.server_opt = make_server_opt(cfg, init, perf=perf)
        self.degrade = degrade_setup(cfg, n_silos, mode="async")
        extra_state = _compose_extra_state([
            ("trust", None if admission is None else
             (lambda: admission.trust.state_dict(n_silos),
              admission.trust.load_state_dict)),
            ("srv_opt", None if self.server_opt is None else
             (self.server_opt.state_dict, self.server_opt.load_state_dict)),
            ("degrade", None if self.degrade is None else
             (self.degrade.state_dict, self.degrade.load_state_dict))])
        # one fold worker, no arena: async uploads are deltas screened on
        # the host
        self.ingest = make_ingest(cfg, self.degrade)
        self.checkpointer = make_checkpointer(cfg)
        self.journal = make_journal(cfg)
        self._eval_cohort = cohort_eval(make_evaluator(wl))
        self.history: list = []
        self.version_times: list = []
        self.hub = LocalHub(codec_roundtrip=True)
        self.server = AsyncFedServerActor(
            self.hub.transport(0), init, data.client_num, n_silos,
            num_versions=cfg.comm_round, aggregation_goal=goal,
            staleness_exponent=cfg.staleness_exponent,
            server_lr=cfg.async_server_lr, on_version=self._on_version,
            seed=cfg.seed, checkpointer=self.checkpointer,
            retask_timeout_s=cfg.retask_timeout_s or None,
            admission=admission, defended_aggregate=defended,
            stream_agg=stream, extra_state=extra_state,
            journal=self.journal, faultline=faultline,
            server_opt=self.server_opt, degrade=self.degrade,
            ingest=self.ingest, perf=perf, health=health)
        self.silos = [FedAvgClientActor(i, self.hub.transport(i),
                                        make_train_fn(i),
                                        encode_upload=delta_encoder)
                      for i in range(1, n_silos + 1)]
        for actor in [self.server] + self.silos:
            actor.register_handlers()

    def _on_version(self, version, params):
        from fedml_tpu_torch.algorithms.fedavg import evaluate_global
        synchronize(self.device)
        self.version_times.append(time.perf_counter() - self._t0)
        if self.slo is not None:
            self.slo.evaluate()   # rolling: gauges update, breaches count
        cfg = self.cfg
        if version % cfg.frequency_of_the_test == 0 \
                or version == cfg.comm_round:
            stats = evaluate_global(self._eval_cohort, self.data, params,
                                    cfg.eval_chunk_clients, self.device)
            stats["version"] = version
            logger.info("version %d: %s", version, stats)
            self.history.append(stats)
            self.sink.log(stats, step=version)
        self._t0 = time.perf_counter()   # evaluation is not version time

    def run(self) -> Dict[str, Any]:
        """Pump the federation to its last version; the last evaluation,
        the mean staleness, the steady version rate and whether the
        global is finite."""
        server = self.server
        try:
            self._t0 = time.perf_counter()
            server.start()
            self.hub.pump(idle_hook=(self.ingest.drain
                                     if self.ingest is not None else None))
            # every silo quarantined finishes the federation early
            stalled = not server._finished
        finally:
            server.finish()
            if self.checkpointer is not None:
                self.checkpointer.close()
            if self.perf is not None:
                self.perf.close()   # join the RSS sampler thread
        if stalled and server.version < self.cfg.comm_round:
            raise RuntimeError(f"the federation stalled at version "
                               f"{server.version} of {self.cfg.comm_round}")
        out = dict(self.history[-1]) if self.history else {}
        if server.staleness_seen:
            out["mean_staleness"] = float(np.mean(server.staleness_seen))
        steady = self.version_times[1:] or self.version_times
        out["versions_per_s"] = len(steady) / sum(steady) if steady else 0.0
        out["params_finite"] = all(bool(v.isfinite().all())
                                   for v in server.params.values())
        from fedml_tpu_torch.parallel.mesh import params_sha256
        out["params_sha256"] = params_sha256(server.params)
        return out


@runner("async_fl")
def run_async_fl(cfg, data, sink):
    return AsyncFederation(cfg, data, sink).run()


def hierarchical_algo(cfg: ExperimentConfig, data, sink=None, mesh=None):
    """The runner's `HierarchicalFedAvg`: ``--group_num`` groups of
    ``--group_comm_round`` rounds a global round."""
    from fedml_tpu_torch.algorithms.hierarchical import (HierarchicalConfig,
                                                         HierarchicalFedAvg)
    return HierarchicalFedAvg(
        _make_workload(cfg, data), data, HierarchicalConfig(
            group_num=cfg.group_num, group_comm_round=cfg.group_comm_round,
            **_fedavg_cfg_kwargs(cfg)),
        mesh=mesh, sink=sink, device=cfg.platform)


@runner("hierarchical")
def run_hierarchical(cfg, data, sink, mesh=None):
    return _run_with_checkpoints(cfg, hierarchical_algo(cfg, data, sink,
                                                        mesh))


# ---------------------------------------------------------------------------
# the decentralized, split and vertical runners
# ---------------------------------------------------------------------------

def decentralized_algo(cfg: ExperimentConfig, data, mesh=None):
    """The runner's `DecentralizedGossip` for ``cfg``."""
    from fedml_tpu_torch.algorithms.decentralized import (
        DecentralizedConfig, DecentralizedGossip)
    return DecentralizedGossip(_make_workload(cfg, data), data,
                               DecentralizedConfig(
        comm_round=cfg.comm_round, epochs=cfg.epochs,
        batch_size=cfg.batch_size, lr=cfg.lr,
        client_optimizer=cfg.client_optimizer, wd=cfg.wd,
        neighbor_num=cfg.neighbor_num,
        frequency_of_the_test=cfg.frequency_of_the_test, seed=cfg.seed),
        mesh=mesh, device=cfg.platform)


@runner("decentralized")
def run_decentralized(cfg, data, sink, mesh=None):
    """Gossip over the symmetric ``--neighbor_num`` topology: every node
    trains each round, then the mix; ``--mesh_clients`` N runs one node a
    rank over the ring (N = the clients)."""
    algo = decentralized_algo(cfg, data, mesh)
    stacked = algo.run()
    for h in algo.history:
        sink.log(h, step=h.get("round"))
    return _summary(algo, stacked)


def online_setup(cfg: ExperimentConfig):
    """The runner's (stream, `DecentralizedOnlineConfig`): the UCI files
    under ``--data_dir`` (``--dataset SUSY|RO``) or the synthetic stream,
    over at most 128 nodes of ``--iteration_number`` samples each."""
    import os
    from fedml_tpu_torch.algorithms.decentralized_online import (
        DecentralizedOnlineConfig)
    from fedml_tpu_torch.data.uci import load_streaming_uci, synthetic_stream
    n = min(cfg.client_num_in_total, 128)
    total = cfg.iteration_number * n
    if cfg.data_dir and cfg.dataset.upper() in ("SUSY", "RO"):
        path = cfg.data_dir if os.path.isfile(cfg.data_dir) else os.path.join(
            cfg.data_dir, "SUSY.csv" if cfg.dataset.upper() == "SUSY"
            else "datatraining.txt")
        stream = load_streaming_uci(cfg.dataset, path, list(range(n)),
                                    total, cfg.beta, seed=cfg.seed)
    else:
        stream = synthetic_stream(num_clients=n, total=total,
                                  beta=cfg.beta, seed=cfg.seed)
    return stream, DecentralizedOnlineConfig(
        mode=cfg.mode, iteration_number=cfg.iteration_number,
        epochs=cfg.epochs, learning_rate=cfg.lr, weight_decay=cfg.wd,
        b_symmetric=cfg.b_symmetric,
        topology_neighbors_num_undirected=(
            cfg.topology_neighbors_num_undirected),
        topology_neighbors_num_directed=cfg.topology_neighbors_num_directed,
        time_varying=cfg.time_varying, seed=cfg.seed)


@runner("decentralized_online")
def run_decentralized_online(cfg, data, sink):
    """DSGD / PushSum online learning on a stream (`online_setup`)."""
    from fedml_tpu_torch.algorithms.decentralized_online import (
        run_decentralized_online as run_dol)
    stream, config = online_setup(cfg)
    t0 = time.perf_counter()
    out = run_dol(stream, config, device=cfg.platform)
    seconds = time.perf_counter() - t0
    for h in out["history"][:: max(len(out["history"]) // 50, 1)]:
        sink.log(h, step=h["iteration"])
    return {"final_regret": out["final_regret"],
            "accuracy": out["accuracy"],
            "steps_per_s": len(out["losses"]) / seconds}


def fedgkt_algo(cfg: ExperimentConfig, data):
    """The runner's (`FedGKT`, cohort): the ResNet-8 client nets and the
    18-block server net (GroupNorm) on the first
    ``--client_num_per_round`` clients."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKT, FedGKTConfig
    from fedml_tpu_torch.models.resnet_gkt import (GKTClientResNet,
                                                   GKTServerResNet)
    shape = _image_sample_shape(cfg, data, "fedgkt")
    client = GKTClientResNet(num_classes=data.class_num,
                             in_channels=shape[-1])
    server = GKTServerResNet(num_classes=data.class_num)
    algo = FedGKT(client, server, FedGKTConfig(
        rounds=cfg.comm_round, epochs_client=cfg.epochs,
        temperature=cfg.temperature, seed=cfg.seed), device=cfg.platform)
    return algo, _first_cohort(data, cfg.client_num_per_round)


@runner("fedgkt")
def run_fedgkt(cfg, data, sink):
    algo, cohort = fedgkt_algo(cfg, data)
    out = algo.run(cohort)
    for h in out["history"]:
        sink.log(h, step=h["round"])
    ev = algo.evaluate(out["client_params"], out["server_params"], cohort)
    sink.log(ev, step=cfg.comm_round - 1)
    return ev


class SplitBody(torch.nn.Module):
    """The split_nn runner's client half: flatten, Dense(64), ReLU."""

    def __init__(self, input_dim: int):
        super().__init__()
        from fedml_tpu_torch.models.layers import Dense
        self.Dense_0 = Dense(input_dim, 64)

    def forward(self, x):
        return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class SplitHead(torch.nn.Module):
    """The split_nn runner's server half: Dense(classes)."""

    def __init__(self, classes: int):
        super().__init__()
        from fedml_tpu_torch.models.layers import Dense
        self.Dense_0 = Dense(64, classes)

    def forward(self, x):
        return self.Dense_0(x)


def split_nn_sim(cfg: ExperimentConfig, data):
    """The runner's (`SplitNNSimulator`, client data): the first
    ``--client_num_per_round`` clients, round robin, ``--comm_round``
    sweeps of ``--epochs`` a client."""
    from fedml_tpu_torch.algorithms.split_nn import (SplitModel,
                                                     SplitNNConfig,
                                                     SplitNNSimulator)
    split = SplitModel(SplitBody(int(np.prod(sample_shape_of(data)))),
                       SplitHead(data.class_num))
    sim = SplitNNSimulator(split, SplitNNConfig(
        epochs_per_client=cfg.epochs, rounds=cfg.comm_round,
        client_lr=cfg.lr, server_lr=cfg.lr), device=cfg.platform)
    n = min(cfg.client_num_per_round, data.client_num)
    return sim, [{k: data.train[k][c] for k in ("x", "y", "mask")}
                 for c in range(n)]


@runner("split_nn")
def run_split_nn(cfg, data, sink):
    sim, client_data = split_nn_sim(cfg, data)
    out = sim.run(client_data, cfg.seed)
    for h in out["history"]:
        sink.log(h, step=h.get("sweep", 0))
    return out["history"][-1] if out["history"] else {}


def vfl_setup(cfg: ExperimentConfig):
    """The runner's (`VerticalFL`, train, test): two parties of the
    synthetic VFL twin (features split, not clients)."""
    from fedml_tpu_torch.algorithms.vertical_fl import VerticalFL, VFLConfig
    from fedml_tpu_torch.data.tabular import synthetic_vfl_parties
    from fedml_tpu_torch.models.vfl import VFLPartyNet
    train, test = synthetic_vfl_parties(
        n_samples=max(cfg.batch_size * 4, 256), seed=cfg.seed)
    models = [VFLPartyNet(x.shape[1], hidden_dim=16) for x in train[:-1]]
    return VerticalFL(models, VFLConfig(
        rounds=cfg.comm_round, batch_size=cfg.batch_size, lr=cfg.lr,
        frequency_of_the_test=cfg.frequency_of_the_test),
        device=cfg.platform), train, test


@runner("vfl")
def run_vfl(cfg, data, sink):
    vfl, train, test = vfl_setup(cfg)
    out = vfl.fit(train, test, cfg.seed)
    for h in out["history"]:
        sink.log(h, step=h.get("round"))
    return out["history"][-1] if out["history"] else {}


def check_obs(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the observability flags (JAX
    ``main.py:2398-2493``): every flag that would parse and then record
    or steer nothing fails with its reason."""
    from fedml_tpu_torch.server_opt import ServerOptConfigError
    if cfg.metrics_port > 0 and cfg.prom_port > 0 \
            and cfg.metrics_port != cfg.prom_port:
        raise ValueError(
            f"--metrics_port is an alias for --prom_port; got both, "
            f"disagreeing ({cfg.metrics_port} vs {cfg.prom_port}) — "
            f"pass one, or the same port for both.")
    # the flight recorder and the SLO evaluator hook the live round
    # lifecycle; on the cohort simulations they would record nothing
    if cfg.algo not in ("cross_silo", "async_fl", "cross_device") and (
            cfg.perf or cfg.perf_ledger or cfg.perf_strict or cfg.slo
            or cfg.device_obs or cfg.health or cfg.health_ledger):
        raise ValueError(
            f"--perf/--perf_ledger/--perf_strict/--device_obs/--slo/"
            f"--health/--health_ledger instrument the live round "
            f"lifecycle and apply to --algo cross_silo/async_fl/"
            f"cross_device only; --algo {cfg.algo} would silently write "
            f"no ledger and never evaluate the objectives.")
    if cfg.slo:
        from fedml_tpu_torch.obs.perf import parse_slo_spec
        parse_slo_spec(cfg.slo)   # a typo'd objective fails here
    if cfg.adaptive:
        if not (cfg.health or cfg.health_ledger):
            raise ServerOptConfigError(
                "--adaptive steers pacing from the health observatory's "
                "drift alarms and requires --health (or "
                "--health_ledger); without it every decision would be "
                "a vacuous hold and the run would be labeled adaptive")
        if cfg.algo not in ("cross_silo", "cross_device"):
            raise ServerOptConfigError(
                f"--adaptive steers the per-round cohort sampler and "
                f"applies to --algo cross_silo/cross_device only; "
                f"--algo {cfg.algo} has no round cohort to pace")
    if cfg.adapt_min_cohort < 1:
        raise ServerOptConfigError(
            f"--adapt_min_cohort must be >= 1, got {cfg.adapt_min_cohort}")
    if cfg.adapt_patience < 1:
        raise ServerOptConfigError(
            f"--adapt_patience must be >= 1, got {cfg.adapt_patience}")


def check_cross_silo(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the live-path flags (JAX
    ``main.py:2083-2420``)."""
    if cfg.mesh_stages > 0 and cfg.algo != "cross_silo":
        raise ValueError(
            "--mesh_stages is silo-local pipeline parallelism: each silo "
            "runs its own [stages] mesh, so it only applies to --algo "
            "cross_silo (the vmapped cohort engine cannot nest a shard_map "
            f"pipeline per client); got --algo {cfg.algo}")
    if cfg.pp_microbatches and not cfg.mesh_stages:
        raise ValueError("--pp_microbatches tunes the GPipe schedule and "
                         "needs --mesh_stages; alone it would be silently "
                         "ignored")
    if cfg.mesh_stages > 0 and (cfg.attn_block_size or cfg.attn_flash):
        raise ValueError(
            "--attn_block_size/--attn_flash are TransformerLM attention "
            "backends; the pipelined PipelineLM (--mesh_stages) runs dense "
            "block attention and would silently drop them")
    if cfg.silo_backend not in ("local", "grpc"):
        raise ValueError(f"unknown silo_backend {cfg.silo_backend!r}; "
                         f"available: ('local', 'grpc')")
    if cfg.wire_compression != "none" and cfg.algo != "cross_silo":
        raise ValueError("--wire_compression only applies to "
                         "--algo cross_silo (the host-edge wire)")
    if cfg.error_feedback and cfg.wire_compression == "none":
        raise ValueError("--error_feedback requires --wire_compression "
                         "topk or int8")
    check_ingest(cfg)
    check_secagg(cfg)
    check_server_opt(cfg)
    if cfg.wave_adversary and cfg.algo != "cross_device":
        raise ValueError(
            f"--wave_adversary poisons compiled wave SUMMARIES and "
            f"applies to --algo cross_device only; --algo {cfg.algo} "
            f"would silently train clean while the run is labeled "
            f"poisoned.  Per-silo attacks on the actor path use "
            f"--adversary.")
    if chaos_on(cfg):
        if cfg.algo != "cross_silo":
            raise ValueError(
                f"--chaos_* injection is wired into --algo cross_silo only; "
                f"--algo {cfg.algo} would silently run a CLEAN network and "
                f"label the results as chaos results")
        if cfg.silo_backend != "local":
            raise ValueError("--chaos_* injection wraps the local hub only; "
                             "for real wires compose ChaosTransport in code")
        if cfg.chaos_drop > 0 and (cfg.straggler_policy == "wait"
                                   or not cfg.round_timeout_s):
            raise ValueError(
                "--chaos_drop with the strict 'wait' barrier (or no "
                "--round_timeout_s) would wedge the federation on "
                "the first lost upload; use --straggler_policy drop "
                "--round_timeout_s T")
    if cfg.journal or cfg.journal_dir:
        # the journal snapshots the STREAMING fold state: on a stack-mode
        # (or non-live) run the flag would journal nothing
        if cfg.algo not in ("cross_silo", "async_fl"):
            raise ValueError(
                f"--journal is mid-round crash consistency for the live "
                f"actor modes and applies to --algo cross_silo/async_fl "
                f"only; --algo {cfg.algo} would silently journal nothing "
                f"and label the run as crash-consistent.")
        if cfg.agg_mode != "stream" and cfg.secagg == "off":
            raise ValueError(
                "--journal rides the streaming-fold receive path: pass "
                "--agg_mode stream (the stack path has no incremental "
                "fold state to snapshot).  Secagg rounds journal "
                "abort-only.")
    if cfg.journal_snapshot_every < 1:
        raise ValueError(f"--journal_snapshot_every must be >= 1, got "
                         f"{cfg.journal_snapshot_every}")
    check_serve(cfg)
    from fedml_tpu_torch.robust.defense import ROBUST_AGG_METHODS
    if cfg.robust_agg not in ROBUST_AGG_METHODS:
        raise ValueError(f"--robust_agg must be one of {ROBUST_AGG_METHODS}, "
                         f"got {cfg.robust_agg!r}")
    if cfg.algo not in ("cross_silo", "async_fl", "cross_device") and (
            cfg.robust_agg != "mean" or cfg.norm_clip or cfg.agg_noise_std
            or cfg.adversary or cfg.admission == "on"):
        raise ValueError(
            f"--robust_agg/--norm_clip/--agg_noise_std/--adversary/"
            f"--admission on are the live distributed defense (robust/) "
            f"and apply to --algo cross_silo/async_fl only; got --algo "
            f"{cfg.algo}.  For the single-device cohort simulation use "
            f"--algo fedavg_robust --defense ... instead.")
    if cfg.stream_reservoir < 1:
        raise ValueError(f"--stream_reservoir must be >= 1, got "
                         f"{cfg.stream_reservoir}")
    if cfg.admission not in ("auto", "on", "off"):
        raise ValueError(f"--admission must be auto|on|off, "
                         f"got {cfg.admission!r}")
    from fedml_tpu_torch.core.stream_agg import STREAM_MODES
    if cfg.agg_mode not in STREAM_MODES:
        raise ValueError(f"--agg_mode must be one of {STREAM_MODES}, "
                         f"got {cfg.agg_mode!r}")
    if cfg.model_shards < 0:
        raise ValueError(f"--model_shards must be >= 0, got "
                         f"{cfg.model_shards}")
    if cfg.fused_finalize not in ("auto", "on", "off"):
        raise ValueError(f"--fused_finalize must be auto|on|off, got "
                         f"{cfg.fused_finalize!r}")
    if cfg.fused_finalize != "auto" and cfg.model_shards < 1:
        raise ValueError(
            "--fused_finalize selects the SHARD finalize backend and needs "
            "--model_shards >= 1; alone it would be silently ignored")
    if cfg.model_shards > 0:
        if cfg.algo != "cross_silo":
            raise ValueError(
                f"--model_shards is the sharded cross-silo spine and applies "
                f"to --algo cross_silo only; --algo {cfg.algo} would "
                f"silently run whole-model")
        if cfg.agg_mode != "stream":
            raise ValueError(
                "--model_shards shards the STREAMING fold state — pass "
                "--agg_mode stream")
        if cfg.robust_agg != "mean":
            raise ValueError(
                f"--model_shards with --robust_agg {cfg.robust_agg}: "
                f"order-statistic rules need the per-upload population, "
                f"which the sharded fold never materializes; for robust "
                f"rules use the replicated --agg_mode stream "
                f"--stream_reservoir K")
        if cfg.secagg != "off":
            raise ValueError(
                "--model_shards and --secagg are mutually exclusive: a "
                "pairwise-masked uint32 ring word cannot be re-sliced per "
                "shard without breaking mask cancellation")
        if cfg.edge_aggregators > 0:
            raise ValueError(
                "--model_shards and --edge_aggregators are mutually "
                "exclusive for now: an edge folds and ships whole-model "
                "means, which would defeat the per-shard wire (shard "
                "the flat topology, or keep edges replicated)")
        if cfg.wire_compression != "none" or cfg.error_feedback:
            raise ValueError(
                "--model_shards and --wire_compression/--error_feedback "
                "are mutually exclusive: the delta codec reconstructs "
                "against the whole global, not a shard slice")
        if cfg.admission == "off":
            raise ValueError(
                "--model_shards requires the admission screens: the "
                "per-shard structural fingerprint IS the wire protocol")
        if cfg.silo_backend != "local":
            raise ValueError(
                "--model_shards deploys over the local hub only for "
                "now (the actors are transport-agnostic; gRPC wiring "
                "mirrors the flat one)")


def check_serve(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the serve and release flags: a flag
    that would parse and then serve or gate nothing fails."""
    if cfg.serve_port > 0 and cfg.algo != "cross_silo":
        raise ValueError(
            "--serve_port starts the serve-while-train frontend, which is "
            f"wired into --algo cross_silo only; --algo {cfg.algo} would "
            "silently train without serving.  To serve a finished "
            "checkpoint directory, use serve.registry.CheckpointWatcher "
            "instead.")
    if cfg.serve_workers < 1:
        raise ValueError(f"--serve_workers must be >= 1, got "
                         f"{cfg.serve_workers}")
    if cfg.serve_workers > 1 and cfg.serve_port <= 0:
        raise ValueError(
            "--serve_workers scales the HTTP frontend and needs "
            "--serve_port; without one there is no frontend to scale "
            "and the flag would silently do nothing.")
    if not 0.0 < cfg.serve_best_effort_headroom <= 1.0:
        raise ValueError(
            f"--serve_best_effort_headroom must be in (0, 1], got "
            f"{cfg.serve_best_effort_headroom}")
    # the release gate gates the serve-while-train publish hook: without
    # a frontend the flag would train ungated under a canary label
    if cfg.release_gate and cfg.serve_port <= 0:
        raise ValueError(
            "--release_gate gates the serve-while-train publish hook "
            "(canary → shadow/health/eval verdict) and needs "
            "--serve_port; without a frontend there is no serving swap "
            "to gate and the flag would silently do nothing.")
    if cfg.release_gate and (cfg.release_shadow_every < 1
                             or cfg.release_shadow_slots < 1):
        raise ValueError(
            f"--release_shadow_every and --release_shadow_slots must be "
            f">= 1, got {cfg.release_shadow_every} and "
            f"{cfg.release_shadow_slots}")


def check_ingest(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on ``--ingest_pipeline``: every
    combination without a bit-parity pin is refused with its reason."""
    if cfg.ingest_queue_depth < 1:
        raise ValueError(f"--ingest_queue_depth must be >= 1, got "
                         f"{cfg.ingest_queue_depth}")
    if not cfg.ingest_pipeline:
        return
    if cfg.algo not in ("cross_silo", "async_fl", "cross_device"):
        raise ValueError(
            f"--ingest_pipeline pipelines the SERVER receive path "
            f"(cross_silo / async_fl) and the cross_device wave "
            f"loop; --algo {cfg.algo} has no ingest hot path and "
            f"would silently run inline")
    if cfg.wire_compression != "none":
        raise ValueError(
            "--ingest_pipeline x --wire_compression is unproven: "
            "the decompress + error-feedback settlement runs on the "
            "transport thread today, and no bit-parity pin covers "
            "decode-on-worker — drop one flag")
    if cfg.silo_backend != "local" and cfg.algo != "cross_device":
        raise ValueError(
            f"--ingest_pipeline x --silo_backend "
            f"{cfg.silo_backend!r} is unproven: the parity and "
            f"journal-recovery pins drive the local hub; the grpc "
            f"receive path needs its own soak before the pipeline "
            f"rides it")
    if cfg.edge_aggregators > 0:
        raise ValueError(
            "--ingest_pipeline x --edge_aggregators is unproven: "
            "edges fold on their own actors and no pin covers a "
            "pipelined edge tier — drop one flag")
    if chaos_on(cfg):
        raise ValueError(
            "--ingest_pipeline x --chaos_* is unproven: chaos "
            "switches the hub to the threaded drive and no parity "
            "pin covers wall-clock chaos timers racing the fold "
            "workers — drop one flag")
    if cfg.algo == "cross_silo" and cfg.agg_mode != "stream" \
            and cfg.secagg == "off":
        raise ValueError(
            "--ingest_pipeline pipelines the STREAMING fold "
            "(decode -> screen -> fold at arrival); --agg_mode "
            "stack banks uploads instead of folding them, so "
            "there is nothing to hide behind the network — use "
            "--agg_mode stream")


def check_secagg(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on ``--secagg``: a privacy flag that would
    be silently ignored fails here."""
    from fedml_tpu_torch.secure.protocol import SECAGG_MODES
    if cfg.secagg not in SECAGG_MODES:
        raise ValueError(f"--secagg must be off|pairwise|grouped, "
                         f"got {cfg.secagg!r}")
    if cfg.secagg == "off":
        return
    if cfg.algo != "cross_silo":
        raise ValueError(
            f"--secagg is the sync-barrier secure-aggregation protocol "
            f"and applies to --algo cross_silo only; --algo {cfg.algo} "
            f"(including async_fl, whose per-upload staleness discounts "
            f"need plaintext individual deltas) would silently train "
            f"unmasked and label the run as private")
    if cfg.wire_compression != "none" or cfg.error_feedback:
        raise ValueError(
            "--secagg and --wire_compression/--error_feedback are "
            "mutually exclusive: a compressed/EF payload cannot ride "
            "the uint32 masking ring (masks must cancel word-for-word)")
    if cfg.robust_agg != "mean":
        raise ValueError(
            f"--secagg hides individual uploads by construction, so "
            f"order-statistic rules (--robust_agg {cfg.robust_agg}) have no "
            f"population to rank; the defenses that compose are the "
            f"pre-mask structure/num_samples screens and the post-unmask "
            f"sum screen + --norm_clip/--agg_noise_std on the sum")
    if cfg.agg_mode != "stream":
        raise ValueError(
            "--secagg folds masked uploads in the uint32 ring at arrival — "
            "there is no stack path; pass --agg_mode stream")
    if cfg.silo_backend != "local":
        raise ValueError("--secagg deploys over the local hub only for now "
                         "(the actors are transport-agnostic; gRPC wiring "
                         "mirrors the flat one)")
    if cfg.secagg == "grouped" and cfg.edge_aggregators < 1:
        raise ValueError(
            "--secagg grouped scopes masking per edge block and needs "
            "--edge_aggregators E >= 1; for a single cohort-wide "
            "masking group use --secagg pairwise")
    if cfg.secagg == "pairwise" and cfg.edge_aggregators > 0:
        raise ValueError(
            "--secagg pairwise masks across the WHOLE cohort, which an "
            "edge cannot partially unmask (cross-block pair masks only "
            "cancel in the root's full sum); use --secagg grouped with "
            "--edge_aggregators")
    if cfg.secagg == "grouped" \
            and cfg.client_num_per_round < 2 * cfg.edge_aggregators:
        raise ValueError(
            f"--secagg grouped needs every edge block to hold >= 2 "
            f"silos (a 1-silo 'masked sum' IS that silo's update): "
            f"{cfg.client_num_per_round} silos over "
            f"{cfg.edge_aggregators} edges leaves a short block")
    if cfg.secagg == "pairwise" and cfg.client_num_per_round < 2:
        raise ValueError("--secagg pairwise needs >= 2 silos per round")
    if cfg.secagg_threshold == 1:
        raise ValueError(
            "--secagg_threshold 1 voids the privacy guarantee: one share "
            "reconstructs every seed; the minimum is 2 (0 = majority "
            "default)")
    # the threshold is a per-group share count
    group_min = (cfg.client_num_per_round if cfg.secagg == "pairwise"
                 else cfg.client_num_per_round // cfg.edge_aggregators)
    if cfg.secagg_threshold > group_min:
        raise ValueError(
            f"--secagg_threshold {cfg.secagg_threshold} exceeds the "
            f"smallest masking group ({group_min} silos"
            f"{' per edge block' if cfg.secagg == 'grouped' else ''}): "
            f"reconstruction could never gather that many shares")


def check_server_opt(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on ``--server_opt``."""
    from fedml_tpu_torch.server_opt import (SERVER_OPT_NAMES,
                                            ServerOptConfigError)
    if cfg.server_opt not in SERVER_OPT_NAMES:
        raise ServerOptConfigError(
            f"unknown --server_opt {cfg.server_opt!r}; available: "
            f"{list(SERVER_OPT_NAMES)}")
    if cfg.server_opt == "plain":
        return
    if cfg.algo not in ("cross_silo", "async_fl", "cross_device"):
        raise ServerOptConfigError(
            f"--server_opt {cfg.server_opt} rides the live finalize seam "
            f"and applies to --algo async_fl, cross_device or cross_silo "
            f"only; --algo {cfg.algo} would silently run its own server "
            f"step and label the run {cfg.server_opt}.  The standalone "
            f"forks stay at --algo fedopt/fedac.")
    if cfg.robust_agg != "mean":
        raise ServerOptConfigError(
            f"--server_opt {cfg.server_opt} with --robust_agg "
            f"{cfg.robust_agg}: an order-statistic finalize is a "
            f"selection, not a cohort mean — there is no pseudo-gradient "
            f"Δ = global − finalize whose expectation the server "
            f"optimizer's moments assume; use --robust_agg mean")
    if cfg.secagg != "off":
        raise ServerOptConfigError(
            f"--server_opt {cfg.server_opt} and --secagg are mutually "
            f"exclusive: the masked-sum protocol yields the plain mean by "
            f"construction; there is no seam to re-step it without "
            f"unmasking intermediate state")
    if cfg.local_alg == "fednova" and cfg.algo == "cross_device":
        raise ServerOptConfigError(
            "--server_opt with --local_alg fednova: fednova's tau_eff step "
            "IS a server update; stacking a second optimizer on top would "
            "silently change its normalized averaging semantics")


def check_cross_device(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on ``--algo cross_device``: every flag the
    wave engine would silently ignore fails here, with its reason."""
    if cfg.algo != "cross_device":
        return
    if cfg.secagg != "off":
        raise ValueError(
            "--cross_device trains sampled clients inside wave programs: "
            "there are no per-client uploads on a wire to mask, so "
            "--secagg would label an unmasked simulation as private; "
            "secure aggregation lives on the actor path (--algo cross_silo "
            "--secagg ...)")
    if cfg.silo_backend != "local":
        raise ValueError(
            f"--cross_device is the single-process engine; --silo_backend "
            f"{cfg.silo_backend!r} (transport actors) would be silently "
            f"ignored")
    if cfg.edge_aggregators > 0:
        raise ValueError(
            "--edge_aggregators is a transport-actor topology; the "
            "cross-device engine's hierarchy is the wave tree itself "
            "(waves pre-reduce on device), so the flag would "
            "silently run a flat engine labeled as an edge tree")
    if cfg.robust_agg != "mean":
        raise ValueError(
            f"--robust_agg {cfg.robust_agg}: order-statistic rules need the "
            f"per-client population, but cross-device waves pre-reduce to a "
            f"weighted partial mean on the device.  The defenses that "
            f"compose are the per-wave structure/finite/norm screens and "
            f"--norm_clip/--agg_noise_std on the streamed mean; for "
            f"per-upload robust rules use --algo cross_silo --agg_mode "
            f"stream --stream_reservoir K")
    if cfg.adversary:
        raise ValueError(
            "--adversary wraps per-silo train fns over the real "
            "message path (robust/adversary.py); the compiled wave "
            "has no per-silo message seam — run attack scenarios on "
            "--algo cross_silo, or poison wave SUMMARIES here with "
            "--wave_adversary round:wave:kind[:param]")
    if cfg.rounds_per_dispatch > 1:
        raise ValueError(
            "--rounds_per_dispatch is fedavg's device-resident multi-round "
            "scan; the cross-device wave loop folds per wave on the host "
            "each round and would silently ignore it")
    if cfg.wave_size < 0:
        raise ValueError(f"--wave_size must be >= 0 (0 = auto), got "
                         f"{cfg.wave_size}")


def resolve_cross_device(cfg: ExperimentConfig) -> ExperimentConfig:
    """``--cross_device`` is shorthand for ``--algo cross_device``;
    paired with another algorithm it would silently pick one of the
    two, so that fails."""
    if cfg.cross_device and cfg.algo not in ("fedavg", "cross_device"):
        raise ValueError(
            f"--cross_device IS an algorithm selection (the wave engine, "
            f"--algo cross_device); it cannot combine with --algo "
            f"{cfg.algo}")
    if cfg.cross_device or cfg.algo == "cross_device":
        cfg = dataclasses.replace(cfg, algo="cross_device",
                                  cross_device=True)
    return cfg


# the JAX package's runners that take --compute_dtype (JAX main.py's
# _DTYPE_RUNNERS); check_config keeps those the port has
DTYPE_RUNNERS = {"fedavg", "fedprox", "fedopt", "fednova", "fedavg_robust",
                 "hierarchical", "centralized", "decentralized",
                 "turboaggregate", "ditto", "feddyn", "dp_fedavg", "fedac",
                 "cross_device"}


# the JAX package's runners the port has not yet
UNPORTED_RUNNERS = ("fednas", "fedgan", "asdgan", "fedseg")


def check_config(cfg: ExperimentConfig) -> None:
    """Refuse, by name, what the port does not run yet."""
    if cfg.algo in UNPORTED_RUNNERS:
        raise KeyError(f"--algo {cfg.algo!r} is not ported yet (ROADMAP "
                       f"Queue 1 item 12, the long tail's model-heavy "
                       f"runners); the port has {sorted(RUNNERS)}")
    if cfg.algo not in RUNNERS:
        raise KeyError(f"--algo {cfg.algo!r} is not ported yet; the port "
                       f"has {sorted(RUNNERS)}")
    check_cross_device(cfg)
    check_cross_silo(cfg)
    check_obs(cfg)
    supported = sorted(DTYPE_RUNNERS & set(RUNNERS))
    if cfg.compute_dtype and cfg.algo not in supported:
        raise ValueError(
            f"--compute_dtype is not wired into --algo {cfg.algo}; "
            f"supported: {supported}")
    check_sequence(cfg)
    check_mesh(cfg)
    if cfg.checkpoint_dir and cfg.algo == "turboaggregate":
        raise NotImplementedError(
            "--checkpoint_dir with --algo turboaggregate is not ported yet; "
            "the secure cohort loop has no checkpoint hooks (ROADMAP Queue 1 "
            "item 12, with the rest of the standalone secure loops)")


def check_sequence(cfg: ExperimentConfig) -> None:
    """The JAX runner's gates on ``--mesh_sequence`` (JAX
    ``main.py:402-433``), before any rank starts."""
    if cfg.mesh_sequence < 0:
        raise ValueError(f"--mesh_sequence must be >= 0, got "
                         f"{cfg.mesh_sequence}")
    if not cfg.mesh_sequence:
        return
    if cfg.algo != "fedavg":
        raise ValueError(f"--mesh_sequence is dp x sp FedAvg over a "
                         f"[clients, sequence] mesh; --algo {cfg.algo} "
                         f"would silently train without it")
    if cfg.model != "transformer":
        raise ValueError("--mesh_sequence requires --model transformer "
                         "(the ring-attention-capable model)")
    if cfg.moe_experts:
        raise ValueError(
            "--moe_experts with --mesh_sequence is not supported: the "
            "sequence-parallel loss path does not capture the Switch "
            "load-balance loss (it would silently train with zero "
            "balancing pressure); drop one of the flags")
    if cfg.mesh_clients or cfg.mesh_groups:
        raise ValueError("--mesh_sequence and --mesh_clients build one "
                         "combined [clients, sequence] mesh; pass "
                         "--mesh_sequence S with client sharding "
                         "implied by the remaining devices")


# the runners that take a mesh (--mesh_clients, --mesh_groups)
MESH_RUNNERS = {"fedavg", "fedprox", "fedopt", "fednova", "scaffold",
                "feddyn", "ditto", "fedac", "dp_fedavg", "fedavg_robust",
                "hierarchical", "cross_device", "decentralized"}


def check_mesh(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the mesh flags."""
    if cfg.mesh_clients < 0 or cfg.mesh_groups < 0:
        raise ValueError(f"--mesh_clients and --mesh_groups must be >= 0, "
                         f"got {cfg.mesh_clients}, {cfg.mesh_groups}")
    if cfg.mesh_groups > 0 and cfg.algo != "hierarchical":
        raise ValueError(
            "--mesh_groups builds the two-level [groups, clients] mesh, "
            "which only the hierarchical algorithm consumes; other "
            f"algorithms (got --algo {cfg.algo}) would silently "
            "duplicate work across the groups axis. Use --mesh_clients.")
    if cfg.num_processes > 1 and not (cfg.mesh_clients or cfg.mesh_groups
                                      or cfg.mesh_sequence):
        raise ValueError(
            f"--num_processes {cfg.num_processes} starts one rank a mesh "
            f"position; pass --mesh_clients (or --mesh_groups, or "
            f"--mesh_sequence) to say the mesh")
    if not (cfg.mesh_clients or cfg.mesh_groups):
        return
    if cfg.algo == "async_fl":
        raise ValueError("--mesh_clients does not apply to the async "
                         "actor mode (each silo trains single-chip)")
    if cfg.algo == "cross_silo":
        raise ValueError("--mesh_clients does not apply to the cross-silo "
                         "actor mode (each silo trains single-chip); drop "
                         "the flag or use --algo fedavg for on-pod sharding")
    if cfg.algo == "cross_device":
        # the engine's own gates, here before any rank starts
        from fedml_tpu_torch.algorithms.cross_device import check_wave_mesh
        check_wave_mesh(cfg.local_alg, cfg.wave_size, cfg.mesh_clients)
    if cfg.algo not in MESH_RUNNERS:
        raise ValueError(
            f"--mesh_clients does not shard --algo {cfg.algo}: its runner "
            f"takes no mesh (the mesh runners: {sorted(MESH_RUNNERS)})")
    if cfg.algo == "fedavg_robust":
        # FedAvgRobust's own gates, here before any rank starts
        from fedml_tpu_torch.core.byzantine import METHODS
        if cfg.defense in METHODS:
            raise ValueError(
                f"defense {cfg.defense!r} needs the full cohort on one "
                "chip (sorts / pairwise distances); drop --mesh_clients")
        if cfg.defense_backend == "cuda" and cfg.defense != "none":
            raise ValueError("defense_backend='cuda' does not shard over a "
                             "mesh; drop --mesh_clients or use the torch "
                             "backend")


def _on_cpu(cfg: ExperimentConfig) -> bool:
    return cfg.platform is not None and \
        torch.device(str(cfg.platform)).type == "cpu"


def mesh_shape(cfg: ExperimentConfig, n_dev: Optional[int]):
    """The mesh's axis sizes over ``n_dev`` devices (ranks), with the JAX
    package's errors, or None without mesh flags.  ``n_dev`` None: no cap
    (CUDA ranks may share a card); the sizes the flags leave out default
    to the visible cards."""
    from fedml_tpu_torch.parallel.mesh import (check_mesh_factors,
                                               check_two_level_factors)
    if cfg.mesh_sequence > 0:
        # the world is --num_processes (else the devices), n_cli = world
        # // S of it, as the JAX runner takes jax.devices()
        avail = (cfg.num_processes if cfg.num_processes > 1
                 else n_dev if n_dev is not None
                 else torch.cuda.device_count())
        n_cli = max(1, avail // cfg.mesh_sequence)
        if n_cli * cfg.mesh_sequence > avail:
            raise ValueError(f"mesh {n_cli}x{cfg.mesh_sequence} != "
                             f"{avail} devices")
        return {"clients": n_cli, "sequence": cfg.mesh_sequence}
    if cfg.mesh_groups > 0:
        avail = n_dev if n_dev is not None else torch.cuda.device_count()
        n_cli = cfg.mesh_clients or avail // cfg.mesh_groups
        if n_cli < 1:
            raise ValueError(
                f"--mesh_groups {cfg.mesh_groups} exceeds the {avail} "
                f"available devices")
        want = cfg.mesh_groups * n_cli
        check_two_level_factors(cfg.mesh_groups, n_cli,
                                want if n_dev is None else min(want, n_dev))
        return {"groups": cfg.mesh_groups, "clients": n_cli}
    if cfg.mesh_clients > 0:
        want = cfg.mesh_clients
        check_mesh_factors(want, 1, want if n_dev is None
                           else min(want, n_dev))
        return {"clients": want, "model": 1}
    return None


def build_mesh(cfg: ExperimentConfig):
    """This rank's mesh of the run's process group, or None."""
    from fedml_tpu_torch.parallel import mesh as mesh_lib
    shape = mesh_shape(cfg, mesh_lib.rank_and_world()[1])
    if shape is None:
        if mesh_lib.rank_and_world()[1] > 1:
            raise ValueError("a run of several ranks needs --mesh_clients "
                             "(or --mesh_groups, or --mesh_sequence) to "
                             "say its mesh")
        return None
    if "groups" in shape:
        return mesh_lib.make_two_level_mesh(shape["groups"],
                                            shape["clients"],
                                            device=cfg.platform)
    if "sequence" in shape:
        return mesh_lib.make_sp_mesh(shape["clients"], shape["sequence"],
                                     device=cfg.platform)
    return mesh_lib.make_mesh(shape["clients"], device=cfg.platform)


def _joined(cfg: ExperimentConfig) -> bool:
    """Whether this process is (or becomes) a rank of a group started
    elsewhere: one is up, or the coordinator flags or torchrun's
    environment name one."""
    import os
    import torch.distributed as dist
    return (dist.is_initialized() or cfg.coordinator_address is not None
            or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))


def launch_mesh(cfg: ExperimentConfig, world: int) -> Dict[str, Any]:
    """Start the mesh's ``world`` ranks from this invocation (one rank: in
    this process) and return rank 0's summary."""
    import os
    import tempfile
    from fedml_tpu_torch.parallel import mesh as mesh_lib
    from fedml_tpu_torch.parallel.launch import spawn_ranks
    platform = "cpu" if _on_cpu(cfg) else None
    if world == 1:
        with tempfile.TemporaryDirectory(prefix="fedml_ranks_") as tmp:
            mesh_lib.init_from_file(os.path.join(tmp, "store"), 0, 1,
                                    platform=platform)
            try:
                return run(cfg)
            finally:
                mesh_lib.shutdown_distributed()
    device = torch.device("cpu" if platform else "cuda")
    logger.info("mesh: starting %d ranks on %s (backend %s)", world,
                "the CPU" if platform else "the cards",
                mesh_lib.choose_backend(device, world))
    summary = spawn_ranks(_mesh_rank, world, args=(cfg,),
                          platform=platform)[0]
    _print_summary(cfg, summary)
    return summary


def _mesh_rank(cfg: ExperimentConfig) -> Dict[str, Any]:
    return run(cfg, print_summary=False)


def _print_summary(cfg: ExperimentConfig, summary: Dict[str, Any]) -> None:
    """The final summary line on stdout, and with ``--completion_signal``
    into that FIFO or file when the summary is not empty (a gRPC silo's
    empty one must not unblock a sweep's orchestrator)."""
    line = json.dumps({"algo": cfg.algo, "dataset": cfg.dataset,
                       "model": cfg.model,
                       **{k: v for k, v in summary.items()
                          if isinstance(v, (int, float, str))}})
    print(line, flush=True)
    if cfg.completion_signal and summary:
        with open(cfg.completion_signal, "w") as f:
            f.write(line + "\n")


def main(argv=None) -> Dict[str, Any]:
    cfg = argv if isinstance(argv, ExperimentConfig) \
        else config_from_argv(argv)
    cfg = resolve_cross_device(cfg)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    check_config(cfg)
    if not _joined(cfg):
        shape = mesh_shape(cfg, (cfg.host_device_count or 1)
                           if _on_cpu(cfg) else None)
        if shape is not None:
            return launch_mesh(cfg, int(np.prod(list(shape.values()))))
    return run(cfg)


@contextlib.contextmanager
def deterministic_flags(on: bool):
    """Inside the block, when ``on``: cuDNN's deterministic algorithms,
    no autotuning and TF32 off.  The process-wide flags are restored after
    it, so a caller in the same process does not inherit them."""
    b = torch.backends
    saved = (b.cudnn.deterministic, b.cudnn.benchmark,
             b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    if on:
        b.cudnn.deterministic, b.cudnn.benchmark = True, False
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (b.cudnn.deterministic, b.cudnn.benchmark,
         b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) = saved


def run(cfg: ExperimentConfig, print_summary: bool = True
        ) -> Dict[str, Any]:
    """One process's run: join the process group the flags name, build
    its mesh, run ``--algo``; rank 0 writes the artifacts and prints the
    summary line.  ``--deterministic`` holds for this call only."""
    with deterministic_flags(cfg.deterministic):    # each rank runs this
        return _run(cfg, print_summary)


def _run(cfg: ExperimentConfig, print_summary: bool) -> Dict[str, Any]:
    import os
    from fedml_tpu_torch.parallel.mesh import init_distributed
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    init_distributed(cfg.coordinator_address, cfg.num_processes,
                     cfg.process_id, platform=cfg.platform)
    mesh = build_mesh(cfg)
    if mesh is not None:
        logger.info("mesh %s: rank %d of %d, backend %s, device %s",
                    mesh.shape, mesh.rank, mesh.world_size, mesh.backend,
                    mesh.device)
        if mesh.rank != 0:      # rank 0 reports the run
            logger.setLevel(logging.WARNING)
    device = mesh.device if mesh is not None else resolve_device(cfg.platform)
    cfg = dataclasses.replace(cfg, platform=str(device))
    is_main = mesh is None or mesh.rank == 0
    data = load_experiment_data(cfg)
    logger.info("algo=%s model=%s dataset=%s clients=%d device=%s",
                cfg.algo, cfg.model, cfg.dataset, data.client_num, device)
    run_dir = cfg.metrics_dir or cfg.run_dir
    # the observability opt-ins, enabled BEFORE the runner builds any
    # transport or actor (instrumented constructors cache their handles);
    # the exports run in the finally, so a crashed run still leaves its
    # telemetry snapshot and the spans recorded so far
    from fedml_tpu_torch.obs import telemetry as _telemetry
    from fedml_tpu_torch.obs import trace as _trace
    from fedml_tpu_torch.utils.metrics import profiler_trace
    registry = prom_server = tracer = None
    scrape_port = cfg.metrics_port or cfg.prom_port
    if cfg.telemetry or scrape_port > 0:
        registry = _telemetry.enable()
        if scrape_port > 0:
            prom_server = _telemetry.start_http_server(scrape_port,
                                                       registry)
            if prom_server is not None:
                logger.info("telemetry: serving /metrics on :%d",
                            scrape_port)
    if cfg.trace_dir:
        tracer = _trace.enable(node=f"node{cfg.node_id}")
    try:
        # only rank 0 writes run artifacts; the other ranks keep an
        # in-memory sink, so the runners are rank-agnostic
        with MetricsSink(run_dir if is_main else None,
                         stdout=cfg.log_stdout and is_main,
                         name=cfg.algo) as sink:
            sink.log({"config": dataclasses.asdict(cfg)})
            with profiler_trace(cfg.profile_dir if is_main else None,
                                device):
                summary = (RUNNERS[cfg.algo](cfg, data, sink, mesh=mesh)
                           if mesh is not None
                           else RUNNERS[cfg.algo](cfg, data, sink))
            sink.log({"final": summary})
    finally:
        # each teardown step on its own: a failing export must not skip
        # the others, leak the /metrics port, or leave the process-global
        # tracer or registry enabled for the next main() call
        if tracer is not None:
            try:
                tracer.export(os.path.join(
                    cfg.trace_dir,
                    f"trace-node{cfg.node_id}-{os.getpid()}.json"))
            except OSError:
                logger.exception("trace export failed")
            _trace.disable()
        if registry is not None:
            if run_dir is not None and is_main:
                try:
                    registry.save(os.path.join(run_dir, "telemetry.json"))
                    with open(os.path.join(run_dir, "telemetry.prom"),
                              "w") as f:
                        f.write(registry.render_prometheus())
                except OSError:
                    logger.exception("telemetry export failed")
            if prom_server is not None:
                prom_server.shutdown()
                prom_server.server_close()
            _telemetry.disable()
    if is_main and print_summary:
        _print_summary(cfg, summary)
    return summary


if __name__ == "__main__":
    main()
