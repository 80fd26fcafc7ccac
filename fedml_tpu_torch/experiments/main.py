"""``python -m fedml_tpu_torch`` — the port's entry point.

Runs ``fedavg``, ``fedavg_robust``, ``turboaggregate`` and ``cross_silo``
on the hermetic twins, on the GPU unless ``--platform cpu`` is given,
writes ``metrics.jsonl`` and ``summary.json`` into ``--run_dir`` and
prints one final JSON summary line.  Examples, the FEMNIST-CNN
configurations of the defended FedAvg, of secure FedAvg and of the live
cross-silo federation with the sharded spine, and FedAvg on the
transformer LM over the Shakespeare twin:

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

Plain FedAvg keeps the train split on the device when it fits and, with
``--rounds_per_dispatch K``, runs K rounds a call (on the GPU as replays
of one captured CUDA graph); ``--checkpoint_dir`` saves round checkpoints
and resumes from the latest.  ``--defense`` takes the Byzantine rules
(``krum --byz_f 1``, ...), and the live cross-silo server takes
``--robust_agg`` in both ``--agg_mode stack`` and ``stream`` (with
``--stream_reservoir K``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, Callable, Dict

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
                           sample_shape_of(data),
                           attn_block_size=cfg.attn_block_size,
                           attn_flash=cfg.attn_flash,
                           moe_experts=cfg.moe_experts)


def _summary(algo, params) -> Dict[str, Any]:
    """The last eval row, the steady round rate (rounds after the first,
    which carries the warm-up) and whether every parameter is finite."""
    out = dict(algo.history[-1]) if algo.history else {}
    steady = algo.round_times[1:] or algo.round_times
    out["rounds_per_s"] = len(steady) / sum(steady) if steady else 0.0
    out["params_finite"] = all(
        bool(v.isfinite().all()) for v in params.values())
    return out


def make_checkpointer(cfg: ExperimentConfig):
    if not cfg.checkpoint_dir:
        return None
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    return RoundCheckpointer(cfg.checkpoint_dir,
                             save_every=cfg.checkpoint_every,
                             async_save=cfg.checkpoint_async,
                             keep_last_n=cfg.checkpoint_keep_last_n)


def _run_with_checkpoints(cfg, algo):
    ckpt = make_checkpointer(cfg)
    try:
        params = algo.run(checkpointer=ckpt)
    finally:
        if ckpt is not None:
            ckpt.close()
    return _summary(algo, params)


@runner("fedavg")
def run_fedavg(cfg, data, sink):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    algo = FedAvg(_make_workload(cfg, data), data,
                  FedAvgConfig(**_fedavg_cfg_kwargs(cfg)), sink=sink,
                  device=cfg.platform)
    return _run_with_checkpoints(cfg, algo)


def fedavg_robust_config(cfg: ExperimentConfig):
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustConfig
    return FedAvgRobustConfig(
        defense=cfg.defense, norm_bound=cfg.norm_bound, stddev=cfg.stddev,
        defense_backend=cfg.defense_backend, trim_frac=cfg.trim_frac,
        byz_f=cfg.byz_f, krum_m=cfg.krum_m, gm_iters=cfg.gm_iters,
        gm_eps=cfg.gm_eps, **_fedavg_cfg_kwargs(cfg))


@runner("fedavg_robust")
def run_fedavg_robust(cfg, data, sink):
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    algo = FedAvgRobust(_make_workload(cfg, data), data,
                        fedavg_robust_config(cfg), sink=sink,
                        device=cfg.platform)
    return _run_with_checkpoints(cfg, algo)


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


def _silo_training_setup(cfg, data, wl, device, init_params=None):
    """The initial global and the per-silo ``train_fn(params, client_idx,
    round_idx)`` factory: each silo trains its sampled client's shard on
    ``device`` with the local trainer.  ``init_params`` (a flat dict)
    replaces the seeded init, as a test does to carry the JAX package's
    weights across."""
    from fedml_tpu_torch.core.pytree import as_tensor
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import make_client_optimizer

    local = make_local_trainer(
        wl, make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd),
        cfg.epochs)

    def make_train_fn(silo_id):
        # the CNN has no dropout, so the silo's key of the JAX chain
        # (`silo_key`) has nothing to seed
        def train_fn(params, client_idx, round_idx):
            shard = {k: torch.as_tensor(data.train[k][client_idx]).to(device)
                     for k in ("x", "y", "mask")}
            new, _ = local({k: as_tensor(v, device)
                            for k, v in params.items()}, shard)
            return new, float(data.train["num_samples"][client_idx])
        return train_fn

    if init_params is None:
        init_params = wl.init(torch.Generator().manual_seed(cfg.seed), device)
    return {k: v.to(device) for k, v in init_params.items()}, make_train_fn


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


def _robust_setup(cfg: ExperimentConfig, template):
    """The replicated path's admission pipeline (``--admission auto`` arms
    it whenever a defense flag is set) and aggregation: ``(admission,
    defended, stream)``.  ``--agg_mode stream`` gives a streaming fold
    (the mean, or a rule over its reservoir); stack mode gives the
    defended aggregate over the staged cohort when a defense flag is set,
    else None (the plain weighted mean)."""
    from fedml_tpu_torch.core.pytree import nest, to_host
    from fedml_tpu_torch.core.stream_agg import StreamingAggregator
    from fedml_tpu_torch.robust import AdmissionPipeline
    from fedml_tpu_torch.robust.defense import make_defended_aggregate

    robust_on = (cfg.robust_agg != "mean" or cfg.norm_clip > 0
                 or cfg.agg_noise_std > 0)
    admission = None
    if cfg.admission == "on" or (cfg.admission == "auto" and robust_on):
        admission = AdmissionPipeline(
            to_host(nest(template)), kind="params",
            max_num_samples=cfg.max_num_samples, norm_k=cfg.norm_screen_k,
            norm_window=cfg.norm_screen_window,
            norm_min_history=cfg.norm_screen_min_history,
            trust=_trust_tracker(cfg))
    rule = dict(trim_frac=cfg.trim_frac, byz_f=cfg.byz_f, krum_m=cfg.krum_m,
                gm_iters=cfg.gm_iters, gm_eps=cfg.gm_eps,
                norm_clip=cfg.norm_clip, noise_std=cfg.agg_noise_std,
                seed=cfg.seed)
    if cfg.agg_mode == "stream":
        return admission, None, StreamingAggregator(
            template, method=cfg.robust_agg, kind="params",
            reservoir_k=cfg.stream_reservoir, **rule)
    defended = (make_defended_aggregate(cfg.robust_agg, **rule)
                if robust_on else None)
    return admission, defended, None


def _trust_tracker(cfg: ExperimentConfig):
    from fedml_tpu_torch.robust import TrustTracker
    return TrustTracker(strikes_to_quarantine=cfg.strikes_to_quarantine,
                        quarantine_rounds=cfg.quarantine_rounds,
                        probation_rounds=cfg.probation_rounds)


class CrossSiloFederation:
    """Distributed FedAvg over the actor/transport layer: the server and
    ``client_num_per_round`` silo actors in-process on one `LocalHub`
    (every frame through the wire codec), driven by the synchronous pump.
    ``--model_shards S`` runs the sharded spine: per-shard slice frames,
    per-shard admission and fold, and one K2 launch per shard per round
    with ``--fused_finalize on`` (or ``auto`` on the GPU).

    Built, then ``run()``; ``server.params`` is the global.
    ``init_params`` (a flat dict) replaces the seeded init."""

    def __init__(self, cfg, data, sink, init_params=None):
        from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                           FedAvgServerActor)
        from fedml_tpu_torch.comm.local import LocalHub
        from fedml_tpu_torch.parallel.cohort import cohort_eval
        from fedml_tpu_torch.shard_spine import build_shard_spine
        from fedml_tpu_torch.trainer.local_sgd import make_evaluator

        self.cfg, self.data, self.sink = cfg, data, sink
        self.device = resolve_device(cfg.platform)
        wl = _make_workload(cfg, data)
        init, make_train_fn = _silo_training_setup(cfg, data, wl,
                                                   self.device, init_params)
        n_silos = min(cfg.client_num_per_round, data.client_num)
        spine = None
        if cfg.model_shards > 0:
            spine = build_shard_spine(
                init, num_shards=cfg.model_shards, norm_clip=cfg.norm_clip,
                noise_std=cfg.agg_noise_std, seed=cfg.seed,
                fused=cfg.fused_finalize,
                max_num_samples=cfg.max_num_samples,
                norm_k=cfg.norm_screen_k, norm_window=cfg.norm_screen_window,
                norm_min_history=cfg.norm_screen_min_history,
                trust=_trust_tracker(cfg))
            admission, defended, stream = None, None, spine.agg
        else:
            admission, defended, stream = _robust_setup(cfg, init)
        self._eval_cohort = cohort_eval(make_evaluator(wl))
        self._freq = (max(cfg.comm_round, 1) if cfg.ci
                      else cfg.frequency_of_the_test)
        self.history: list = []
        self.round_times: list = []
        self._t0 = time.perf_counter()
        self.hub = LocalHub(codec_roundtrip=True)
        self.server = FedAvgServerActor(
            self.hub.transport(0), init, data.client_num, n_silos,
            cfg.comm_round, on_round_done=self._on_round_done,
            straggler_policy=cfg.straggler_policy,
            round_timeout_s=cfg.round_timeout_s or None,
            min_silo_frac=cfg.min_silo_frac, admission=admission,
            stream_agg=stream, shard_wire=spine, aggregate_fn=defended)
        self.silos = [FedAvgClientActor(g, self.hub.transport(g),
                                        make_train_fn(g))
                      for g in range(1, n_silos + 1)]
        for actor in [self.server] + self.silos:
            actor.register_handlers()

    def _on_round_done(self, r, params):
        from fedml_tpu_torch.algorithms.fedavg import evaluate_global
        synchronize(self.device)
        self.round_times.append(time.perf_counter() - self._t0)
        if r % self._freq == 0 or r == self.cfg.comm_round - 1:
            stats = evaluate_global(self._eval_cohort, self.data, params,
                                    self.cfg.eval_chunk_clients, self.device)
            stats.update(round=r, round_s=self.round_times[-1])
            logger.info("round %d: %s", r, stats)
            self.history.append(stats)
            self.sink.log(stats, step=r)
        self._t0 = time.perf_counter()   # evaluation is not round time

    def run(self) -> Dict[str, Any]:
        """Drive the federation to its end; the last evaluation, the
        steady round rate (rounds after the first) and whether the global
        is finite."""
        server = self.server
        try:
            self._t0 = time.perf_counter()
            server.start()
            self.hub.pump()
        finally:
            server.finish()   # idempotent; joins the straggler timer
        if server.round_idx < self.cfg.comm_round and not server.aborted:
            raise RuntimeError(f"the federation stalled at round "
                               f"{server.round_idx} of {self.cfg.comm_round}")
        steady = self.round_times[1:] or self.round_times
        out = dict(self.history[-1]) if self.history else {}
        out["rounds_per_s"] = len(steady) / sum(steady) if steady else 0.0
        out["params_finite"] = all(bool(v.isfinite().all())
                                   for v in server.params.values())
        return out


@runner("cross_silo")
def run_cross_silo(cfg, data, sink):
    return CrossSiloFederation(cfg, data, sink).run()


# cross-silo flags of the JAX package the port refuses, with what they
# need: (default, the ROADMAP item that brings it)
REFUSED_FLAGS = {
    "secagg": ("off", "live SecAgg over the wire, secure/protocol.py "
                      "(ROADMAP Queue 1 item 3)"),
    "edge_aggregators": (0, "algorithms/hierarchical.py (ROADMAP Queue 1 "
                            "item 8)"),
    "wire_compression": ("none", "comm/compress.py (ROADMAP Queue 1 item 8)"),
    "error_feedback": (False, "comm/compress.py (ROADMAP Queue 1 item 8)"),
    "heartbeat_s": (0.0, "heartbeats and the failure detector (ROADMAP "
                         "Queue 1 item 3)"),
    "dead_after_s": (0.0, "heartbeats and the failure detector (ROADMAP "
                          "Queue 1 item 3)"),
    "serve_port": (0, "serve/ (ROADMAP Queue 1 item 11)"),
    "ingest_pipeline": (False, "comm/ingest.py (ROADMAP Queue 1 item 8)"),
    "journal": (False, "utils/journal.py and robust/faultline.py (ROADMAP "
                       "Queue 1 item 3)"),
    "health": (False, "obs/health.py (ROADMAP Queue 1 item 9)"),
    "server_opt": ("plain", "server_opt/ (ROADMAP Queue 1 item 7)"),
    "adaptive": (False, "server_opt/controller.py (ROADMAP Queue 1 item 7)"),
    "adversary": ("", "robust/adversary.py (ROADMAP Queue 1 item 8)"),
    "mesh_stages": (0, "parallel/pipeline.py (ROADMAP Queue 1 item 10)"),
    **{f"chaos_{k}": (0.0, "comm/chaos.py (ROADMAP Queue 1 item 3)")
       for k in ("drop", "delay", "dup", "reorder", "corrupt")},
}


def check_cross_silo(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the cross-silo flags, and the port's
    refusals of what it does not run yet."""
    for flag, (default, needs) in REFUSED_FLAGS.items():
        if getattr(cfg, flag) != default:
            raise NotImplementedError(
                f"--{flag} is not ported yet; it needs {needs}")
    if cfg.silo_backend != "local":
        raise NotImplementedError(
            f"--silo_backend {cfg.silo_backend} is not ported yet; the "
            f"port runs the in-process hub only (comm/grpc_transport.py and "
            f"comm/mqtt_*: ROADMAP Queue 1 item 3)")
    if cfg.checkpoint_dir and cfg.algo == "cross_silo":
        raise NotImplementedError(
            "--checkpoint_dir with --algo cross_silo is not ported yet; the "
            "server actor's checkpointer and extra_state arrive with ROADMAP "
            "Queue 1 item 3a")
    from fedml_tpu_torch.robust.defense import ROBUST_AGG_METHODS
    if cfg.robust_agg not in ROBUST_AGG_METHODS:
        raise ValueError(f"--robust_agg must be one of {ROBUST_AGG_METHODS}, "
                         f"got {cfg.robust_agg!r}")
    if cfg.algo != "cross_silo" and (
            cfg.robust_agg != "mean" or cfg.norm_clip or cfg.agg_noise_std
            or cfg.admission == "on"):
        raise ValueError(
            f"--robust_agg/--norm_clip/--agg_noise_std/--admission on are "
            f"the live distributed defense and apply to --algo cross_silo "
            f"only; got --algo {cfg.algo}.  For the single-device cohort "
            f"simulation use --algo fedavg_robust --defense ... instead.")
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
        if cfg.admission == "off":
            raise ValueError(
                "--model_shards requires the admission screens: the "
                "per-shard structural fingerprint IS the wire protocol")


def check_config(cfg: ExperimentConfig) -> None:
    """Refuse, by name, what the port does not run yet."""
    if cfg.algo not in RUNNERS:
        raise KeyError(f"--algo {cfg.algo!r} is not ported yet; the port "
                       f"has {sorted(RUNNERS)}")
    check_cross_silo(cfg)
    if cfg.moe_experts:
        raise NotImplementedError(
            "--moe_experts is not ported yet; the Switch MoE FFN "
            "(models/moe.py) is what remains of ROADMAP Queue 1 item 4")
    if cfg.mesh_sequence:
        raise NotImplementedError(
            "--mesh_sequence is not ported yet; sequence parallelism "
            "(parallel/ring_attention.py, sequence.py) arrives over "
            "torch.distributed with ROADMAP Queue 1 item 10")
    if cfg.mesh_clients:
        raise NotImplementedError(
            "--mesh_clients is not ported yet; the shard_map cohort step "
            "arrives over torch.distributed with ROADMAP Queue 1 item 10")
    if cfg.checkpoint_dir and cfg.algo == "turboaggregate":
        raise NotImplementedError(
            "--checkpoint_dir with --algo turboaggregate is not ported yet; "
            "the secure round loop has no checkpoint hooks (ROADMAP Queue 1 "
            "item 3b)")


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
