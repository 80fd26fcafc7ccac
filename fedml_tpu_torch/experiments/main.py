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
``--stream_reservoir K``).  The cross-silo server takes ``--checkpoint_dir``
(resume), ``--journal`` (mid-round resume), ``--dead_after_s`` (the failure
detector) and ``--chaos_*`` (seeded faults on the hub, threaded drive);
``--silo_backend grpc`` runs one node per process:

    python -m fedml_tpu_torch --algo cross_silo --silo_backend grpc \\
        --node_id 0 --client_num_per_round 2 ...   # the server
    python -m fedml_tpu_torch --algo cross_silo --silo_backend grpc \\
        --node_id 1 --client_num_per_round 2 ...   # silo 1, and so on
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
    weights across.

    Each silo gets a workload of its own: ``functional_call`` swaps the
    parameters of the module it is given in place, so silos training on
    their own threads (the threaded drive) must not share one module."""
    from fedml_tpu_torch.core.pytree import as_tensor
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import make_client_optimizer

    def make_train_fn(silo_id):
        local = make_local_trainer(
            _make_workload(cfg, data),
            make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd),
            cfg.epochs)

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


def make_journal(cfg: ExperimentConfig):
    """The round journal under ``--journal_dir`` (or ``run_dir/journal``
    with ``--journal``); only the server node journals."""
    if not (cfg.journal or cfg.journal_dir):
        return None
    if cfg.silo_backend != "local" and cfg.node_id != 0:
        return None  # a gRPC silo has no fold state to journal
    import os
    from fedml_tpu_torch.utils.journal import RoundJournal
    path = cfg.journal_dir or os.path.join(cfg.run_dir or ".", "journal")
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
                        node=f"node{cfg.node_id}")


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


def grpc_transport(cfg: ExperimentConfig, n_silos: int):
    """This process's endpoint of the gRPC mesh (``--node_id``), in a
    `ResilientTransport` with ``--silo_retries``."""
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
            seed=cfg.seed)
    return transport


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
    ``--checkpoint_dir`` checkpoints every closed round (the trust ledger
    and the shard layout ride ``extra_state``) and resumes from it;
    ``--journal``/``--journal_dir`` adds the round journal;
    ``--dead_after_s`` the failure detector.  ``faultline``: the server's
    `robust.faultline.Faultline`.

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
        # the trust ledger and the shard layout are checkpointed state: a
        # resumed server keeps strikes and quarantine sentences, and
        # refuses a checkpoint of another layout
        trust = (admission.trust if admission is not None
                 else spine.admission.trust if spine is not None else None)
        self.checkpointer = make_checkpointer(cfg)
        self.journal = make_journal(cfg)
        self.detector = None
        if cfg.dead_after_s > 0:
            self.detector = FailureDetector(
                suspect_after_s=cfg.suspect_after_s or cfg.dead_after_s / 2,
                dead_after_s=cfg.dead_after_s)
        extra_state = _compose_extra_state([
            ("trust", None if trust is None else
             (lambda: trust.state_dict(n_silos), trust.load_state_dict)),
            ("shard", None if spine is None else
             (spine.checkpoint_state, spine.restore_checkpoint_state))])
        self._eval_cohort = cohort_eval(make_evaluator(wl))
        self._freq = (max(cfg.comm_round, 1) if cfg.ci
                      else cfg.frequency_of_the_test)
        self.history: list = []
        self.round_times: list = []
        self._t0 = time.perf_counter()

        def make_server(transport):
            return FedAvgServerActor(
                transport, init, data.client_num, n_silos, cfg.comm_round,
                on_round_done=self._on_round_done,
                straggler_policy=cfg.straggler_policy,
                round_timeout_s=cfg.round_timeout_s or None,
                min_silo_frac=cfg.min_silo_frac, admission=admission,
                stream_agg=stream, shard_wire=spine, aggregate_fn=defended,
                failure_detector=self.detector,
                checkpointer=self.checkpointer, extra_state=extra_state,
                journal=self.journal, faultline=faultline)

        self.hub = None
        self.chaos_plan = None
        self.server = None
        self.silos: list = []
        if cfg.silo_backend == "grpc":
            self.drive = "grpc"
            transport = grpc_transport(cfg, n_silos)
            if cfg.node_id == 0:
                self.server = make_server(transport)
            else:
                self.silos = [FedAvgClientActor(
                    cfg.node_id, transport, make_train_fn(cfg.node_id),
                    heartbeat_interval_s=cfg.heartbeat_s or None)]
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
        self.silos = [FedAvgClientActor(
            g, wrap(transport_factory(g)), make_train_fn(g),
            heartbeat_interval_s=(cfg.heartbeat_s or None) if threaded
            else None)
            for g in range(1, n_silos + 1)]
        if not threaded:
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

    def _run_threaded(self, join_timeout_s: float = 30.0) -> None:
        import threading
        threads = [threading.Thread(target=a.run, daemon=True,
                                    name=f"node-{a.node_id}")
                   for a in self.silos]
        for th in threads:
            th.start()
        try:
            self.server.register_handlers()
            self.server.start()
            self.server.transport.run()  # until the last round's FINISH
        finally:
            for th in threads:
                th.join(timeout=join_timeout_s)
            for silo in self.silos:
                silo.finish()   # idempotent: stragglers past FINISH
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
                server.start()
                self.hub.pump()
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
    "serve_port": (0, "serve/ (ROADMAP Queue 1 item 11)"),
    "ingest_pipeline": (False, "comm/ingest.py (ROADMAP Queue 1 item 8)"),
    "health": (False, "obs/health.py (ROADMAP Queue 1 item 9)"),
    "server_opt": ("plain", "server_opt/ (ROADMAP Queue 1 item 7)"),
    "adaptive": (False, "server_opt/controller.py (ROADMAP Queue 1 item 7)"),
    "adversary": ("", "robust/adversary.py (ROADMAP Queue 1 item 8)"),
    "mesh_stages": (0, "parallel/pipeline.py (ROADMAP Queue 1 item 10)"),
}


def check_cross_silo(cfg: ExperimentConfig) -> None:
    """The JAX package's gates on the cross-silo flags, and the port's
    refusals of what it does not run yet."""
    for flag, (default, needs) in REFUSED_FLAGS.items():
        if getattr(cfg, flag) != default:
            raise NotImplementedError(
                f"--{flag} is not ported yet; it needs {needs}")
    if cfg.silo_backend not in ("local", "grpc"):
        raise ValueError(f"unknown silo_backend {cfg.silo_backend!r}; "
                         f"available: ('local', 'grpc')")
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
        if cfg.silo_backend != "local":
            raise ValueError(
                "--model_shards deploys over the local hub only for "
                "now (the actors are transport-agnostic; gRPC wiring "
                "mirrors the flat one)")


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
