"""The experiment config of the port (the subset of
``fedml_tpu/experiments/config.py`` the ported slices run, same flag names
and defaults, plus the cross-silo flags that are refused by name).
``defense_backend`` and ``secagg_backend`` take the port's names:
``torch`` (twin of ``xla``) and ``cuda`` (twin of ``pallas``)."""

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
    rounds_per_dispatch: int = 1         # >1: K rounds per call (scanned)
    ci: int = 0                          # eval only at round 0 and the end
    seed: int = 0

    norm_bound: float = 5.0              # robust: clip threshold
    stddev: float = 0.025                # robust: weak-DP noise
    defense: str = "weak_dp"             # robust: none|norm_diff_clipping|
    #                                      weak_dp|a Byzantine rule
    defense_backend: str = "torch"       # robust: "torch" | "cuda" (fused)
    trim_frac: float = 0.1               # trimmed_mean: cut per side
    byz_f: int = 0                       # krum: assumed Byzantine count
    krum_m: int = 1                      # multi_krum: updates averaged
    gm_iters: int = 8                    # geometric_median: Weiszfeld steps
    gm_eps: float = 1e-6                 # geometric_median: smoothing floor

    group_num: int = 2                   # turboaggregate: groups per round
    drop_tolerance: int = 1              # turboaggregate
    secagg_backend: str = "torch"        # turboaggregate: "torch" | "cuda"

    # cross_silo: the live federation over the in-process hub, or one node
    # of it per process over gRPC
    silo_backend: str = "local"          # "local" (in-process hub) | "grpc"
    node_id: int = 0                     # grpc: 0=server, 1..N=silos
    ip_config: str = ""                  # grpc: rank->IP csv (reference fmt)
    base_port: int = 50000               # grpc: port = base_port + node_id
    grpc_max_message_mb: int = 1000      # grpc: per-message size cap
    grpc_workers: int = 4                # grpc: inbound RPC thread pool
    silo_idle_timeout_s: float = 0.0     # grpc silos: exit after this long
    #                                      with no traffic (0 = wait forever)
    silo_retries: int = 0                # grpc: >0 wraps the transport in
    #                                      ResilientTransport (attempts)
    agg_mode: str = "stack"              # "stack" | "stream"
    model_shards: int = 0                # >0: the sharded spine (stream)
    fused_finalize: str = "auto"         # shard finalize: auto|on|off (K2)
    robust_agg: str = "mean"             # mean or a Byzantine rule (live)
    norm_clip: float = 0.0               # >0: clip each upload's update
    agg_noise_std: float = 0.0           # >0: weak-DP noise at finalize
    stream_reservoir: int = 64           # stream + a robust rule: slots
    straggler_policy: str = "wait"       # wait | drop | abort
    round_timeout_s: float = 0.0         # 0 = no straggler timer
    min_silo_frac: float = 0.5           # drop-policy quorum
    admission: str = "auto"              # upload screens: auto|on|off
    max_num_samples: float = 1e6         # admission: num_samples cap
    norm_screen_k: float = 6.0           # admission: median + k * MAD
    norm_screen_window: int = 64         # admission: norm history
    norm_screen_min_history: int = 8     # admission: warm-up norms
    strikes_to_quarantine: int = 3       # TrustTracker
    quarantine_rounds: int = 4           # TrustTracker
    probation_rounds: int = 2            # TrustTracker
    # fault tolerance: heartbeats, the failure detector, seeded chaos on
    # the local hub (any non-zero chaos value switches it to the threaded
    # drive, one thread per actor), the round journal
    heartbeat_s: float = 0.0             # >0: silo liveness beats (threaded
    #                                      and grpc drives)
    dead_after_s: float = 0.0            # >0: the server's failure detector
    suspect_after_s: float = 0.0         # SUSPECT threshold (0 = dead / 2)
    chaos_drop: float = 0.0              # drop prob (needs --straggler_policy
    #                                      drop + --round_timeout_s)
    chaos_delay: float = 0.0             # delay prob
    chaos_max_delay_s: float = 0.05      # delay bound (also reorder flush)
    chaos_dup: float = 0.0               # duplicate prob
    chaos_reorder: float = 0.0           # reorder (hold-back) prob
    chaos_corrupt: float = 0.0           # payload corruption prob
    chaos_seed: int = 0                  # fault-schedule seed
    journal: bool = False                # the round journal (stream mode)
    journal_dir: Optional[str] = None    # journal directory (implies
    #                                      --journal; default run_dir/journal)
    journal_snapshot_every: int = 4      # fold-state snapshot cadence
    # cross_silo options of the JAX package that are refused by name
    secagg: str = "off"
    edge_aggregators: int = 0
    wire_compression: str = "none"
    error_feedback: bool = False
    serve_port: int = 0
    ingest_pipeline: bool = False
    health: bool = False
    server_opt: str = "plain"
    adaptive: bool = False
    adversary: str = ""
    mesh_stages: int = 0

    # transformer attention (NWP datasets)
    attn_block_size: int = 0             # >0: blockwise attention
    attn_flash: bool = False             # the flash kernel (K4)
    moe_experts: int = 0                 # >0 is not ported (refused)
    mesh_sequence: int = 0               # >0 is not ported (refused)

    mesh_clients: int = 0                # >0 is not ported (refused)
    client_axis: str = "vmap"            # "vmap" | "scan"
    eval_chunk_clients: int = 1024       # evaluate_global clients per call
    platform: Optional[str] = None       # None/"gpu" -> cuda; "cpu"
    run_dir: Optional[str] = None        # metrics.jsonl + summary.json here
    checkpoint_dir: Optional[str] = None  # round checkpoints + resume
    checkpoint_every: int = 10           # save every N rounds (and the last)
    checkpoint_async: bool = False       # write saves on a background thread
    checkpoint_keep_last_n: int = 0      # >0: keep the newest N steps (0: 3)
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
