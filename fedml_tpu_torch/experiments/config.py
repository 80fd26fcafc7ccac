"""The experiment config of the port (the subset of
``fedml_tpu/experiments/config.py`` the ported slices run, same flag names
and defaults).
``defense_backend`` and ``secagg_backend`` take the port's names:
``torch`` (twin of ``xla``) and ``cuda`` (twin of ``pallas``).
``deterministic`` is the port's own: cuDNN's deterministic algorithms
and no TF32 on the card, for this run only, so a rerun is bit-equal and
a mesh run differs from one process only where its sums are taken in
another order or its clients train in vmaps of another width (cuDNN
picks other algorithms for them)."""

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
    partition_method: str = "hetero"     # cifar10/100, cinic10 on disk:
    #                                      homo | hetero (Dirichlet)
    partition_alpha: float = 0.5         # hetero: the Dirichlet alpha
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
    compute_dtype: str = ""              # "bfloat16": mixed precision (f32
    #                                      masters, bf16 model compute)

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

    # fedavg_robust: the backdoor attack's evaluation
    backdoor: bool = False               # poison attacker shards + eval
    attacker_num: int = 1                # the first K clients attack
    target_label: int = 9                # --backdoor, --adversary backdoor:
    #                                      the attack's target
    poison_frac: float = 1.0             # backdoor: fraction stamped
    trigger_size: int = 3                # backdoor: pixel-trigger side
    group_num: int = 2                   # hierarchical / turboaggregate
    group_comm_round: int = 2            # hierarchical: group rounds
    drop_tolerance: int = 1              # turboaggregate
    secagg_backend: str = "torch"        # turboaggregate: "torch" | "cuda"
    neighbor_num: int = 2                # decentralized topology
    # decentralized_online (DSGD / PushSum on a stream)
    mode: str = "DOL"                    # "DOL" | "PUSHSUM" | "LOCAL"
    iteration_number: int = 100          # stream length T per client
    beta: float = 0.0                    # adversarial (kmeans) stream frac
    b_symmetric: bool = False            # undirected vs directed topology
    topology_neighbors_num_undirected: int = 4
    topology_neighbors_num_directed: int = 4
    time_varying: bool = False           # regenerate graph each iteration
    temperature: float = 3.0             # FedGKT KD temperature

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
    retask_timeout_s: float = 0.0        # async_fl: re-task silos quiet
    #                                      this long
    # sustained degradation (robust/degrade.py)
    min_quorum: float = 0.0              # >0: quorum-aware close (drop)
    adaptive_deadline: bool = False      # deadline from the completion
    #                                      quantile (round_timeout_s caps)
    deadline_floor_s: float = 0.5        # adaptive deadline lower clamp
    deadline_quantile: float = 0.9       # completion quantile
    deadline_slack: float = 1.5          # deadline = quantile * slack
    partition_frac: float = 0.0          # >0: a correlated miss with
    #                                      network evidence holds the round
    partition_max_holds: int = 3         # holds before the round abandons
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
    # live secure aggregation (cross_silo, stream mode, the local hub)
    secagg: str = "off"                  # off | pairwise | grouped (edges)
    secagg_threshold: int = 0            # t of t-of-N Shamir (0 = majority)
    secagg_clip: float = 64.0            # per-coordinate clip before the ring
    # the live server-optimizer seam (cross_silo): plain | momentum | adam
    # | fedac over the finalize; --server_lr/--server_momentum and the
    # --server_adam_* and --fedac_* knobs
    server_opt: str = "plain"
    server_adam_beta1: float = 0.9
    server_adam_beta2: float = 0.999
    server_adam_eps: float = 1e-8
    edge_aggregators: int = 0            # >0: edge tier between silos
    #                                      and the root (local hub)
    wire_compression: str = "none"       # cross_silo uploads: none|topk|int8
    topk_frac: float = 0.1               # topk: fraction of entries kept
    error_feedback: bool = False         # carry the compression residual
    ingest_pipeline: bool = False        # pipelined receive path
    ingest_queue_depth: int = 64         # bounded per-shard ingest queue
    adversary: str = ""                  # "silo:kind[:param],..." attacks
    # async_fl (FedBuff-style buffered aggregation)
    async_goal: int = 0                  # aggregate every K uploads
    #                                      (0 = n_silos // 2)
    staleness_exponent: float = 0.5      # (1+s)^-alpha discount
    async_server_lr: float = 1.0         # server step on the mean
    # silo-local pipeline parallelism (cross_silo + transformer)
    mesh_stages: int = 0                 # >0: the blocks over this many
    #                                      stages (GPipe, PipelineLM)
    pp_microbatches: int = 0             # GPipe microbatches (0 = stages)
    # serving (serve/: registry + batcher + HTTP frontend), cross_silo
    serve_port: int = 0                  # >0: serve the global over HTTP
    #                                      while training (/predict,
    #                                      /healthz, /version, /metrics)
    serve_buckets: str = "1,2,4,8,16,32"  # micro-batch shape buckets
    serve_deadline_ms: float = 50.0      # default per-request deadline:
    #                                      a request that waits it out in
    #                                      the queue is shed (429)
    serve_queue_depth: int = 256         # submits past this many queued
    #                                      requests get 429
    serve_batch_delay_ms: float = 2.0    # how long the oldest queued
    #                                      request waits for batchmates
    serve_workers: int = 1               # >1: the SO_REUSEPORT pool
    serve_best_effort_headroom: float = 0.5  # queue fraction best_effort
    #                                      may fill (interactive keeps the
    #                                      rest)
    # the release gate (serve/release.py): canary -> promote or roll back
    release_gate: bool = False           # gate every published global on
    #                                      shadow divergence, health alarms
    #                                      and held-out eval (needs
    #                                      --serve_port)
    release_shadow_every: int = 16       # capture every Nth admitted
    #                                      /predict instance
    release_shadow_slots: int = 64       # shadow ring size (newest N)
    release_divergence_budget: float = 0.1  # max shadow disagreement
    release_eval_tolerance: float = 0.02  # eval regression allowed
    release_cooldown_s: float = 5.0      # refuse canaries this long after
    #                                      a rollback...
    release_backoff: float = 2.0         # ...growing per failure...
    release_max_cooldown_s: float = 60.0  # ...capped here
    # the health-driven adaptive round controller (server_opt/
    # controller.py): steers the cohort from the health observatory's
    # drift alarms, every decision named on the perf-ledger line.
    # Requires --health
    adaptive: bool = False
    adapt_min_cohort: int = 2            # adaptive: cohort backoff floor
    adapt_patience: int = 2              # adaptive: calm rounds before
    #                                      levers decay back to baseline

    # the stateful cohort algorithms
    server_optimizer: str = "sgd"        # fedopt: sgd|adam|adagrad|adamw|
    #                                      rmsprop|yogi
    server_lr: float = 1.0               # fedopt and --server_opt
    server_momentum: float = 0.9         # fedopt and --server_opt momentum
    mu: float = 0.1                      # FedProx proximal term (fednova)
    gmf: float = 0.0                     # FedNova global momentum factor
    ditto_lambda: float = 0.1            # Ditto: personalization pull
    personal_lr: float = 0.0             # Ditto: 0 -> inherit --lr
    personal_epochs: int = 0             # Ditto: 0 -> inherit --epochs
    feddyn_alpha: float = 0.01           # FedDyn: dynamic-reg strength
    fedac_mu: float = 0.0                # FedAC: >0 derives (gamma,alpha,beta)
    fedac_gamma: float = 0.0             # FedAC explicit knobs (0 -> lr)
    fedac_alpha: float = 1.0
    fedac_beta: float = 1.0
    dp_clip: float = 1.0                 # dp_fedavg: per-user L2 bound S
    dp_noise_multiplier: float = 1.0     # dp_fedavg: z (std = S*z/m)
    dp_delta: float = 1e-5               # dp_fedavg: delta of the reported eps
    dp_accounting: str = "fixed_size"    # dp_fedavg: fixed_size | poisson

    # the cross-device wave engine (--algo cross_device)
    cross_device: bool = False           # shorthand for --algo cross_device
    wave_size: int = 0                   # clients per wave (0: min(cohort,
    #                                      256))
    local_alg: str = "sgd"               # sgd | fedprox | scaffold | fednova
    sampler: str = "numpy"               # numpy (reference chain) | jax
    wave_adversary: str = ""             # "round:wave:kind[:param],..."

    # transformer attention (NWP datasets)
    attn_block_size: int = 0             # >0: blockwise attention
    attn_flash: bool = False             # the flash kernel (K4)
    moe_experts: int = 0                 # >0: the Switch MoE FFN
    mesh_sequence: int = 0               # >0 (fedavg + transformer): dp x
    #                                      sp [clients, sequence] mesh
    #                                      with ring attention

    mesh_clients: int = 0                # >0: shard the cohort over this
    #                                      many ranks (one a mesh position)
    mesh_groups: int = 0                 # >0 (hierarchical): [groups,
    #                                      clients] mesh
    host_device_count: int = 0           # CPU ranks one invocation may start
    #                                      (0: one)
    coordinator_address: Optional[str] = None  # host:port of rank 0's
    #                                      rendezvous (a process a rank)
    num_processes: int = 1
    process_id: int = 0
    client_axis: str = "vmap"            # "vmap" | "scan"
    eval_chunk_clients: int = 1024       # evaluate_global clients per call
    completion_signal: str = ""          # write the final summary line
    #                                      here on completion (a FIFO or a
    #                                      file)
    platform: Optional[str] = None       # None/"gpu" -> cuda; "cpu"
    deterministic: bool = False          # cuDNN deterministic, TF32 off
    # observability (obs/): the live paths (cross_silo, async_fl,
    # cross_device) record; ledgers land in run_dir unless given
    run_dir: Optional[str] = None        # metrics.jsonl + summary.json here
    metrics_dir: Optional[str] = None    # alias for --run_dir (wins when
    #                                      both are given)
    profile_dir: Optional[str] = None    # torch.profiler Chrome trace dir
    trace_dir: Optional[str] = None      # round spans (Perfetto
    #                                      trace_event JSON, one file per
    #                                      process)
    telemetry: bool = False              # the metric registry; snapshot at
    #                                      run_dir/telemetry.{json,prom}
    prom_port: int = 0                   # >0: live Prometheus text at
    #                                      :port/metrics (implies telemetry)
    metrics_port: int = 0                # alias for --prom_port
    perf: bool = False                   # the perf.jsonl flight recorder
    perf_ledger: Optional[str] = None    # explicit ledger path (implies
    #                                      --perf; default run_dir/perf.jsonl)
    perf_strict: bool = False            # the recompile sentry raises
    #                                      RecompileError (implies --perf)
    device_obs: bool = False             # each perf line gains a device
    #                                      section: memory watermarks, the
    #                                      compile ledger, FLOPs and MFU
    #                                      (implies --perf)
    slo: str = ""                        # SLO threshold overrides,
    #                                      "name=value,..." (obs/perf.
    #                                      DEFAULT_SLOS, incl. the health_*
    #                                      alarm thresholds)
    health: bool = False                 # the learning-health observatory:
    #                                      one health.jsonl line per round
    health_ledger: Optional[str] = None  # explicit health ledger path
    #                                      (implies --health)
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
