#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``fedml_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
each printed as it ends; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel under ``fedml_tpu_torch/csrc/``;
3. kernel robust_agg — the fused clip + noise + mean kernel against its
   plain PyTorch version at every leaf size of the FEMNIST CNN (and one
   odd size), sigma 0 and 0.025: max abs error, bit-equal noise uniforms,
   kernel / plain / ``torch.addmv`` times (CUDA events, median) and the
   memory bound;
4. slice — defended FedAvg (weak DP, fused CUDA backend) on the FEMNIST
   CNN at full width, 3400 clients, 10 per round, B=20, lr 0.1, E=1, 3
   rounds, through the CLI's runner; the kernel's launches in that run
   must cover every leaf of every round.  Then one round from the same
   init and seed words with TF32 off, held against the port on the CPU;
5. a JSON line with each kernel's numbers, and a last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, printing no result, when there is
no CUDA device or when the checkout around this file is missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, non-tensor fp32
N_CLIENTS = 10
SIGMA = 0.025                  # the weak-DP stddev of the slice
KERNEL_TOL = 1e-5              # kernel vs plain, same device
ROUND_TOL = 1e-4               # GPU round (TF32 off) vs CPU round
SLICE_ARGS = ["--algo", "fedavg_robust", "--model", "cnn_fedavg",
              "--dataset", "femnist", "--defense", "weak_dp",
              "--defense_backend", "cuda", "--client_num_in_total", "3400",
              "--client_num_per_round", str(N_CLIENTS), "--batch_size", "20",
              "--lr", "0.1", "--epochs", "1", "--comm_round", "3",
              "--frequency_of_the_test", "1000", "--log_stdout", "false"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, trials: int = 5) -> float:
    """Per-call time of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls, after a warm-up; the median of ``trials`` such
    runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int, name: str = ""):
    """Mean device time (ms) per call of ``fn``: the kernels it launches
    (those whose name contains ``name``), summed, from torch.profiler over
    ``reps`` calls; None if the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages()
                   if name in e.key)
    return total_us / reps / 1e3 if total_us > 0 else None


def _self_device_us(event) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for the rows of
    host operators, whose device time repeats their kernels'."""
    from torch.autograd import DeviceType
    if getattr(event, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def check_kernel(leaf_sizes, seed_words):
    """Phase 3: robust_agg against robust_agg_plain on the card."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s0, s1 = seed_words
    sizes = dict(leaf_sizes, odd=1_000_003)
    rows, worst = [], 0.0
    for name, d in sizes.items():
        x = torch.randn(N_CLIENTS, d, generator=gen, device=dev)
        g = torch.randn(d, generator=gen, device=dev)
        scales = torch.rand(N_CLIENTS, generator=gen, device=dev)
        scales[: N_CLIENTS // 2] = 1.0
        w = torch.rand(N_CLIENTS, generator=gen, device=dev) + 0.5
        w[-1] = 0.0
        ratios = (w / w.sum()).contiguous()
        for sigma in (0.0, SIGMA):
            args = (x, g, scales, ratios, s0, s1, sigma)
            got = fa.robust_agg(*args)
            want = fa.robust_agg_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= KERNEL_TOL:
                fail(f"robust_agg {name} (D={d}, sigma={sigma}): max abs "
                     f"err {err} > {KERNEL_TOL}")
            bits_equal = True
            if sigma:
                for client in (0, N_CLIENTS - 1):
                    ku = fa.noise_uniforms(d, s0, s1, client, dev)
                    pu = fa.noise_uniforms_plain(d, s0, s1, client, dev)
                    bits_equal &= all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(ku, pu))
                if not bits_equal:
                    fail(f"robust_agg {name}: noise uniforms differ from "
                         f"the plain version")
            kernel = lambda: fa.robust_agg(*args)
            plain = lambda: fa.robust_agg_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            ms = device_ms(kernel, 20, "robust_agg_kernel") or call_ms
            plain_ms = device_ms(plain, 3) or time_ms(plain, 3, trials=3)
            library_ms = None
            if not sigma:
                beta = float((ratios * (1 - scales)).sum())
                coef = ratios * scales
                library = lambda: torch.addmv(g, x.T, coef, beta=beta)
                library_ms = device_ms(library, 20) or time_ms(library, 50)
            nbytes = 4 * (N_CLIENTS * d + 2 * d + 2 * N_CLIENTS)
            ops = N_CLIENTS * d * (5 + (35 if sigma else 0))
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            row = dict(leaf=name, d=d, sigma=sigma, max_abs_err=err,
                       uniforms_bit_equal=bits_equal, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_us=bound_ms * 1e3,
                       bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / FP32_OPS_PER_S else "operations"))
            phase("kernel robust_agg", **row)
            rows.append(row)
        del x, g
    return rows, worst


def run_slice(data_cfg):
    """Phase 4: the full-width main path through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  run_fedavg_robust)
    from fedml_tpu_torch.utils.metrics import MetricsSink

    t0 = time.perf_counter()
    data = load_experiment_data(data_cfg)
    data_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_fedavg_robust(data_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fa.launch_counts["robust_agg"]
    need = 8 * data_cfg.comm_round
    if launches < need:
        fail(f"slice launched robust_agg {launches} times, need >= {need}")
    if not summary.get("params_finite"):
        fail("slice produced non-finite parameters")
    phase("slice", launches=launches, data_s=data_s, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return data, launches, summary


def profile_rounds(data_cfg, data, rounds: int = 5):
    """Where a round's time goes, on the slice's configuration: host
    timers (synchronised) around the cohort gather, the local training and
    the fused aggregate, for each client axis; then torch.profiler over
    ``rounds`` whole rounds for the device's busy share and its top
    kernels.  Launches here come after the main path's counts were read."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.core.fused_agg import make_fused_robust_aggregate
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)
    from fedml_tpu_torch.parallel.cohort import train_cohort

    aggregate = make_fused_robust_aggregate(norm_bound=data_cfg.norm_bound,
                                            noise_std=data_cfg.stddev)
    m = data_cfg.client_num_per_round
    result = {}
    for axis in ("vmap", "scan"):
        cfg = dataclasses.replace(data_cfg, client_axis=axis)
        algo = FedAvgRobust(_make_workload(cfg, data), data,
                            FedAvgRobustConfig(
                                defense=cfg.defense,
                                norm_bound=cfg.norm_bound, stddev=cfg.stddev,
                                defense_backend=cfg.defense_backend,
                                **_fedavg_cfg_kwargs(cfg)), device="cuda")
        params = algo.init_params()
        parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
        for r in range(rounds + 1):               # round 0 is warm-up
            words = round_seed_words(cfg.seed, r)
            t0 = time.perf_counter()
            cohort = gather_cohort(data.train,
                                   sample_clients(r, data.client_num, m),
                                   pad_to=m, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stacked, _ = train_cohort(algo._local_train, params, cohort,
                                      words, client_axis=axis)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            params = aggregate(stacked, cohort["num_samples"], params, words)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:
                parts["gather_ms"].append((t1 - t0) * 1e3)
                parts["train_ms"].append((t2 - t1) * 1e3)
                parts["aggregate_ms"].append((t3 - t2) * 1e3)
        row = {k: statistics.median(v) for k, v in parts.items()}
        row["round_ms"] = sum(row.values())

        def run_rounds():
            p = params
            for r in range(rounds):
                cohort = gather_cohort(
                    data.train, sample_clients(r, data.client_num, m),
                    pad_to=m, device="cuda")
                p, _ = algo.cohort_step(p, cohort,
                                        round_seed_words(cfg.seed, r))
            torch.cuda.synchronize()

        run_rounds()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_rounds()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
        busy_us = sum(_self_device_us(e) for e in events)
        row["profiled_round_ms"] = wall_us / rounds / 1e3
        row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
        row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
        row["kernel_launches_per_round"] = sum(
            e.count for e in events) / rounds
        top = sorted(events, key=_self_device_us, reverse=True)[:6]
        row["top_device_us_per_round"] = {
            e.key[:60]: _self_device_us(e) / rounds for e in top}
        phase(f"profile client_axis={axis}", **row)
        result[axis] = row
    return result


def round_parity(data_cfg, data):
    """One round on the GPU with TF32 off against the same round on the
    CPU: same init, same cohort, same seed words."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(data_cfg, comm_round=1)
    ids = sample_clients(0, data.client_num, cfg.client_num_per_round)
    words = round_seed_words(cfg.seed, 0)
    out = {}
    for dev in ("cuda", "cpu"):
        algo = FedAvgRobust(_make_workload(cfg, data), data,
                            FedAvgRobustConfig(
                                defense=cfg.defense,
                                norm_bound=cfg.norm_bound,
                                stddev=cfg.stddev,
                                defense_backend=cfg.defense_backend,
                                **_fedavg_cfg_kwargs(cfg)), device=dev)
        cohort = gather_cohort(data.train, ids,
                               pad_to=cfg.client_num_per_round, device=dev)
        params, _ = algo.cohort_step(algo.init_params(), cohort, words)
        out[dev] = {k: v.cpu() for k, v in params.items()}
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    phase("slice round vs cpu", max_abs_diff=diff, tol=ROUND_TOL, tf32=False)
    if not diff <= ROUND_TOL:
        fail(f"GPU round differs from the CPU round by {diff} > {ROUND_TOL}")
    return diff


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "fedml_tpu_torch" / "csrc").is_dir():
        fail(f"no fedml_tpu_torch/ beside {Path(__file__).name}; run it "
             f"from the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this check needs a GPU")
    sys.path.insert(0, str(root))
    t_start = time.perf_counter()

    smi = nvidia_smi()
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    from fedml_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.all_kernel_sources())
    phase("build", seconds=time.perf_counter() - t0,
          libraries=sorted(p.name for p in libs.values()))
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.models import CNNOriginalFedAvg
    from fedml_tpu_torch.core.pytree import tree_keys

    cnn = dict(CNNOriginalFedAvg(only_digits=False).named_parameters())
    leaf_sizes = {k.replace(".", "/"): p.numel() for k, p in cnn.items()}
    leaf_sizes = {k: leaf_sizes[k] for k in tree_keys(leaf_sizes)}
    rows, worst = check_kernel(leaf_sizes, round_seed_words(0, 0))

    cfg = config_from_argv(SLICE_ARGS)
    data, launches, summary = run_slice(cfg)
    profile_rounds(cfg, data)
    round_diff = round_parity(cfg, data)

    path = [r for r in rows if r["leaf"] in leaf_sizes]
    noisy = [r for r in path if r["sigma"]]
    clean = [r for r in path if not r["sigma"]]
    kernels = [{
        "name": "robust_agg", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/robust_agg.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:79",
        "launches": launches, "max_abs_err": worst,
        "ms": sum(r["ms"] for r in noisy),
        "plain_ms": sum(r["plain_ms"] for r in noisy),
        "bound_ms": sum(r["bound_us"] for r in noisy) / 1e3,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in noisy)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in clean),
    }]
    phase("done", seconds=time.perf_counter() - t_start,
          round_vs_cpu_max_abs_diff=round_diff,
          rounds_per_s=summary["rounds_per_s"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
