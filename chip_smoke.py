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
5. kernel secagg_mask — the fused quantize + pairwise-mask kernel against
   its plain PyTorch version at every leaf size of the CNN (and one odd
   size), groups of 5 and 10: bit-equal ring values, and the masked ring
   sum equal to the unmasked one (the masks cancel on the card); kernel /
   plain times, the wrapper's host cost, the bytes and operations bounds;
6. turboaggregate slice — secure FedAvg (two groups of 5, cuda backend) on
   the same CNN, data and widths, 3 rounds through the CLI's runner: the
   kernel launches exactly 8 leaves x 2 groups x 3 rounds; a per-part
   split of a round and the device's idle share; one round with TF32 off
   against the CPU (limit clients_per_group / scale + 1e-4); one round
   with group 1 recovered from its LCC shares against the direct round
   (limit 1e-3);
7. kernel shard_finalize — the fused shard finalize (K2) against its plain
   PyTorch version at the FEMNIST CNN's four shard sizes at S=4, at S=1,
   at sizes 3, 1 and 0 mod 4, at 3 elements (less than one float4) and on
   a view 4 bytes past a 16-byte boundary (the unaligned path), sigma 0
   (bit-equal) and 0.025 (bit-equal noise uniforms; the output within
   1e-6 abs), with a non-zero step and shard salt: device time per launch,
   the wrapper's host cost, the plain version's time and ``torch.div``'s
   by a device scalar (the same function, bit for bit) and by a Python
   float (a multiply by the reciprocal), the bytes and operations bounds;
   the path's shards at sigma 0 timed again in reverse order, the
   divisions first;
8. cross-silo slice — live cross-silo FedAvg over the in-process hub with
   the sharded spine (S=4, K2 on, clip 5.0, sigma 0.025) on the same CNN,
   data and widths, 3 rounds through the CLI's runner: K2 launches exactly
   4 x 3 times and K1 and K3 never; a per-part split of 5 rounds
   (broadcast, wire, silo training, admission, fold, finalize, eval), the
   kernel launches per round and the device's idle share; one round with
   TF32 off against the CPU (limit 1e-4);
9. kernel flash_attention — what the compiler made of K4 (each kernel's
   registers, spills and shared memory from ptxas and the library; with
   ``cuobjdump``, its tensor-core instructions in SASS: every kernel must
   have some at every head size); then K4's forward (K4f) and its
   backward's dK/dV (K4dkv) and dQ (K4dq) kernels against their plain
   PyTorch versions (TF32 off; o, m, l within 1e-5 x max|ref|, dq, dk, dv
   within 1e-4 x max|ref|) at [B, T, H, d] = [2, 2048, 8, 32] (bench.py's
   step), [8, 2048, 8, 32] (4 clients x B=2 folded by vmap), T=128, T=384
   and at d=16 and d=64 ([2, 256, 4, d]): device time per launch (CUDA
   events, median of 20), the plain versions' times,
   ``scaled_dot_product_attention``'s forward, forward + backward and
   backward alone (a yardstick), the bounds (bytes, TF32 products, exps at
   the SM's maximum clock; the f32 SIMT bound beside them) and the
   wrappers' host cost; a NaN in q and one in dO come out as NaN in every
   row they reach;
10. transformer slice — FedAvg through the API on bench.py's long-context
   TransformerLM (vocab 256, d_model 256, 8 heads, 2 layers, d_ff 1024,
   T=2048, flash on), 16 clients, 4 per round, B=2, lr 0.1, E=1, 3
   rounds: each K4 kernel launches exactly n_layers x S x rounds times in
   training, evaluation launches K4f only; a per-part split of a round,
   its launches and the device's idle share; one round with TF32 off
   against the same round with flash off (auto-blockwise, limit 1e-4);
   bench.py's long-context grad step (B=2, T=2048, 10 steps), flash on
   and off;
11. transformer cli — 3 rounds of the dense Shakespeare transformer (the
   JAX CLI's widths, 715 clients, 10 per round, B=4, SGD lr 1) through
   the CLI's runner: rounds/s and a finite loss;
12. a JSON line with each kernel's numbers (K1 and K2 also at their
   library call's configuration, sigma 0), and a last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, printing no result, when there is
no CUDA device or when the checkout around this file is missing.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, non-tensor fp32
TF32_OPS_PER_S = 495e12        # H100 SXM data sheet, dense TF32 tensor cores
SFU_EXPS_PER_CLOCK = 16 * 132  # ex2 on the special-function units: 16 a
                               # clock on each of the H100 SXM's 132 SMs
N_CLIENTS = 10
SIGMA = 0.025                  # the weak-DP stddev of the slice
KERNEL_TOL = 1e-5              # kernel vs plain, same device
ROUND_TOL = 1e-4               # GPU round (TF32 off) vs CPU round
COMMON_ARGS = ["--model", "cnn_fedavg", "--dataset", "femnist",
               "--client_num_in_total", "3400",
               "--client_num_per_round", str(N_CLIENTS), "--batch_size", "20",
               "--lr", "0.1", "--epochs", "1", "--comm_round", "3",
               "--frequency_of_the_test", "1000", "--log_stdout", "false"]
SLICE_ARGS = ["--algo", "fedavg_robust", "--defense", "weak_dp",
              "--defense_backend", "cuda", *COMMON_ARGS]
TURBO_ARGS = ["--algo", "turboaggregate", "--group_num", "2",
              "--secagg_backend", "cuda", *COMMON_ARGS]
GROUP_SIZES = (5, 10)          # secagg_mask check: the slice's group, 2x
DROPOUT_TOL = 1e-3             # tests/test_secure.py's recovery limit
SILO_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
             "--agg_mode", "stream", "--model_shards", "4",
             "--fused_finalize", "on", "--norm_clip", "5.0",
             "--agg_noise_std", str(SIGMA), *COMMON_ARGS]
K2_STEP = 7                    # shard_finalize check: a non-zero round step
K2_NOISE_TOL = 1e-6            # K2 vs plain at sigma > 0 if not bit-equal


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


@contextlib.contextmanager
def tf32_off():
    """Full-f32 convolutions and matmuls inside the block, the previous
    settings after it."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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

    cfg = dataclasses.replace(data_cfg, comm_round=1)
    ids = sample_clients(0, data.client_num, cfg.client_num_per_round)
    words = round_seed_words(cfg.seed, 0)
    out = {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            algo = FedAvgRobust(_make_workload(cfg, data), data,
                                FedAvgRobustConfig(
                                    defense=cfg.defense,
                                    norm_bound=cfg.norm_bound,
                                    stddev=cfg.stddev,
                                    defense_backend=cfg.defense_backend,
                                    **_fedavg_cfg_kwargs(cfg)), device=dev)
            cohort = gather_cohort(data.train, ids,
                                   pad_to=cfg.client_num_per_round,
                                   device=dev)
            params, _ = algo.cohort_step(algo.init_params(), cohort, words)
            out[dev] = {k: v.cpu() for k, v in params.items()}
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    phase("slice round vs cpu", max_abs_diff=diff, tol=ROUND_TOL, tf32=False)
    if not diff <= ROUND_TOL:
        fail(f"GPU round differs from the CPU round by {diff} > {ROUND_TOL}")
    return diff


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call of ``fn`` (µs): the enqueue cost, with the
    device drained before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def secagg_mask_bounds(rows: int, n: int, d: int):
    """Bytes and operations the kernel must move and do for ``rows`` client
    rows of an ``n``-client group over ``d`` elements: x read and the ring
    values written once (plus weights and seeds); per (row, element) 15
    operations for the quantize and the index hash, 10 per partner."""
    nbytes = 4 * (2 * rows * d + rows + 2 * rows * n)
    ops = rows * d * (15 + 10 * (n - 1))
    return nbytes, ops


def check_secagg_kernel(leaf_sizes):
    """Phase 5: secagg_mask against quantize_mask_plain on the card."""
    import torch
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.secure import fused_mask as fm
    from fedml_tpu_torch.secure.secagg import (quantize, ring_budget_scale,
                                               ring_sum)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    clip = 2.0**14
    sizes = dict(leaf_sizes, odd=1_000_003)
    rows_out, worst = [], 0
    for n in GROUP_SIZES:
        scale = ring_budget_scale(n, clip)
        base = fm.pair_seeds(prng.fold_in(prng.key(0), n), 0, n, n)
        for li, (name, d) in enumerate(sizes.items()):
            x = torch.randn(n, d, generator=gen, device=dev) * 3
            w = torch.rand(n, generator=gen, device=dev) + 0.5
            w[-1] = 0.0
            w = (w / w.sum()).contiguous()
            seeds = torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
            args = (x, w, seeds, 0, scale, clip)
            got = fm.quantize_mask(*args)
            want = fm.quantize_mask_plain(*args)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"secagg_mask {name} (D={d}, N={n}): ring values differ "
                     f"from the plain version (max abs {err})")
            q = quantize({"x": x * w[:, None]}, scale, clip)["x"]
            cancel = torch.equal(ring_sum({"x": got})["x"],
                                 ring_sum({"x": q})["x"])
            if not cancel:
                fail(f"secagg_mask {name} (D={d}, N={n}): the masks do not "
                     f"cancel in the ring sum")
            kernel = lambda: fm.quantize_mask(*args)
            plain = lambda: fm.quantize_mask_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            if n == GROUP_SIZES[0]:           # the main path's group size
                ms = device_ms(kernel, 20, "secagg_mask_kernel") or call_ms
                plain_ms = device_ms(plain, 3) or time_ms(plain, 3, trials=3)
            else:                             # CUDA events only
                ms, plain_ms = call_ms, time_ms(plain, 3, trials=3)
            nbytes, ops = secagg_mask_bounds(n, n, d)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            row = dict(leaf=name, d=d, n=n, bit_equal=True,
                       masks_cancel=cancel, max_abs_err=err, ms=ms,
                       call_ms=call_ms, host_us=host_us(kernel),
                       plain_ms=plain_ms, bound_us=bound_ms * 1e3,
                       bytes_us=nbytes / HBM_BYTES_PER_S * 1e6,
                       ops_us=ops / FP32_OPS_PER_S * 1e6,
                       bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / FP32_OPS_PER_S else "operations"))
            phase("kernel secagg_mask", **row)
            rows_out.append(row)
            del x, got, want, q
    return rows_out, worst


def _turbo(cfg, data, device):
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregate
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  turboaggregate_config)
    return TurboAggregate(_make_workload(cfg, data), data,
                          turboaggregate_config(cfg), device=device)


def run_turbo_slice(turbo_cfg, data):
    """Phase 6: secure FedAvg at full width through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.main import run_turboaggregate
    from fedml_tpu_torch.secure import fused_mask
    from fedml_tpu_torch.utils.metrics import MetricsSink

    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_turboaggregate(turbo_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_mask.launch_counts["secagg_mask"]
    need = 8 * turbo_cfg.group_num * turbo_cfg.comm_round
    if launches != need:
        fail(f"turboaggregate launched secagg_mask {launches} times, need "
             f"exactly {need} (8 leaves x {turbo_cfg.group_num} groups x "
             f"{turbo_cfg.comm_round} rounds)")
    if fused_agg.launch_counts["robust_agg"]:
        fail("turboaggregate launched robust_agg")
    if not summary.get("params_finite"):
        fail("turboaggregate produced non-finite parameters")
    phase("turboaggregate slice", launches=launches, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True)
    return launches, summary


def profile_turbo(turbo_cfg, data, rounds: int = 5):
    """Where a secure round's time goes: host timers (synchronised) around
    the gather, local SGD, the mask kernel, the ring sum + dequantize and
    the group combine, summed over the groups of a round; then
    torch.profiler over ``rounds`` whole rounds for the device's idle
    share.  Launches here come after the main path's counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort
    from fedml_tpu_torch.secure.secagg import ring_sum

    algo = _turbo(turbo_cfg, data, "cuda")
    agg = algo.secagg
    params = algo.init_params()
    names = ("gather_ms", "train_ms", "mask_ms", "ring_sum_dequant_ms",
             "combine_ms")
    parts = {k: [] for k in names}
    by_group = [[] for _ in range(turbo_cfg.group_num)]

    def tick(t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        return now, (now - t) * 1e3

    for r in range(rounds + 1):                   # round 0 is warm-up
        acc = dict.fromkeys(names, 0.0)
        means, weights = [], []
        keys = algo.group_keys(r)
        for g, gids in enumerate(algo.group_ids(r)):
            t = time.perf_counter()
            cohort = gather_cohort(data.train, gids,
                                   pad_to=agg.num_clients, device="cuda")
            t, dt = tick(t)
            acc["gather_ms"] += dt
            trained, _ = train_cohort(algo._local_train, params, cohort)
            t, dt = tick(t)
            acc["train_ms"] += dt
            if r:
                by_group[g].append(dt)
            num = cohort["num_samples"].to(torch.float32)
            w = num / torch.clamp(num.sum(), min=1e-12)
            masked = agg.mask_rows(trained, w, 0, keys[g])
            t, dt = tick(t)
            acc["mask_ms"] += dt
            means.append(agg.unmask_sum(ring_sum(masked), 1.0))
            weights.append(float(num.sum()))
            t, dt = tick(t)
            acc["ring_sum_dequant_ms"] += dt
        t = time.perf_counter()
        params = tree_weighted_mean(means, torch.tensor(weights))
        _, acc["combine_ms"] = tick(t)
        if r:
            for k in names:
                parts[k].append(acc[k])
    row = {k: statistics.median(v) for k, v in parts.items()}
    row["round_ms"] = sum(row.values())
    row["train_ms_by_group"] = [statistics.median(v) for v in by_group]
    alone = []                  # one group's local SGD, back to back
    for _ in range(5):
        t = time.perf_counter()
        train_cohort(algo._local_train, params, cohort)
        alone.append(tick(t)[1])
    row["train_ms_one_group_alone"] = statistics.median(alone)

    def run_rounds():
        p = params
        for r in range(rounds):
            p = algo.train_round(p, r)
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
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    row["mask_kernel_device_ms_per_round"] = sum(
        _self_device_us(e) for e in events
        if "secagg_mask_kernel" in e.key) / rounds / 1e3
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile turboaggregate", **row)
    return row


def turbo_round_parity(turbo_cfg, data):
    """One secure round with TF32 off on the GPU against the same round on
    the CPU, from the same carried init: each client's quantized value may
    flip by one quantum."""
    algo = {dev: _turbo(turbo_cfg, data, dev) for dev in ("cuda", "cpu")}
    init = algo["cpu"].init_params()
    out = {}
    with tf32_off():
        for dev, a in algo.items():
            params = a.train_round({k: v.to(dev) for k, v in init.items()},
                                   0)
            out[dev] = {k: v.cpu() for k, v in params.items()}
    tol = algo["cpu"].cfg.clients_per_group / algo["cpu"].quant_scale + 1e-4
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    phase("turboaggregate round vs cpu", max_abs_diff=diff, tol=tol,
          tf32=False)
    if not diff <= tol:
        fail(f"GPU secure round differs from the CPU round by {diff} > {tol}")
    return diff


def turbo_dropout(turbo_cfg, data):
    """One round with group 1's partial recovered from its LCC shares,
    against the direct round, on the GPU."""
    a = _turbo(turbo_cfg, data, "cuda")
    init = a.init_params()
    direct = a.train_round(init, 0)
    recovered = a.train_round(init, 0, dropped_groups=[1])
    diff = max(float((direct[k] - recovered[k]).abs().max()) for k in direct)
    phase("turboaggregate dropout", max_abs_diff=diff, tol=DROPOUT_TOL,
          dropped_groups=[1])
    if not diff < DROPOUT_TOL:
        fail(f"LCC-recovered round differs from the direct one by {diff}")
    return diff


def shard_finalize_bounds(d: int, sigma: float):
    """Bytes and operations K2 must move and do over a ``d``-element
    shard: the accumulator read once and the output written once; per
    element one division and, at sigma > 0, the noise (index hash, two
    murmur finalisers, two uniforms, log, sqrt and cos: ~35 operations, as
    PERF.md reckons K1's noise) plus its multiply and add."""
    return 8 * d, d * (1 + (37 if sigma else 0))


def shard_finalize_cases(shard_sizes):
    """K2's phase: (name, D, offset in floats) for the path's shards, the
    whole model (S=1), sizes 3, 1 and 0 mod 4, one of 3 elements (no whole
    float4) and a view one float past a 16-byte boundary (the kernel's
    unaligned path)."""
    return ([(name, d, 0) for name, d in shard_sizes.items()]
            + [("full", sum(shard_sizes.values()), 0),
               ("odd", 1_000_003, 0), ("one", 1_000_001, 0),
               ("four", 1_000_004, 0), ("three", 3, 0),
               ("unaligned", 1_000_003, 1)])


def k2_divisions(acc, wsum: float):
    """K2's yardsticks at sigma = 0: ``torch.div`` by a device scalar, the
    IEEE quotient (the same function, bit for bit); and ``torch.div`` by a
    Python float, which PyTorch computes as a multiply by the reciprocal
    (not the same function: about half the quotients differ in the last
    bit)."""
    import torch
    wsum_t = torch.tensor(wsum, dtype=torch.float32, device=acc.device)
    return lambda: torch.div(acc, wsum_t), lambda: torch.div(acc, wsum)


def check_shard_finalize(shard_sizes):
    """Phase 7: shard_finalize against shard_finalize_plain on the card."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows, worst = [], 0.0
    for salt, (name, d, off) in enumerate(shard_finalize_cases(shard_sizes),
                                          start=1):
        acc = (torch.randn(d + off, generator=gen, device=dev) * 40)[off:]
        aligned = acc.data_ptr() % 16 == 0
        if aligned != (off == 0):
            fail(f"shard_finalize {name}: the input starts "
                 f"{acc.data_ptr() % 16} bytes past a 16-byte boundary")
        wsum = 123.0
        seed_word = fa.shard_seed_word(0, salt)
        for sigma in (0.0, SIGMA):
            args = (acc, wsum, seed_word, K2_STEP, sigma)
            got = fa.shard_finalize(*args)
            want = fa.shard_finalize_plain(*args)
            torch.cuda.synchronize()
            bit_equal = torch.equal(got.view(torch.int32),
                                    want.view(torch.int32))
            err = float((got - want).abs().max())
            ulps = int((got.view(torch.int32).to(torch.int64)
                        - want.view(torch.int32).to(torch.int64))
                       .abs().max())
            worst = max(worst, err)
            if not sigma and not bit_equal:
                fail(f"shard_finalize {name} (D={d}): sigma=0 is not "
                     f"bit-equal to the plain division (max abs {err})")
            if sigma and not err <= K2_NOISE_TOL:
                fail(f"shard_finalize {name} (D={d}, sigma={sigma}): max "
                     f"abs err {err} ({ulps} ulps) > {K2_NOISE_TOL}")
            uniforms_equal = None
            if sigma:
                ku = fa.shard_uniforms(d, seed_word, K2_STEP, dev)
                pu = fa.shard_uniforms_plain(d, seed_word, K2_STEP, dev)
                uniforms_equal = all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(ku, pu))
                if not uniforms_equal:
                    fail(f"shard_finalize {name}: noise uniforms differ "
                         f"from the plain version")
            kernel = lambda: fa.shard_finalize(*args)
            plain = lambda: fa.shard_finalize_plain(*args)
            call_ms = time_ms(kernel, reps=50)
            ms = device_ms(kernel, 20, "shard_finalize_kernel") or call_ms
            plain_ms = device_ms(plain, 5) or time_ms(plain, 5, trials=3)
            library_ms = div_by_float_ms = None
            library_bit_equal = div_by_float_differs = None
            if not sigma:
                library, by_float = k2_divisions(acc, wsum)
                library_bit_equal = torch.equal(
                    library().view(torch.int32), want.view(torch.int32))
                div_by_float_differs = int(
                    (by_float().view(torch.int32)
                     != want.view(torch.int32)).sum())
                library_ms = device_ms(library, 20) or time_ms(library, 50)
                div_by_float_ms = (device_ms(by_float, 20)
                                   or time_ms(by_float, 50))
            nbytes, ops = shard_finalize_bounds(d, sigma)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            row = dict(shard=name, d=d, aligned=aligned, sigma=sigma,
                       bit_equal=bit_equal,
                       max_ulps=ulps, max_abs_err=err,
                       uniforms_bit_equal=uniforms_equal, ms=ms,
                       call_ms=call_ms, host_us=host_us(kernel),
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_bit_equal=library_bit_equal,
                       div_by_float_ms=div_by_float_ms,
                       div_by_float_differs=div_by_float_differs,
                       bound_us=bound_ms * 1e3,
                       bytes_us=nbytes / HBM_BYTES_PER_S * 1e6,
                       ops_us=ops / FP32_OPS_PER_S * 1e6,
                       bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / FP32_OPS_PER_S else "operations"))
            phase("kernel shard_finalize", **row)
            rows.append(row)
            del got, want
        del acc
    # sigma = 0 once more, the path's shards in reverse order and both
    # divisions timed before the kernel: does a gap seen in the first shard
    # timed follow the shard or the order?
    again = {}
    for name, d in reversed(list(shard_sizes.items())):
        acc = torch.randn(d, generator=gen, device=dev) * 40
        args = (acc, 123.0, fa.shard_seed_word(0, 1), K2_STEP, 0.0)
        library, by_float = k2_divisions(acc, 123.0)
        kernel = lambda: fa.shard_finalize(*args)
        library_ms = device_ms(library, 20) or time_ms(library, 50)
        div_by_float_ms = device_ms(by_float, 20) or time_ms(by_float, 50)
        ms = (device_ms(kernel, 20, "shard_finalize_kernel")
              or time_ms(kernel, 50))
        again[name] = dict(d=d, ms=ms, library_ms=library_ms,
                           div_by_float_ms=div_by_float_ms)
        del acc
    phase("kernel shard_finalize retimed", sigma=0.0, order=list(again),
          shards=again, **{k: sum(r[k] for r in again.values())
                           for k in ("ms", "library_ms", "div_by_float_ms")})
    return rows, worst


def run_silo_slice(silo_cfg, data):
    """Phase 8: live cross-silo FedAvg with the sharded spine at full
    width through the CLI's runner."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.main import run_cross_silo
    from fedml_tpu_torch.secure import fused_mask
    from fedml_tpu_torch.utils.metrics import MetricsSink

    fused_agg.reset_launch_counts()
    fused_mask.reset_launch_counts()
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_cross_silo(silo_cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fused_agg.launch_counts["shard_finalize"]
    need = silo_cfg.model_shards * silo_cfg.comm_round
    if launches != need:
        fail(f"cross_silo launched shard_finalize {launches} times, need "
             f"exactly {need} ({silo_cfg.model_shards} shards x "
             f"{silo_cfg.comm_round} rounds)")
    if fused_agg.launch_counts["robust_agg"] \
            or fused_mask.launch_counts["secagg_mask"]:
        fail("cross_silo launched robust_agg or secagg_mask")
    if not summary.get("params_finite"):
        fail("cross_silo produced non-finite parameters")
    phase("cross_silo slice", launches=launches, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True)
    return launches, summary


class PartTimer:
    """Exclusive host time (synchronised) of wrapped methods, by part:
    time spent in a wrapped call nested inside another is charged to the
    inner part only."""

    def __init__(self):
        self.totals = {}
        self._stack = []

    def wrap(self, owner, attr: str, part: str) -> None:
        import torch
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.totals[part] = self.totals.get(part, 0.0) + dt - inner
                if self._stack:
                    self._stack[-1] += dt

        setattr(owner, attr, timed)


def profile_silo(silo_cfg, data, rounds: int = 5):
    """Where a cross-silo round's time goes: exclusive host time
    (synchronised) of each part over ``rounds`` rounds after a warm-up
    round, evaluating every round; then torch.profiler over ``rounds``
    whole rounds (no evaluation inside the window) for the device's busy
    share, its launches and K2's device time.  Launches here come after
    the main path's counts were read."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink

    cfg = dataclasses.replace(silo_cfg, comm_round=rounds + 1,
                              frequency_of_the_test=1)
    timer = PartTimer()
    per_round = []
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink)
        server = fed.server
        timer.wrap(server, "_broadcast", "broadcast_ms")
        timer.wrap(fed.hub, "route", "wire_encode_decode_ms")
        for silo in fed.silos:
            timer.wrap(silo, "_train", "silo_train_ms")
            timer.wrap(silo, "_on_shard_sync", "silo_join_split_ms")
        timer.wrap(server.shard_wire.admission, "offer", "admission_ms")
        timer.wrap(server.stream_agg, "fold_slices", "fold_ms")
        timer.wrap(server.stream_agg, "finalize", "finalize_ms")
        timer.wrap(server, "on_round_done", "eval_ms")
        done = server.on_round_done
        mark = {"t": time.perf_counter(), "totals": {}}

        def on_round_done(r, params):
            done(r, params)
            now = time.perf_counter()
            row = {k: (v - mark["totals"].get(k, 0.0)) * 1e3
                   for k, v in timer.totals.items()}
            row["round_ms"] = (now - mark["t"]) * 1e3
            row["other_ms"] = row["round_ms"] - sum(
                v for k, v in row.items() if k != "round_ms")
            per_round.append(row)
            mark.update(t=now, totals=dict(timer.totals))

        server.on_round_done = on_round_done
        fed.run()
    steady = per_round[1:]
    row = {k: statistics.median(r.get(k, 0.0) for r in steady)
           for k in steady[0]}

    # the device's view: rounds 1..rounds, started after round 0's
    # evaluation and stopped before the last round's
    cfg = dataclasses.replace(silo_cfg, comm_round=rounds + 1,
                              frequency_of_the_test=1000)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink)
        done = fed.server.on_round_done

        def on_round_done(r, params):
            if r == rounds:
                torch.cuda.synchronize()
                window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
                prof.stop()
            done(r, params)
            if r == 0:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()

        fed.server.on_round_done = on_round_done
        fed.run()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    wall_us = window["wall_us"]
    row["profiled_round_ms"] = wall_us / rounds / 1e3
    row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
    row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    k2 = [e for e in events if "shard_finalize_kernel" in e.key]
    row["k2_launches_per_round"] = sum(e.count for e in k2) / rounds
    row["k2_device_ms_per_round"] = sum(
        _self_device_us(e) for e in k2) / rounds / 1e3
    row["k2_share_of_round"] = (row["k2_device_ms_per_round"]
                                / row["profiled_round_ms"])
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile cross_silo", **row)
    return row


def silo_round_parity(silo_cfg, data):
    """One cross-silo round with TF32 off on the GPU against the same
    round on the CPU, from one init (no evaluation)."""
    import dataclasses
    import torch
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink

    out = {}
    with MetricsSink(None) as sink:
        cpu = CrossSiloFederation(dataclasses.replace(
            silo_cfg, comm_round=1, platform="cpu"), data, sink)
        init = {k: v.clone() for k, v in cpu.server.params.items()}
        gpu = CrossSiloFederation(dataclasses.replace(
            silo_cfg, comm_round=1, platform="cuda"), data, sink,
            init_params=init)
        with tf32_off():
            for name, fed in (("cuda", gpu), ("cpu", cpu)):
                fed.server.on_round_done = None
                fed.run()
                out[name] = {k: v.cpu() for k, v in fed.server.params.items()}
    diff = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    moved = max(float((out["cpu"][k] - init[k]).abs().max()) for k in init)
    phase("cross_silo round vs cpu", max_abs_diff=diff, tol=ROUND_TOL,
          tf32=False, moved_from_init=moved)
    if not moved > 10 * ROUND_TOL:
        fail(f"the cross-silo round left the global where it was "
             f"(moved {moved})")
    if not diff <= ROUND_TOL:
        fail(f"GPU cross-silo round differs from the CPU round by {diff} > "
             f"{ROUND_TOL}")
    return diff


# ---------------------------------------------------------------------------
# slice 4: FedAvg on the transformer LM, through K4 (flash attention)
# ---------------------------------------------------------------------------

FLASH_SHAPES = {               # [B, T, H, d], as the model calls the kernels
    "bench": (2, 2048, 8, 32),     # bench.py's long-context step
    "vmap": (8, 2048, 8, 32),      # 4 clients x B=2, the vmap fold
    "t128": (2, 128, 8, 32),       # one 128 block: diagonal tiles only
    "t384": (2, 384, 8, 32),       # three blocks
    "d16": (2, 256, 4, 16),        # the other head sizes the kernels take
    "d64": (2, 256, 4, 64),
}
FLASH_O_TOL = 1e-5             # x max|ref|: o, m, l against the plain version
FLASH_GRAD_TOL = 1e-4          # x max|ref|: dq, dk, dv
# bench.py:514-521's model, trained through the FedAvg API
LM = dict(vocab_size=256, d_model=256, n_heads=8, n_layers=2, d_ff=1024,
          max_len=2048)
LM_DATA = dict(sample_shape=(2048,), sequence_vocab=256, class_num=256,
               num_clients=16, samples_per_client=4, batch_size=2)
LM_FEDAVG = dict(client_num_per_round=4, batch_size=2, lr=0.1, epochs=1,
                 client_axis="vmap")
LM_ROUNDS = 3
LM_BENCH_STEPS = 10
LM_BENCH_BLOCK = 256           # bench.py's blockwise attention block
# the dense CLI path: the JAX CLI's transformer widths on the Shakespeare
# twin, BASELINE.md row 20's clients (715, 10 per round, B=4, SGD lr 1, E=1)
CLI_LM_ARGS = ["--algo", "fedavg", "--model", "transformer", "--dataset",
               "shakespeare", "--client_num_in_total", "715",
               "--client_num_per_round", "10", "--batch_size", "4", "--lr",
               "1.0", "--epochs", "1", "--comm_round", "3",
               "--frequency_of_the_test", "1000", "--log_stdout", "false"]
# the library's kernel bodies: _flash_attention_kernel,
# _flash_attention_dkv_kernel and _flash_attention_dq_kernel
K4_REPLACES = {"flash_fwd": 331, "flash_bwd_dkv": 796, "flash_bwd_dq": 1146}


def launch_ms(fn, n: int = 20) -> float:
    """Median device time (ms) of one call of ``fn``: CUDA events around
    each of ``n`` calls, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sm_clocks_hz():
    """The SM clock now and its maximum (``nvidia-smi``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now) * 1e6, float(top) * 1e6


def flash_bounds(b: int, h: int, t: int, d: int, sm_hz: float):
    """Per kernel, the least time the card could take (ms): the largest of
    its bytes over 3.35 TB/s (each input read once, each output written
    once: [B, H, T, d] rows, [B, H, T] m, l, di), its multiply-adds over
    the 495 TFLOP/s TF32 tensor-core rate (the causal half, 2 operations
    each: 4 d per visible (query, key) pair forward, 8 d for dK/dV, 6 d
    for dQ) and its exps (one per visible pair) at the SFU's 16 per clock
    per SM at the SM clock ``sm_hz``.  ``bound_by`` is "bytes" or
    "operations" (products or exps; ``bound_term`` says which).  The same
    operations over the 67 TFLOP/s f32 rate outside the tensor cores stay
    beside them as ``f32_simt_bound_ms``."""
    rows, vecs = 4 * b * h * t * d, 4 * b * h * t
    pairs = b * h * t * (t + 1) / 2
    work = {"flash_fwd": (4 * rows + 2 * vecs, 4 * d * pairs),
            "flash_bwd_dkv": (6 * rows + 3 * vecs, 8 * d * pairs),
            "flash_bwd_dq": (5 * rows + 3 * vecs, 6 * d * pairs)}
    out = {}
    for name, (nbytes, ops) in work.items():
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "tf32": ops / TF32_OPS_PER_S * 1e3,
                 "exp": pairs / (SFU_EXPS_PER_CLOCK * sm_hz) * 1e3}
        term = max(terms, key=terms.get)
        out[name] = dict(bound_ms=terms[term],
                         bound_by="bytes" if term == "bytes"
                         else "operations",
                         bound_term=term,
                         **{f"{k}_ms": v for k, v in terms.items()},
                         f32_simt_bound_ms=ops / FP32_OPS_PER_S * 1e3)
    return out


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each entry function,
    from ``nvcc -Xptxas -v``'s log."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            fn = hit.group(1)
            out[fn] = {}
        elif fn is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("smem_static", r"(\d+) bytes smem")):
                hit = re.search(pat, line)
                if hit:
                    out[fn][key] = int(hit.group(1))
    return out


def sass_tensor_core_counts(lib_path: Path):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel's SASS, by
    entry function; None when the toolkit has no ``cuobjdump``."""
    from fedml_tpu_torch.utils import cuda_build
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:500]}")
    return tensor_core_counts(out.stdout)


def tensor_core_counts(sass: str):
    """HMMA and HGMMA instructions in each function of ``cuobjdump -sass``
    output, by function name."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    return counts


def flash_smem_bytes(kernel: str, d: int) -> int:
    """The dynamic shared memory (bytes) a launch of ``kernel`` takes at
    head size ``d``: ``kv_smem_bytes`` and ``dkv_smem_bytes`` of
    ``csrc/flash_attention.cu``, two buffers of 64-row tiles padded to
    d + 4 floats (K4f and K4dq: K and V; K4dkv: Q and dO, then m, l and
    di)."""
    tile = 64 * (d + 4)
    per_buffer = {"flash_fwd": 2 * tile, "flash_bwd_dkv": 2 * tile + 3 * 64,
                  "flash_bwd_dq": 2 * tile}[kernel]
    return 2 * per_buffer * 4


def check_flash_build(lib_path: Path):
    """What the compiler made of K4: each kernel's registers, spills and
    shared memory (static from ptxas, dynamic from the kernels' formula),
    and its tensor-core instructions in SASS.  Fails if an instantiation of
    any of them has none."""
    from fedml_tpu_torch.models import flash_attention as fa
    from fedml_tpu_torch.utils import cuda_build
    ptxas = ptxas_report(cuda_build.build_log("flash_attention"))
    sass = sass_tensor_core_counts(lib_path)
    if sass is None:
        print("cuobjdump not found: tensor-core instructions not counted",
              flush=True)
    report = {}
    for kernel in fa.launch_counts:
        for d in fa.KERNEL_HEAD_DIMS:
            key = f"{kernel}_kernelILi{d}E"
            [fn] = [f for f in ptxas if key in f]
            row = dict(ptxas[fn], smem_dynamic=flash_smem_bytes(kernel, d))
            if sass is not None:
                row["tensor_core_sass"] = sum(
                    n for f, n in sass.items() if key in f)
                if not row["tensor_core_sass"]:
                    fail(f"{kernel} (d={d}) has no tensor-core instruction "
                         f"in its SASS")
            report[f"{kernel}/d{d}"] = row
    phase("kernel flash_attention build", kernels=report,
          sass_checked=sass is not None)
    return report


def check_flash_kernel():
    """Phase: K4f, K4dkv and K4dq against their plain versions on the card
    (TF32 off), at every shape of FLASH_SHAPES; their times, the plain
    versions', scaled_dot_product_attention's (a yardstick the port never
    calls: its forward, and its backward alone as forward + backward less
    forward), the bounds at the SM's maximum clock and the wrappers' host
    cost."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from fedml_tpu_torch.models import flash_attention as fa

    rows, worst = {}, {n: 0.0 for n in fa.launch_counts}
    sm_now_hz, sm_hz = sm_clocks_hz()
    phase("kernel flash_attention clocks", sm_clock_mhz=sm_now_hz / 1e6,
          sm_clock_max_mhz=sm_hz / 1e6)
    with tf32_off():
        for shape_name, (b, t, h, d) in FLASH_SHAPES.items():
            rng = np.random.RandomState(b * 10000 + t)
            q, k, v, do = (torch.tensor(rng.randn(b, h, t, d)
                                        .astype(np.float32)).cuda()
                           for _ in range(4))
            o, m, l = fa.flash_fwd(q, k, v)
            po, pm, pl = fa.flash_fwd_plain(q, k, v)
            di = (po * do).sum(-1)
            bwd = (q, k, v, do, pm, pl, di)
            dk, dv = fa.flash_bwd_dkv(*bwd)
            pdk, pdv = fa.flash_bwd_dkv_plain(*bwd)
            dq = fa.flash_bwd_dq(*bwd)
            pdq = fa.flash_bwd_dq_plain(*bwd)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for key, kernel, got, want, tol in (
                    ("o", "flash_fwd", o, po, FLASH_O_TOL),
                    ("m", "flash_fwd", m, pm, FLASH_O_TOL),
                    ("l", "flash_fwd", l, pl, FLASH_O_TOL),
                    ("dk", "flash_bwd_dkv", dk, pdk, FLASH_GRAD_TOL),
                    ("dv", "flash_bwd_dkv", dv, pdv, FLASH_GRAD_TOL),
                    ("dq", "flash_bwd_dq", dq, pdq, FLASH_GRAD_TOL)):
                err = float((got - want).abs().max())
                limit = tol * float(want.abs().max())
                errs[key] = err
                rel[key] = err / float(want.abs().max())
                if key not in ("m", "l"):
                    worst[kernel] = max(worst[kernel], err)
                if not err <= limit:
                    fail(f"{kernel} {shape_name} {(b, t, h, d)}: {key} max "
                         f"abs err {err} > {limit} ({tol} x max|ref|)")
            calls = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                              lambda: fa.flash_fwd_plain(q, k, v)),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                                  lambda: fa.flash_bwd_dkv_plain(*bwd)),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd),
                                 lambda: fa.flash_bwd_dq_plain(*bwd)),
            }
            bounds = flash_bounds(b, h, t, d, sm_hz)
            row = {"shape_BTHd": [b, t, h, d], "max_abs_err": errs,
                   "err_over_max_ref": rel}
            for name, (kernel, plain) in calls.items():
                row[name] = dict(ms=launch_ms(kernel, 20),
                                 plain_ms=launch_ms(plain, 5),
                                 host_us=host_us(kernel, 20), **bounds[name])
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg,
                                                     is_causal=True)
                torch.autograd.grad(out, (qg, kg, vg), do)

            row["sdpa_fwd_ms"] = launch_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True), 20)
            row["sdpa_fwd_bwd_ms"] = launch_ms(sdpa_fwd_bwd, 10)
            row["sdpa_bwd_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
            row["k4_fwd_bwd_ms"] = sum(row[n]["ms"] for n in calls)
            row["k4_bwd_ms"] = (row["flash_bwd_dkv"]["ms"]
                                + row["flash_bwd_dq"]["ms"])
            phase("kernel flash_attention", shape=shape_name, **row)
            rows[shape_name] = row
            del q, k, v, do, qg, kg, vg
    return rows, worst


# a NaN in q and one in dO at (b, h, row) of the t384 shape
FLASH_NAN_AT = {"q": (0, 1, 200), "do": (1, 5, 70)}


def flash_nan_inputs(device):
    """q, k, v, dO [B, H, T, d] of the t384 shape, unit normal from a
    seed, with one NaN in the q row and one in the dO row of
    FLASH_NAN_AT."""
    import numpy as np
    import torch
    b, t, h, d = FLASH_SHAPES["t384"]
    rng = np.random.RandomState(384)
    q, k, v, do = (torch.tensor(rng.randn(b, h, t, d).astype(np.float32),
                                device=device) for _ in range(4))
    q[(*FLASH_NAN_AT["q"], 3)] = float("nan")
    do[(*FLASH_NAN_AT["do"], 5)] = float("nan")
    return q, k, v, do


def flash_chain(q, k, v, do, fwd, dkv, dq):
    """The model's chain through three attention functions: the forward,
    di = sum(o dO), then both backward halves on the forward's m and l."""
    o, m, l = fwd(q, k, v)
    di = (o * do).sum(-1)
    dk, dv = dkv(q, k, v, do, m, l, di)
    return {"o": o, "dk": dk, "dv": dv, "dq": dq(q, k, v, do, m, l, di)}


def flash_nan_rows(shape):
    """[B, H, T] masks of the output rows that depend on FLASH_NAN_AT's
    NaNs through visible (query, key) pairs and so must be NaN: q's row r
    reaches o and dq at r and dk, dv at keys <= r; dO's row r reaches dq
    at r and dk, dv at keys <= r."""
    import torch
    b, h, t = shape
    must = {n: torch.zeros(b, h, t, dtype=torch.bool)
            for n in ("o", "dk", "dv", "dq")}
    for src, (bi, hi, r) in FLASH_NAN_AT.items():
        if src == "q":
            must["o"][bi, hi, r] = True
        must["dq"][bi, hi, r] = True
        must["dk"][bi, hi, :r + 1] = True
        must["dv"][bi, hi, :r + 1] = True
    return must


def flash_nan_problems(got, want):
    """What is wrong with the outputs ``got`` of a chain through
    FLASH_NAN_AT's inputs against the plain chain's ``want``: a row that
    must be NaN and is not, or, on the rows where ``want`` is finite, an
    error over the chip limits (1e-5 x max|ref| for o, 1e-4 for the
    gradients).  The plain versions' dense products spread a NaN further
    (0 x NaN past the diagonal), so rows outside the dependent ones may be
    NaN on either side only where ``want`` has them."""
    problems = []
    must = flash_nan_rows(want["o"].shape[:3])
    for name, ref in want.items():
        out = got[name]
        nan_rows = out.isnan().any(-1).cpu()
        missing = int((must[name] & ~nan_rows).sum())
        if missing:
            problems.append(f"{name}: {missing} rows that depend on a NaN "
                            f"input are not NaN")
        finite = ~ref.isnan().any(-1)
        tol = FLASH_O_TOL if name == "o" else FLASH_GRAD_TOL
        err = float((out[finite] - ref[finite]).abs().max())
        limit = tol * float(ref[finite].abs().max())
        if not err <= limit:
            problems.append(f"{name}: max abs err {err} > {limit} on the "
                            f"rows the plain version keeps finite")
    return problems


def check_flash_nan():
    """Phase: a NaN in q and in dO comes out of K4f, K4dkv and K4dq as
    NaN wherever it reaches through a visible pair (the plain versions'
    behaviour), and the other rows keep to the chip limits."""
    import torch
    from fedml_tpu_torch.models import flash_attention as fa
    with tf32_off():
        inputs = flash_nan_inputs("cuda")
        got = flash_chain(*inputs, fa.flash_fwd, fa.flash_bwd_dkv,
                          fa.flash_bwd_dq)
        want = flash_chain(*inputs, fa.flash_fwd_plain,
                           fa.flash_bwd_dkv_plain, fa.flash_bwd_dq_plain)
        torch.cuda.synchronize()
    problems = flash_nan_problems(got, want)
    phase("kernel flash_attention nan", nan_at=FLASH_NAN_AT,
          nan_rows={n: int(x.isnan().any(-1).sum()) for n, x in got.items()},
          plain_nan_rows={n: int(x.isnan().any(-1).sum())
                          for n, x in want.items()},
          problems=problems)
    if problems:
        fail(f"flash attention with NaN inputs: {problems}")


def lm_data():
    from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
    return synthetic_federated_dataset(**LM_DATA)


def lm_fedavg(data, use_flash: bool, comm_round: int = LM_ROUNDS):
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    return FedAvg(NWPWorkload(TransformerLM(**LM, use_flash=use_flash)),
                  data, FedAvgConfig(comm_round=comm_round,
                                     frequency_of_the_test=comm_round,
                                     **LM_FEDAVG), device="cuda")


def run_lm_slice(data):
    """The transformer slice's main path: FedAvg through the API on the
    flash model, LM_ROUNDS rounds with an evaluation at the first and the
    last.  Every K4 kernel must launch n_layers x S x rounds times in the
    training window; evaluation launches only K4f (counted apart)."""
    import torch
    from fedml_tpu_torch.models import flash_attention as fa

    algo = lm_fedavg(data, use_flash=True)
    evaluate, eval_counts = algo.evaluate_global, dict.fromkeys(
        fa.launch_counts, 0)

    def counted_eval(params):
        before = dict(fa.launch_counts)
        out = evaluate(params)
        for k in before:
            eval_counts[k] += fa.launch_counts[k] - before[k]
        return out

    algo.evaluate_global = counted_eval
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    params = algo.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = dict(fa.launch_counts)
    train = {k: total[k] - eval_counts[k] for k in total}
    steps = int(data.train["mask"].shape[1]) * LM_FEDAVG["epochs"]
    need = LM["n_layers"] * steps * LM_ROUNDS
    if any(n != need for n in train.values()):
        fail(f"the transformer slice's training launched {train}; each K4 "
             f"kernel must launch n_layers x S x rounds = {need} times")
    if eval_counts["flash_bwd_dkv"] or eval_counts["flash_bwd_dq"] \
            or not eval_counts["flash_fwd"]:
        fail(f"evaluation launched {eval_counts}; it runs K4f only")
    last = algo.history[-1]
    finite = all(bool(v.isfinite().all()) for v in params.values())
    if not finite or not all(
            float(last[k]) == float(last[k]) for k in ("train_loss",
                                                       "test_loss")):
        fail(f"the transformer slice produced non-finite values: {last}")
    steady = algo.round_times[1:]
    phase("transformer slice", train_launches=train,
          eval_launches=eval_counts, launches_per_round=need // LM_ROUNDS,
          steps_per_round=steps, run_s=run_s,
          rounds_per_s=len(steady) / sum(steady),
          train_loss=last["train_loss"], test_loss=last["test_loss"],
          test_acc=last["test_acc"], params_finite=finite,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return total, need // LM_ROUNDS, len(steady) / sum(steady)


def profile_lm(data, rounds: int = 5):
    """Where a transformer round's time goes: host timers (synchronised)
    around the cohort gather, the local SGD and the weighted mean; then
    torch.profiler over ``rounds`` whole rounds for the device's busy
    share, the launches per round and K4's share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort

    algo = lm_fedavg(data, use_flash=True)
    m = LM_FEDAVG["client_num_per_round"]
    params = algo.init_params()
    parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
    for r in range(rounds + 1):                  # round 0 is warm-up
        t0 = time.perf_counter()
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stacked, _ = train_cohort(algo._local_train, params, cohort,
                                  client_axis="vmap")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params = tree_weighted_mean(stacked, cohort["num_samples"])
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
            cohort = gather_cohort(data.train,
                                   sample_clients(r, data.client_num, m),
                                   pad_to=m, device="cuda")
            p, _ = algo.cohort_step(p, cohort)
        torch.cuda.synchronize()

    run_rounds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_rounds()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    k4_us = sum(_self_device_us(e) for e in events if "flash_" in e.key)
    row["profiled_round_ms"] = wall_us / rounds / 1e3
    row["device_busy_ms_per_round"] = busy_us / rounds / 1e3
    row["k4_device_ms_per_round"] = k4_us / rounds / 1e3
    row["device_idle_share"] = (1 - busy_us / wall_us) if busy_us else None
    row["kernel_launches_per_round"] = sum(e.count for e in events) / rounds
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    row["top_device_us_per_round"] = {
        e.key[:60]: _self_device_us(e) / rounds for e in top}
    phase("profile transformer", **row)
    return row


def lm_round_parity(data):
    """One round with TF32 off through K4 against the same round with
    ``use_flash=False`` (at T=2048 the JAX package's non-flash path:
    auto-blockwise attention, block 512), from one init and one cohort."""
    import torch
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort

    m = LM_FEDAVG["client_num_per_round"]
    cohort = gather_cohort(data.train, sample_clients(0, data.client_num, m),
                           pad_to=m, device="cuda")
    out = {}
    with tf32_off():
        for use_flash in (True, False):
            algo = lm_fedavg(data, use_flash, comm_round=1)
            init = algo.init_params()
            params, _ = algo.cohort_step(init, cohort)
            out[use_flash] = {k: v.cpu() for k, v in params.items()}
    init = {k: v.cpu() for k, v in init.items()}
    diff = max(float((out[True][k] - out[False][k]).abs().max())
               for k in init)
    moved = max(float((out[False][k] - init[k]).abs().max()) for k in init)
    phase("transformer round flash vs blockwise", max_abs_diff=diff,
          tol=ROUND_TOL, tf32=False, moved_from_init=moved)
    if not moved > 10 * ROUND_TOL:
        fail(f"the transformer round left the global where it was "
             f"(moved {moved})")
    if not diff <= ROUND_TOL:
        fail(f"the flash round differs from the blockwise round by {diff} "
             f"> {ROUND_TOL}")
    return diff


def lm_bench_step():
    """bench.py's long-context grad step (B=2, T=2048, LM_BENCH_STEPS
    steps): the gradient of the mean next-token cross-entropy, flash on
    and off (off is bench.py's blockwise attention, block 256)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.func import grad
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.trainer.workload import NWPWorkload, apply_model

    b, t = 2, LM["max_len"]
    toks = torch.tensor(np.random.RandomState(0).randint(
        0, LM["vocab_size"], (b, t)))
    toks = toks.cuda()
    y = torch.cat([toks[:, 1:], toks[:, :1]], dim=1).reshape(-1)
    out = {}
    for use_flash in (True, False):
        model = TransformerLM(**LM, use_flash=use_flash,
                              block_size=None if use_flash
                              else LM_BENCH_BLOCK)
        params = NWPWorkload(model).init(torch.Generator().manual_seed(0),
                                         "cuda")

        def loss_fn(p):
            logits = apply_model(model, p, toks).float()
            return F.cross_entropy(logits.reshape(b * t, -1), y)

        step = grad(loss_fn)
        step(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_BENCH_STEPS):
            g = step(params)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / LM_BENCH_STEPS
        if not all(bool(v.isfinite().all()) for v in g.values()):
            fail(f"the long-context grad step (flash={use_flash}) is not "
                 f"finite")
        out["flash" if use_flash else "blockwise"] = dict(
            step_ms=step_s * 1e3, steps_per_s=1 / step_s,
            tokens_per_s=b * t / step_s)
    phase("transformer long-context grad step", **out)
    return out


def run_lm_cli():
    """The dense CLI path: 3 rounds of the Shakespeare transformer through
    the CLI's runner."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (load_experiment_data,
                                                  run_fedavg)
    from fedml_tpu_torch.utils.metrics import MetricsSink

    cfg = config_from_argv(CLI_LM_ARGS)
    t0 = time.perf_counter()
    data = load_experiment_data(cfg)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with MetricsSink(None) as sink:
        summary = run_fedavg(cfg, data, sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    loss = float(summary["train_loss"])
    if not summary.get("params_finite") or not loss == loss:
        fail(f"the transformer CLI run is not finite: {summary}")
    phase("transformer cli", data_s=data_s, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"], train_loss=loss,
          test_loss=summary["test_loss"], test_acc=summary["test_acc"],
          params_finite=True)
    return summary


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

    mask_rows, mask_worst = check_secagg_kernel(leaf_sizes)
    turbo_cfg = config_from_argv(TURBO_ARGS)
    mask_launches, turbo = run_turbo_slice(turbo_cfg, data)
    profile_turbo(turbo_cfg, data)
    turbo_diff = turbo_round_parity(turbo_cfg, data)
    dropout_diff = turbo_dropout(turbo_cfg, data)

    from fedml_tpu_torch.shard_spine import build_shard_plan
    silo_cfg = config_from_argv(SILO_ARGS)
    plan = build_shard_plan({k.replace(".", "/"): p.detach()
                             for k, p in cnn.items()}, silo_cfg.model_shards)
    shard_sizes = {f"s{i}": plan.slice_numel(i)
                   for i in range(plan.num_shards)}
    k2_rows, k2_worst = check_shard_finalize(shard_sizes)
    k2_launches, silo = run_silo_slice(silo_cfg, data)
    profile_silo(silo_cfg, data)
    silo_diff = silo_round_parity(silo_cfg, data)

    flash_build = check_flash_build(libs["flash_attention"])
    flash_rows, flash_worst = check_flash_kernel()
    check_flash_nan()
    data_lm = lm_data()
    k4_launches, k4_per_round, lm_rounds_per_s = run_lm_slice(data_lm)
    profile_lm(data_lm)
    lm_diff = lm_round_parity(data_lm)
    lm_bench = lm_bench_step()
    lm_cli = run_lm_cli()

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
        # the kernel at the library call's configuration (sigma = 0): no
        # single PyTorch call computes the noisy function
        "ms_at_library_config": sum(r["ms"] for r in clean),
    }]
    # one round of the secure slice: 8 leaves x group_num groups of 5
    group = [r for r in mask_rows if r["leaf"] in leaf_sizes
             and r["n"] == GROUP_SIZES[0]]
    per_round = turbo_cfg.group_num
    kernels.append({
        "name": "secagg_mask", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/secagg_mask.cu",
        "replaces": "fedml_tpu/secure/pallas_mask.py:72",
        "launches": mask_launches, "max_abs_err": mask_worst,
        "ms": per_round * sum(r["ms"] for r in group),
        "plain_ms": per_round * sum(r["plain_ms"] for r in group),
        "bound_ms": per_round * sum(r["bound_us"] for r in group) / 1e3,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in group)
                     else "operations"),
        "library_ms": None,
    })
    # one round of the cross-silo slice: one launch per S=4 shard
    shards = [r for r in k2_rows if r["shard"] in shard_sizes
              and r["sigma"]]
    clean = [r for r in k2_rows if r["shard"] in shard_sizes
             and not r["sigma"]]
    kernels.append({
        "name": "shard_finalize", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/shard_finalize.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:140",
        "launches": k2_launches, "max_abs_err": k2_worst,
        "ms": sum(r["ms"] for r in shards),
        "plain_ms": sum(r["plain_ms"] for r in shards),
        "bound_ms": sum(r["bound_us"] for r in shards) / 1e3,
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in shards) else "operations"),
        "library_ms": sum(r["library_ms"] for r in clean),
        "ms_at_library_config": sum(r["ms"] for r in clean),
        "div_by_float_ms": sum(r["div_by_float_ms"] for r in clean),
    })
    # one training round of the transformer slice: n_layers x S launches of
    # each K4 kernel at the vmapped shape (4 clients x B=2)
    vmapped = flash_rows["vmap"]
    for name, line in K4_REPLACES.items():
        row = vmapped[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py"
                         f":{line} (via fedml_tpu/models/transformer.py:55)"),
            "launches": k4_launches[name], "max_abs_err": flash_worst[name],
            "ms": k4_per_round * row["ms"],
            "plain_ms": k4_per_round * row["plain_ms"],
            "bound_ms": k4_per_round * row["bound_ms"],
            "bound_by": row["bound_by"], "bound_term": row["bound_term"],
            "tensor_core_sass": flash_build[f"{name}/d32"].get(
                "tensor_core_sass"),
            "library_ms": (k4_per_round * vmapped["sdpa_fwd_ms"]
                           if name == "flash_fwd" else None),
        })
        if name == "flash_bwd_dq":
            # no single call computes dQ alone: SDPA's backward (dq, dk,
            # dv) against K4dkv + K4dq, per round
            kernels[-1]["sdpa_bwd_ms"] = k4_per_round * vmapped["sdpa_bwd_ms"]
            kernels[-1]["k4_bwd_ms"] = k4_per_round * vmapped["k4_bwd_ms"]
    phase("done", seconds=time.perf_counter() - t_start,
          round_vs_cpu_max_abs_diff=round_diff,
          rounds_per_s=summary["rounds_per_s"],
          turbo_round_vs_cpu_max_abs_diff=turbo_diff,
          turbo_dropout_max_abs_diff=dropout_diff,
          turbo_rounds_per_s=turbo["rounds_per_s"],
          silo_round_vs_cpu_max_abs_diff=silo_diff,
          silo_rounds_per_s=silo["rounds_per_s"],
          lm_flash_vs_blockwise_max_abs_diff=lm_diff,
          lm_rounds_per_s=lm_rounds_per_s,
          lm_bench_tokens_per_s={k: v["tokens_per_s"]
                                 for k, v in lm_bench.items()},
          lm_cli_rounds_per_s=lm_cli["rounds_per_s"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
