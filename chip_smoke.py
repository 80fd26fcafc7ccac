#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``fedml_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
each printed as it ends; any failure exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds every kernel under ``fedml_tpu_torch/csrc/``;
3. kernel robust_agg — the fused clip + noise + mean kernel (K1) against
   its plain PyTorch version, leaf by leaf (a one-leaf table) at every
   leaf size of the FEMNIST CNN and one odd size, sigma 0 and 0.025: max
   abs error, bit-equal noise uniforms, kernel / plain / ``torch.addmv``
   times and the bound (bytes; f32, integer and special-function
   operations at their lanes per SM a clock); then the path's form, one
   norm launch and one aggregate launch over a table of the CNN's leaves,
   the odd size and an unaligned leaf, at clip 5.0 and none, sigma 0 and
   0.025, within 1e-5 of the plain versions, two launches bit-equal, the
   SFU Gaussians of all 16.9 M (leaf, client, element) samples within
   K1_GAUSS_TOL of the precise ones; the table launch's and the norm
   pass's times beside the plain aggregate and the eager clip pass;
4. slice — defended FedAvg (weak DP, fused CUDA backend) on the FEMNIST
   CNN at full width, 3400 clients, 10 per round, B=20, lr 0.1, E=1, 3
   rounds, through the CLI's runner; exactly one norm launch and one
   aggregate launch a round.  Then one round from the same init and seed
   words with TF32 off, held against the port on the CPU;
5. kernel secagg_mask — the fused quantize + pairwise-mask kernel (K3)
   against its plain PyTorch version leaf by leaf (the pair seeds given)
   at every leaf size of the CNN and one odd size, groups of 5 and 10:
   bit-equal ring values, the masks cancelling on the card, times and
   bounds; then the path's form, one launch over a table of the CNN's
   leaves, the odd size and an unaligned leaf with the pair keys derived
   in the launch (each pair once), bit-equal leaf by leaf, its one-buffer
   ring sum equal to the per-leaf sums, the per-row walk (one row, two
   rows) equal to the group's rows, the launch's salts bit-equal to
   ``pair_seeds`` + ``leaf_seeds``; its time at a group of 5;
6. turboaggregate slice — secure FedAvg (two groups of 5, cuda backend) on
   the same CNN, data and widths, 3 rounds through the CLI's runner: the
   kernel launches exactly once per group and round (2 x 3); a per-part
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
8a. device round — plain FedAvg on the same CNN, data and widths: the
   train split resident on the card, 3 rounds of the graphed device round
   (one CUDA-graph capture, one replay a round, counted exactly) against 3
   rounds of the host-gather loop, bit-equal with cuDNN deterministic and
   TF32 off (the default mode's difference recorded), one round against
   the port on the CPU (limit 1e-4); the host loop, the K=1 graph and the
   K=10 scanned graph profiled over 10 rounds each: host µs, wall ms,
   device kernels and host launch calls a round, busy time, idle share,
   capture time;
8b. scanned rounds — 21 rounds, evaluation every 10, through the CLI's
   runner: the host loop, the K=1 graph and ``--rounds_per_dispatch 10``;
   evaluation at rounds 0, 10 and 20 on each, the final params bit-equal
   in deterministic mode, steady rounds/s and capture time in both modes;
8c. byzantine — ``--algo fedavg_robust --defense <rule>`` for the five
   rules (Krum with f=2, multi-Krum with f=2, m=3): one round on the card
   (TF32 off) against the CPU (limit 1e-4), Krum's selections equal;
8d. cross_silo robust — one round on the hub, card against CPU, of the
   defended stack (trimmed mean, clip 5) and of a rule over the stream's
   reservoir (coordinate median, K=8); the defended mean in stack and in
   stream mode (clip 5, sigma 0.025, 2 rounds) bit-equal on the card;
8e. checkpoint — a 4-round run against a run stopped after round 2 and
   resumed from its checkpoint, through the CLI's runner, bit-equal on
   the card (deterministic mode);
8f. cross_silo crash resume — the cross-silo slice (S=4, K2 on) with
   ``--checkpoint_dir`` and ``--journal_dir`` (a snapshot every fold),
   killed in round 1 by a ``Faultline`` at ``post_admission_pre_fold``
   (hit 2), ``post_fold_pre_ack`` (hit 2), ``barrier_close`` and
   ``mid_checkpoint_write``, respawned and resumed in the same process:
   each resumed global bit-equal on the card to the uncrashed run's
   (deterministic mode), 4 K2 launches a round closed after the resume,
   the silos re-tasked; a journal with a tampered opening crc abandoned
   and the run still equal; each snapshot's device->host, encode, write
   and fsync times; the journaled round beside the plain one;
8g. cross_silo chaos threaded — the same federation, each actor on its
   own thread, 4 rounds under ``--chaos_drop/dup/reorder/delay 0.1
   --chaos_corrupt 0.05`` (silo 1's links clean) with the drop policy,
   heartbeats every 0.05 s and the failure detector (T and D from the
   measured round): every round closes, faults by kind, no upload folded
   twice, none non-finite, 4 K2 launches a round, each round's global
   against its replay from the server's record (limit 1e-4); rounds/s and
   the device's idle share;
8h. cross_silo mqtt — the same federation over the repo's MQTT broker on
   the loopback (10 silo threads, ``MiniMqttClient`` in
   ``ResilientTransport``), 3 rounds: 4 K2 launches a round, the global
   against the pumped hub run (limit 1e-4), rounds/s, the broker's bytes
   a round, the MQTT round beside the hub round;
10. transformer slice — FedAvg through the API on bench.py's long-context
   TransformerLM (vocab 256, d_model 256, 8 heads, 2 layers, d_ff 1024,
   T=2048, flash on), 16 clients, 4 per round, B=2, lr 0.1, E=1, 3
   rounds, as replays of one captured CUDA graph: the graph holds
   n_layers x S launches of each K4 kernel (the wrappers' counts during
   the capture and the graph's own kernel nodes, from its Graphviz dump),
   it replays once a round, the warm-up round launches n_layers x S of
   each, and evaluation launches K4f only; a per-part split of a
   host-loop round, its launches and the device's idle share; one round
   with TF32 off against the same round with flash off (auto-blockwise,
   limit 1e-4); bench.py's long-context grad step (B=2, T=2048, 10
   steps), flash on and off;
11. transformer cli — 3 rounds of the dense Shakespeare transformer (the
   JAX CLI's widths, 715 clients, 10 per round, B=4, SGD lr 1) through
   the CLI's runner (graphed device rounds): rounds/s and a finite loss;
12. a JSON line with each kernel's numbers (K1's norm pass beside K1; K1
   and K2 also at their library call's configuration, sigma 0; K4's
   launches are the warm-up's and evaluation's plus the captured ones
   times the replays), and a last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, printing no result, when there is
no CUDA device or when the checkout around this file is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# lanes a clock on the H100 SXM's 132 SMs, by kind of operation (CUDA
# programming guide, arithmetic instruction throughput, compute capability
# 9.0): f32 add and multiply (the kernels are built with -fmad=false, so no
# fused multiply-add counts twice), 32-bit integer add, multiply, shift and
# logic, and the special-function units (lg2, rsqrt, cos and the
# int <-> float conversions); every instruction passes the 4 dispatchers
OP_LANES_PER_CLOCK = {"fp32": 128 * 132, "int": 64 * 132, "sfu": 16 * 132}
DISPATCH_LANES_PER_CLOCK = 128 * 132
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
K1_GAUSS_TOL = 2e-5            # K1's SFU Gaussian vs the precise one, abs
# K1's clip scales vs the plain version's, relative: both sum ~3.7 M squares
# in f32, in different orders (7.2e-8 apart on an H100 at phase 3's tree);
# a leaf left out of the norm moves a scale by 8e-6 or more
K1_SCALE_TOL = 4e-7
K1_UNCLIPPED = 2               # clients of phase 3's tree under the bound
CLIP_BOUND = 5.0               # the defended slice's norm bound
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


def device_ms(fn, reps: int, name: str = "", windows: int = 3):
    """Device time (ms) per call of ``fn``: the kernels it launches (those
    whose name contains ``name``), summed, from torch.profiler over
    ``reps`` calls; the median of ``windows`` such windows (one window can
    lose or garble launches), None if no window shows device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_self_device_us(e) for e in prof.key_averages()
                       if name in e.key)
        if total_us > 0:
            per_call.append(total_us / reps / 1e3)
    return statistics.median(per_call) if per_call else None


def call_profile(fn, reps: int = 5):
    """What one call of ``fn`` costs: its host time (µs, the device drained
    before and after), and from torch.profiler its kernel launches, their
    device time (µs) and the four largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {"host_us": host_us(fn, reps)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    out["launches"] = sum(e.count for e in events) / reps
    out["device_us"] = sum(_self_device_us(e) for e in events) / reps
    top = sorted(events, key=_self_device_us, reverse=True)[:4]
    out["top_device_us"] = {e.key[:50]: _self_device_us(e) / reps
                            for e in top}
    return out


def _self_device_us(event) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for the rows of
    host operators, whose device time repeats their kernels'."""
    from torch.autograd import DeviceType
    if getattr(event, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def op_bound(nbytes: float, ops, sm_hz: float):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``ops`` ({"fp32": n, "int": n, "sfu": n}): the
    largest of the bytes over 3.35 TB/s and each kind of operation over
    its lanes at the SM clock ``sm_hz``.  ``bound_term`` names the term,
    ``bound_by`` says "bytes" or "operations"; ``dispatch_ms`` (every
    operation through the SMs' 128 dispatch lanes a clock) stays beside
    them, outside the bound."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for kind, lanes in OP_LANES_PER_CLOCK.items():
        terms[kind] = ops.get(kind, 0) / (lanes * sm_hz) * 1e3
    term = max(terms, key=terms.get)
    dispatch_s = sum(ops.values()) / (DISPATCH_LANES_PER_CLOCK * sm_hz)
    return dict(bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, **{f"{k}_ms": v for k, v in terms.items()},
                dispatch_ms=dispatch_s * 1e3)


def robust_agg_work(n: int, sizes, sigma: float):
    """Bytes and operations of K1's aggregate over leaves of ``sizes``
    elements for ``n`` clients: x read once, g read and out written once,
    the scales and ratios; per (client, element) 5 f32 operations, and at
    sigma > 0 the noise: two murmur finalisers and two shifts (20 integer
    operations), 30 f32 operations (the uniforms, the log series and its
    select, the square root's and the cosine's scaling, sigma), lg2, rsqrt,
    cos and two int -> float conversions on the special-function units;
    per element the index hash (10 integer operations)."""
    d = sum(sizes)
    pairs = n * d
    ops = {"fp32": pairs * (30 + 5 if sigma else 5)}
    if sigma:
        ops.update(int=pairs * 20 + d * 10, sfu=pairs * 5)
    return 4 * (pairs + 2 * d + 2 * n), ops


def clip_norm_work(n: int, sizes):
    """The norm pass over weight leaves of ``sizes`` elements: x and g
    read once, the scales written; a subtract, a square and an add per
    (client, element)."""
    d = sum(sizes)
    return 4 * (n * d + d + n), {"fp32": 3 * n * d}


def secagg_mask_work(rows: int, n: int, d: int):
    """Bytes and operations of K3 for ``rows`` client rows of an
    ``n``-client group over ``d`` elements: x read and the ring values
    written once, the weights; per (row, element) the quantize (4 f32
    operations, one float -> int conversion).  A whole group of up to 16
    (rows == n) takes the each-pair-once form: per element one index hash
    (10 integer operations) and 11 per pair (the finaliser, an xor, an add
    and a subtract); otherwise per (row, element) the index hash and 10 per
    partner."""
    if rows == n <= 16:
        int_ops = d * (10 + 11 * n * (n - 1) // 2)
    else:
        int_ops = rows * d * (10 + 10 * (n - 1))
    return (4 * (2 * rows * d + rows),
            {"fp32": 4 * rows * d, "int": int_ops, "sfu": rows * d})


def k1_inputs(n: int, d: int, gen):
    """x [n, d], g [d] (unit normal) and the clip scales and ratios of
    phase 3, on the card."""
    import torch
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen, device=dev)
    g = torch.randn(d, generator=gen, device=dev)
    scales = torch.rand(n, generator=gen, device=dev)
    scales[: n // 2] = 1.0
    w = torch.rand(n, generator=gen, device=dev) + 0.5
    w[-1] = 0.0
    return x, g, scales, (w / w.sum()).contiguous()


def offset_copy(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` floats past the
    start of its allocation (4 bytes past a 16-byte boundary for 1)."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_kernel(leaf_sizes, seed_words, sm_hz):
    """Phase 3: robust_agg (a one-leaf table) against robust_agg_plain on
    the card, leaf by leaf."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s0, s1 = seed_words
    sizes = dict(leaf_sizes, odd=1_000_003)
    rows, worst = [], 0.0
    for name, d in sizes.items():
        x, g, scales, ratios = k1_inputs(N_CLIENTS, d, gen)
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
            bound = op_bound(*robust_agg_work(N_CLIENTS, [d], sigma), sm_hz)
            row = dict(leaf=name, d=d, sigma=sigma, max_abs_err=err,
                       uniforms_bit_equal=bits_equal, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_us=bound["bound_ms"] * 1e3,
                       bound_by=bound["bound_by"],
                       bound_term=bound["bound_term"])
            phase("kernel robust_agg", **row)
            rows.append(row)
        del x, g
    return rows, worst


def k1_tree(leaf_sizes, gen):
    """Phase 3's tree: the CNN's leaves, the odd size and an unaligned
    leaf (x and g 4 bytes past a 16-byte boundary), stacked for
    N_CLIENTS, with the global and the weights.  The first K1_UNCLIPPED
    clients' updates have a norm near 1, under CLIP_BOUND (scale 1); the
    others' near 96 (scale near 0.05)."""
    import torch
    stacked, glob = {}, {}
    sizes = dict(leaf_sizes, odd=1_000_003, unaligned=1_000_002)
    spread = torch.full((N_CLIENTS, 1), 0.05, device="cuda")
    spread[:K1_UNCLIPPED] = 0.0005
    for name, d in sizes.items():
        x, g, _, _ = k1_inputs(N_CLIENTS, d, gen)
        off = 1 if name == "unaligned" else 0
        stacked[name] = offset_copy(x * spread + g, off)
        glob[name] = offset_copy(g, off)
    w = k1_inputs(N_CLIENTS, 1, gen)[3] * 300
    return stacked, glob, w


def check_k1_table(leaf_sizes, seed_words, sm_hz):
    """Phase 3, the path's form: the fused aggregate over the CNN's
    leaves, the odd size and the unaligned leaf, one norm launch and one
    aggregate launch, at clip 5.0 and none, sigma 0 and 0.025, within
    KERNEL_TOL of the plain versions leaf by leaf; two launches bit-equal;
    the norm pass's scales within K1_SCALE_TOL of the plain ones (exactly
    1 under the bound), with every leaf's last element read and a NaN
    kept; CPU weights with the card's leaves refused; the Gaussians of
    every (leaf, client) of the CNN within K1_GAUSS_TOL of the precise
    ones; times of the aggregate launch and of the norm pass over the
    CNN's leaves, beside the eager clip pass and the plain aggregate."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa
    from fedml_tpu_torch.core.pytree import tree_keys

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    stacked, glob, w = k1_tree(leaf_sizes, gen)
    keys = tree_keys(stacked)
    ratios = (w / w.sum()).contiguous()
    out = {}
    for bound in (CLIP_BOUND, None):
        want_scales = (fa.clip_scales_plain(stacked, glob, bound,
                                            lambda k: True)
                       if bound is not None else None)
        for sigma in (0.0, SIGMA):
            agg = fa.make_fused_robust_aggregate(norm_bound=bound,
                                                 noise_std=sigma,
                                                 is_weight=lambda k: True)
            fa.reset_launch_counts()
            got = agg(stacked, w, glob, seed_words)
            again = agg(stacked, w, glob, seed_words)
            torch.cuda.synchronize()
            launches = dict(fa.launch_counts)
            if launches["robust_agg"] != 2 or launches["clip_norm"] != (
                    2 if bound is not None else 0):
                fail(f"the fused aggregate launched {launches} in two calls")
            same = all(torch.equal(got[k].view(torch.int32),
                                   again[k].view(torch.int32)) for k in keys)
            if not same:
                fail(f"two fused aggregates (clip {bound}, sigma {sigma}) "
                     f"differ")
            ones = torch.ones(N_CLIENTS, device=dev)
            err = 0.0
            for li, k in enumerate(keys):
                want = fa.robust_agg_plain(
                    stacked[k], glob[k],
                    want_scales if bound is not None else ones, ratios,
                    fa.leaf_seed(seed_words[0], li),
                    fa.leaf_seed(seed_words[1], li), sigma)
                err = max(err, float((got[k] - want).abs().max()))
            if not err <= KERNEL_TOL:
                fail(f"fused aggregate (clip {bound}, sigma {sigma}): max "
                     f"abs err {err} > {KERNEL_TOL}")
            out[(bound, sigma)] = err
    # no fallback: CPU weights with the card's leaves are refused
    for bound in (CLIP_BOUND, None):
        agg = fa.make_fused_robust_aggregate(norm_bound=bound,
                                             is_weight=lambda k: True)
        try:
            agg(stacked, w.cpu(), glob, seed_words)
        except ValueError:
            pass
        else:
            fail(f"the fused aggregate (clip {bound}) took CPU weights "
                 f"with the card's leaves")

    layout = fa.LeafLayout(keys, [glob[k].numel() for k in keys],
                           range(len(keys)), [True] * len(keys))
    xs = [stacked[k] for k in keys]
    gs = [glob[k] for k in keys]
    scale_check = check_clip_norm(layout, stacked, glob, ratios)
    scales = fa.clip_norm(layout, xs, gs, CLIP_BOUND)

    # the Gaussians of every CNN leaf and client: SFU against precise
    gauss_err = 0.0
    samples = 0
    for li, (name, d) in enumerate(leaf_sizes.items()):
        s0 = fa.leaf_seed(seed_words[0], li)
        s1 = fa.leaf_seed(seed_words[1], li)
        for client in range(N_CLIENTS):
            u1, u2, gk = fa.noise_probe(d, s0, s1, client, dev)
            pu1, pu2 = fa.noise_uniforms_plain(d, s0, s1, client, dev)
            if not (torch.equal(u1.view(torch.int32), pu1.view(torch.int32))
                    and torch.equal(u2.view(torch.int32),
                                    pu2.view(torch.int32))):
                fail(f"noise uniforms of {name}, client {client} differ "
                     f"from the plain version")
            gauss_err = max(gauss_err, float(
                (gk - fa._gaussian(pu1, pu2)).abs().max()))
            samples += d
    if not gauss_err <= K1_GAUSS_TOL:
        fail(f"K1's Gaussians differ from the precise ones by {gauss_err} "
             f"> {K1_GAUSS_TOL}")

    # times over the CNN's leaves (the path's table)
    cnn = [k for k in keys if k in leaf_sizes]
    layout = fa.LeafLayout(cnn, [leaf_sizes[k] for k in cnn],
                           range(len(cnn)), [True] * len(cnn))
    xs = [stacked[k] for k in cnn]
    gs = [glob[k] for k in cnn]
    sub = {k: stacked[k] for k in cnn}
    subg = {k: glob[k] for k in cnn}
    times = {}
    for sigma in (0.0, SIGMA):
        call = lambda: fa.robust_agg_table(layout, xs, gs, scales, ratios,
                                           *seed_words, sigma)
        plain = lambda: [fa.robust_agg_plain(
            x, g, scales, ratios, fa.leaf_seed(seed_words[0], li),
            fa.leaf_seed(seed_words[1], li), sigma)
            for li, (x, g) in enumerate(zip(xs, gs))]
        bound = op_bound(*robust_agg_work(N_CLIENTS, layout.sizes, sigma),
                         sm_hz)
        times[sigma] = dict(
            ms=(device_ms(call, 20, "robust_agg_kernel", windows=5)
                or time_ms(call, 50)),
            call_ms=time_ms(call, 50), host_us=host_us(call),
            plain_ms=device_ms(plain, 3) or time_ms(plain, 3, trials=3),
            **bound)
    norm = lambda: fa.clip_norm(layout, xs, gs, CLIP_BOUND)
    eager = lambda: fa.clip_scales_plain(sub, subg, CLIP_BOUND,
                                         lambda k: True)
    norm_row = dict(ms=(device_ms(norm, 20, "clip_norm_kernel", windows=5)
                        or time_ms(norm, 50)),
                    call_ms=time_ms(norm, 50), host_us=host_us(norm),
                    plain_ms=device_ms(eager, 20) or time_ms(eager, 20),
                    plain_host_us=host_us(eager),
                    **op_bound(*clip_norm_work(N_CLIENTS, layout.sizes),
                               sm_hz))
    result = dict(max_abs_err={f"clip={b},sigma={s}": e
                               for (b, s), e in out.items()},
                  bit_equal_twice=True, **scale_check,
                  gauss_max_abs_err=gauss_err, gauss_tol=K1_GAUSS_TOL,
                  gauss_samples=samples, table=times, clip_norm=norm_row)
    phase("kernel robust_agg table", **result)
    return result


def check_clip_norm(layout, stacked, glob, ratios):
    """Phase 3's norm pass: the scales against clip_scales_plain, within
    K1_SCALE_TOL (relative), the clients under the bound at exactly 1; then
    with client j % N's update spiked at leaf j's last element (so each
    client's scale hangs on one leaf's tail being read); then with a NaN in
    one client's update: its scale NaN, as in the plain version, and the
    aggregate over it NaN at every element, the others' scales as before."""
    import torch
    from fedml_tpu_torch.core import fused_agg as fa

    keys = layout.keys
    xs = [stacked[k] for k in keys]
    gs = [glob[k] for k in keys]

    def compare(what):
        got = fa.clip_norm(layout, xs, gs, CLIP_BOUND)
        want = fa.clip_scales_plain(stacked, glob, CLIP_BOUND,
                                    lambda k: True)
        torch.cuda.synchronize()
        if not torch.equal(got.isnan(), want.isnan()):
            fail(f"clip_norm ({what}): NaN scales {got.tolist()} against "
                 f"the plain version's {want.tolist()}")
        ok = ~want.isnan()
        diff = (got[ok] - want[ok]).abs()
        rel = float((diff / want[ok]).max())
        if not rel <= K1_SCALE_TOL:
            fail(f"clip_norm ({what}): scales {got.tolist()} differ from "
                 f"the plain version's {want.tolist()} by {rel} relative > "
                 f"{K1_SCALE_TOL}")
        return got, want, float(diff.max()), rel

    got, want, abs_err, rel_err = compare("as drawn")
    under = slice(None, K1_UNCLIPPED)
    if not ((got[under] == 1).all() and (want[under] == 1).all()
            and (want[K1_UNCLIPPED:] < 1).all()):
        fail(f"clip_norm: scales {got.tolist()} (plain {want.tolist()}), "
             f"need exactly 1 for the first {K1_UNCLIPPED} clients only")

    # every leaf's last element (its D % 4 tail, where it has one)
    saved = []
    for j, x in enumerate(xs):
        c = j % N_CLIENTS
        saved.append((x, c, x[c, -1].clone()))
        x[c, -1] = gs[j][-1] + 1000.0
    spiked, _, spike_abs, spike_rel = compare("spiked tails")
    for x, c, v in saved:
        x[c, -1] = v
    if not (spiked < 0.01).all():
        fail(f"clip_norm: spiked scales {spiked.tolist()}, a leaf's last "
             f"element was not read")

    # a NaN in client 3's update
    big = max(range(len(xs)), key=lambda j: xs[j].shape[1])
    at = xs[big].shape[1] // 2
    kept = xs[big][3, at].clone()
    xs[big][3, at] = float("nan")
    nan_scales, _, _, _ = compare("a NaN in client 3")
    flat = fa.robust_agg_table(layout, xs, gs, nan_scales, ratios, 1, 2, 0.0)
    torch.cuda.synchronize()
    xs[big][3, at] = kept
    if not (nan_scales[3].isnan() and all(
            v.isnan().all() for v in layout.views(
                flat, [(d,) for d in layout.sizes]))):
        fail("clip_norm / robust_agg: a NaN in client 3's update did not "
             "reach its scale and every element of the aggregate")
    return dict(scales_max_abs_diff=abs_err, scales_max_rel_diff=rel_err,
                scale_tol=K1_SCALE_TOL, unclipped_scales_exactly_1=True,
                spiked_scales_max_rel_diff=spike_rel,
                spiked_scales_max_abs_diff=spike_abs, nan_scale_kept=True)


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
    norm_launches = fa.launch_counts["clip_norm"]
    need = data_cfg.comm_round
    if launches != need or norm_launches != need:
        fail(f"slice launched robust_agg {launches} and clip_norm "
             f"{norm_launches} times, need exactly {need} each (one of each "
             f"a round)")
    if not summary.get("params_finite"):
        fail("slice produced non-finite parameters")
    phase("slice", launches=launches, clip_norm_launches=norm_launches,
          data_s=data_s, run_s=run_s,
          rounds_per_s=summary["rounds_per_s"],
          test_acc=summary["test_acc"], test_loss=summary["test_loss"],
          train_acc=summary["train_acc"], params_finite=True,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return data, (launches, norm_launches), summary


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
        # the aggregate part alone: its host time, launches and kernels
        row["aggregate_call"] = call_profile(
            lambda: aggregate(stacked, cohort["num_samples"], params, words))
        row["stacked_contiguous"] = all(v.is_contiguous()
                                        for v in stacked.values())

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
        for name in ("robust_agg_kernel", "clip_norm_kernel"):
            k1 = [e for e in events if name in e.key]
            row[f"{name}_launches_per_round"] = sum(
                e.count for e in k1) / rounds
            row[f"{name}_device_ms_per_round"] = sum(
                _self_device_us(e) for e in k1) / rounds / 1e3
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


def check_secagg_kernel(leaf_sizes, sm_hz):
    """Phase 5: secagg_mask (a one-leaf table, the pair seeds given)
    against quantize_mask_plain on the card, leaf by leaf."""
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
                ms = device_ms(kernel, 20, "secagg_") or call_ms
                plain_ms = device_ms(plain, 3) or time_ms(plain, 3, trials=3)
            else:                             # CUDA events only
                ms, plain_ms = call_ms, time_ms(plain, 3, trials=3)
            bound = op_bound(*secagg_mask_work(n, n, d), sm_hz)
            row = dict(leaf=name, d=d, n=n, bit_equal=True,
                       masks_cancel=cancel, max_abs_err=err, ms=ms,
                       call_ms=call_ms, host_us=host_us(kernel),
                       plain_ms=plain_ms, bound_us=bound["bound_ms"] * 1e3,
                       bytes_us=bound["bytes_ms"] * 1e3,
                       int_us=bound["int_ms"] * 1e3,
                       bound_by=bound["bound_by"],
                       bound_term=bound["bound_term"])
            phase("kernel secagg_mask", **row)
            rows_out.append(row)
            del x, got, want, q
    return rows_out, worst


def check_k3_table(leaf_sizes, sm_hz):
    """Phase 5, the path's form: one launch over the CNN's leaves, the odd
    size and an unaligned leaf for a whole group of 5 and of 10 (each pair
    once, the pair keys derived in the launch), bit-equal to the plain
    version leaf by leaf, the masks cancelling in one ring sum over the
    buffer, bit-equal to the per-leaf ring sums; the per-row walk (one
    client's row, two rows of a group) bit-equal; the launch's salts
    bit-equal to pair_seeds + leaf_seeds; CPU weights with the card's
    leaves refused; the launch's time over the CNN's leaves at the slice's
    group of 5."""
    import torch
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.secure import fused_mask as fm
    from fedml_tpu_torch.secure.secagg import (quantize, ring_budget_scale,
                                               ring_sum)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    clip = 2.0**14
    sizes = dict(leaf_sizes, odd=1_000_003, unaligned=1_000_002)
    keys = list(sizes)
    layout = fm.mask_layout(keys, list(sizes.values()))
    result = {}
    for n in GROUP_SIZES:
        scale = ring_budget_scale(n, clip)
        key = prng.fold_in(prng.key(7), n)
        xs = [offset_copy(torch.randn(n, d, generator=gen, device=dev) * 3,
                          1 if k == "unaligned" else 0)
              for k, d in sizes.items()]
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        w[-1] = 0.0
        w = (w / w.sum()).contiguous()
        fm.reset_launch_counts()
        buf = fm.quantize_mask_table(layout, xs, w, key, 0, n, scale, clip)
        torch.cuda.synchronize()
        if fm.launch_counts["secagg_mask"] != 1:
            fail(f"the K3 table launched {fm.launch_counts} for one group")
        try:        # no fallback: CPU weights with the card's leaves
            fm.quantize_mask_table(layout, xs, w.cpu(), key, 0, n, scale,
                                   clip)
        except ValueError:
            pass
        else:
            fail("the K3 table took CPU weights with the card's leaves")
        base = fm.pair_seeds(key, 0, n, n)
        flat_sum = ring_sum({"": buf})[""]
        for li, (name, d) in enumerate(sizes.items()):
            seeds = torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
            c = layout.offsets[li]
            got = buf[:, c:c + d]
            want = fm.quantize_mask_plain(xs[li], w, seeds, 0, scale, clip)
            if not torch.equal(got, want):
                fail(f"K3 table {name} (D={d}, N={n}): ring values differ "
                     f"from the plain version")
            q = quantize({"x": xs[li] * w[:, None]}, scale, clip)["x"]
            per_leaf = ring_sum({"x": got})["x"]
            if not (torch.equal(per_leaf, ring_sum({"x": q})["x"])
                    and torch.equal(flat_sum[c:c + d], per_leaf)):
                fail(f"K3 table {name} (N={n}): the masks do not cancel, or "
                     f"the buffer's ring sum differs from the leaf's")
            salts = fm.pair_salts(key, n, li, dev)
            if not torch.equal(salts, fm.pair_salts_plain(key, n, li, dev)):
                fail(f"K3's in-launch salts (leaf {li}, N={n}) differ from "
                     f"pair_seeds + leaf_seeds")
        # the per-row walk: one client's row, and two rows of the group
        for first, rows in ((2, 1), (1, 2)):
            sub = [x[first:first + rows].contiguous() for x in xs]
            part = fm.quantize_mask_table(layout, sub,
                                          w[first:first + rows].contiguous(),
                                          key, first, n, scale, clip)
            if not all(torch.equal(p, b) for p, b in zip(
                    layout.views(part, [(d,) for d in layout.sizes]),
                    layout.views(buf[first:first + rows],
                                 [(d,) for d in layout.sizes]))):
                fail(f"K3's per-row walk (rows {first}..{first + rows - 1} "
                     f"of {n}) differs from the group's launch")
        result[f"n={n}"] = dict(bit_equal=True, masks_cancel=True,
                                salts_bit_equal=True, rows_walk_equal=True)
        del xs, buf

    # the path's launch: the CNN's leaves, a group of 5
    n = GROUP_SIZES[0]
    scale = ring_budget_scale(n, clip)
    key = prng.fold_in(prng.key(8), n)
    cnn = fm.mask_layout(list(leaf_sizes), list(leaf_sizes.values()))
    xs = [torch.randn(n, d, generator=gen, device=dev) * 3
          for d in leaf_sizes.values()]
    w = torch.full((n,), 1.0 / n, device=dev)
    call = lambda: fm.quantize_mask_table(cnn, xs, w, key, 0, n, scale, clip)
    base = fm.pair_seeds(key, 0, n, n)
    seeds = [torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
             for li in range(len(leaf_sizes))]
    plain = lambda: [fm.quantize_mask_plain(x, w, s, 0, scale, clip)
                     for x, s in zip(xs, seeds)]
    ring = lambda: ring_sum({"": call()})
    bound = op_bound(*secagg_mask_work(n, n, sum(leaf_sizes.values())),
                     sm_hz)
    result["path"] = dict(
        n=n, ms=(device_ms(call, 20, "secagg_", windows=5)
                or time_ms(call, 50)),
        call_ms=time_ms(call, 50), host_us=host_us(call),
        plain_ms=device_ms(plain, 3) or time_ms(plain, 3, trials=3),
        mask_and_ring_sum_ms=time_ms(ring, 20), **bound)
    phase("kernel secagg_mask table", **result)
    return result


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
    need = turbo_cfg.group_num * turbo_cfg.comm_round
    if launches != need:
        fail(f"turboaggregate launched secagg_mask {launches} times, need "
             f"exactly {need} (one launch x {turbo_cfg.group_num} groups x "
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
    the gather, local SGD, the mask launch (``aggregate_stacked``'s cuda
    path: the layout, the launch), the ring sum + dequantize over its
    buffer and the group combine, summed over the groups of a round; then
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
            buf, layout = agg.mask_flat(trained, w, 0, keys[g])
            t, dt = tick(t)
            acc["mask_ms"] += dt
            flat = agg.unmask_sum(ring_sum({"": buf}), 1.0)[""]
            means.append(dict(zip(layout.keys, layout.views(
                flat, [trained[k].shape[1:] for k in layout.keys]))))
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
    # one group's mask launch and ring sum alone: host time, launches
    row["mask_call"] = call_profile(
        lambda: agg.mask_flat(trained, w, 0, keys[-1]))
    row["ring_sum_dequant_call"] = call_profile(
        lambda: agg.unmask_sum(ring_sum({"": buf}), 1.0))
    row["trained_contiguous"] = all(v.is_contiguous()
                                    for v in trained.values())
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
        if "secagg_" in e.key) / rounds / 1e3
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
# the device-resident round, scanned rounds, the Byzantine rules, the
# defended cross-silo aggregate and round checkpoints (the CNN's widths)
# ---------------------------------------------------------------------------

FEDAVG_ARGS = ["--algo", "fedavg", *COMMON_ARGS]
DEVICE_ROUNDS = 3              # graphed rounds held against the host loop
PATH_ROUNDS = 10               # rounds a profile of each path covers (= K)
SCAN_ARGS = [*FEDAVG_ARGS, "--comm_round", "21", "--frequency_of_the_test",
             "10"]
SCAN_K = 10
BYZ_ARGS = {"coordinate_median": [], "trimmed_mean": [],
            "krum": ["--byz_f", "2"],
            "multi_krum": ["--byz_f", "2", "--krum_m", "3"],
            "geometric_median": []}
SILO_ROBUST_ARGS = {
    "stack trimmed_mean": ["--agg_mode", "stack", "--robust_agg",
                           "trimmed_mean", "--norm_clip", "5.0"],
    "stream coordinate_median": ["--agg_mode", "stream", "--robust_agg",
                                 "coordinate_median", "--stream_reservoir",
                                 "8"]}
SILO_MEAN_ARGS = ["--algo", "cross_silo", "--silo_backend", "local",
                  "--norm_clip", "5.0", "--agg_noise_std", str(SIGMA),
                  *COMMON_ARGS, "--comm_round", "2"]
CKPT_ROUNDS, CKPT_STOP = 4, 2
# host-side CUDA runtime calls that put work on the device
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms (no atomics in the grouped-conv
    backward) and TF32 off inside the block."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tf32_off():
            yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def fedavg_algo(cfg, data, device="cuda"):
    """The CLI runner's FedAvg for ``cfg``."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.experiments.main import (_fedavg_cfg_kwargs,
                                                  _make_workload)
    return FedAvg(_make_workload(cfg, data), data,
                  FedAvgConfig(**_fedavg_cfg_kwargs(cfg)), device=device)


def round_plan(data, m: int, rounds: int, start: int = 0):
    """``[rounds, m]`` padded ids and live masks of rounds ``start``.."""
    import numpy as np
    from fedml_tpu_torch.algorithms.fedavg import pad_ids
    from fedml_tpu_torch.core.sampling import sample_clients
    pairs = [pad_ids(sample_clients(r, data.client_num, m), m)
             for r in range(start, start + rounds)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def max_diff(a, b) -> float:
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max())
               for k in a)


def bit_equal(a, b) -> bool:
    return all(a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes()
               for k in a)


def host_loop_rounds(algo, data, params, rounds: int, start: int = 0):
    """``rounds`` rounds of the host-gather loop (the cohort copied to the
    card each round), the device not drained at the end."""
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    m = algo.cfg.client_num_per_round
    for r in range(start, start + rounds):
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        params, _ = algo.cohort_step(params, cohort)
    return params


def graph_rounds(algo, data, params, rounds: int, start: int = 0):
    """``rounds`` rounds through the algorithm's device round (one replay
    of its captured graph each)."""
    ids, live = round_plan(data, algo.cfg.client_num_per_round, rounds,
                           start)
    for r in range(rounds):
        params, _ = algo._device_round(params, algo._train_dev, ids[r],
                                       live[r])
    return params


def staged(algo):
    """Stage the algorithm's train split on the card; fail unless the
    device path is taken."""
    import torch
    if not algo._stage_train_on_device():
        fail("the FEMNIST train split did not take the device path")
    if algo._train_dev["x"].device.type != "cuda":
        fail(f"the train split is on {algo._train_dev['x'].device}")
    return sum(v.numel() * v.element_size()
               for v in algo._train_dev.values()) / 1e9


def path_profile(run, rounds: int):
    """One path's cost a round: ``run()`` enqueues ``rounds`` rounds.  Host
    µs (the enqueue, before the device is drained) and wall ms, each
    after a warm-up call; then torch.profiler over one more call: the
    device's kernels and busy time, the host's launch calls (kernel
    launches, graph launches, copies) and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t3) * 1e6
    averages = prof.key_averages()
    events = [e for e in averages if _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    apis = {e.key: e.count / rounds for e in averages
            if e.key in LAUNCH_APIS}
    return dict(host_us_per_round=(t1 - t0) / rounds * 1e6,
                round_ms=(t2 - t0) / rounds * 1e3,
                profiled_round_ms=wall_us / rounds / 1e3,
                device_kernels_per_round=sum(e.count for e in events)
                / rounds,
                host_launch_calls_per_round=sum(apis.values()),
                host_launch_calls=apis,
                device_busy_ms_per_round=busy_us / rounds / 1e3,
                device_idle_share=(1 - busy_us / wall_us) if busy_us
                else None)


def check_device_round(data):
    """Phase 12: plain FedAvg's device-resident round, captured as a CUDA
    graph, against the port's host-gather loop on the card (bit-equal in
    deterministic mode, TF32 off; the difference in the default mode
    recorded) and against the port on the CPU (one round, ROUND_TOL);
    captures and replays counted exactly; then the host loop, the K=1
    graph and the K=10 scanned graph profiled."""
    import dataclasses
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.parallel.cohort import make_scanned_rounds

    cfg = config_from_argv(FEDAVG_ARGS)
    m = cfg.client_num_per_round
    out = {}
    for mode, ctx in (("deterministic", deterministic),
                      ("default", contextlib.nullcontext)):
        with ctx():
            host = fedavg_algo(cfg, data)
            init = host.init_params()
            want = host_loop_rounds(host, data, init, DEVICE_ROUNDS)
            graphed = fedavg_algo(cfg, data)
            resident_gb = staged(graphed)
            got = graph_rounds(graphed, data, init, DEVICE_ROUNDS)
            torch.cuda.synchronize()
            graph = graphed._device_round.graph
            if graph is None or graph.captures != 1 \
                    or graph.replays != DEVICE_ROUNDS:
                fail(f"the device round captured "
                     f"{getattr(graph, 'captures', 0)} graphs and replayed "
                     f"{getattr(graph, 'replays', 0)} times; need 1 and "
                     f"{DEVICE_ROUNDS}")
            out[mode] = dict(bit_equal=bit_equal(got, want),
                             max_abs_diff=max_diff(got, want),
                             moved_from_init=max_diff(want, init),
                             capture_ms=graph.capture_s * 1e3,
                             captured_launches=graph.captured_launches)
            del host, graphed, graph
    if not out["deterministic"]["bit_equal"]:
        fail(f"the graphed device round differs from the host loop in "
             f"deterministic mode by {out['deterministic']['max_abs_diff']}")
    if not out["deterministic"]["moved_from_init"] > 10 * ROUND_TOL:
        fail("the device rounds left the global where it was")
    with deterministic():
        cpu = fedavg_algo(dataclasses.replace(cfg, platform="cpu"), data,
                          "cpu")
        cpu._stage_train_on_device()
        init = cpu.init_params()
        cpu_round = graph_rounds(cpu, data, init, 1)
        gpu = fedavg_algo(cfg, data)
        staged(gpu)
        gpu_round = graph_rounds(gpu, data,
                                 {k: v.cuda() for k, v in init.items()}, 1)
        cpu_diff = max_diff(gpu_round, cpu_round)
        del cpu, gpu
    if not cpu_diff <= ROUND_TOL:
        fail(f"the graphed round differs from the CPU round by {cpu_diff} "
             f"> {ROUND_TOL}")
    torch.cuda.empty_cache()

    # the three paths' costs, default mode
    host = fedavg_algo(cfg, data)
    graphed = fedavg_algo(cfg, data)
    staged(graphed)
    scanned = make_scanned_rounds(graphed._local_train, m,
                                  client_axis=cfg.client_axis,
                                  max_rounds=PATH_ROUNDS)
    ids, live = round_plan(data, m, PATH_ROUNDS)
    state = {"host": host.init_params(), "k1": None, "k10": None}
    state["k1"] = state["k10"] = state["host"]

    def run_host():
        state["host"] = host_loop_rounds(host, data, state["host"],
                                         PATH_ROUNDS)

    def run_k1():
        state["k1"] = graph_rounds(graphed, data, state["k1"], PATH_ROUNDS)

    def run_k10():
        state["k10"], _ = scanned(state["k10"], graphed._train_dev, ids, live)

    paths = {"host_loop": path_profile(run_host, PATH_ROUNDS),
             "graph_k1": path_profile(run_k1, PATH_ROUNDS),
             "graph_k10": path_profile(run_k10, PATH_ROUNDS)}
    paths["graph_k1"]["capture_ms"] = graphed._device_round.graph.capture_s \
        * 1e3
    paths["graph_k10"]["capture_ms"] = scanned.graph.capture_s * 1e3
    paths["graph_k10"]["replays_per_call"] = PATH_ROUNDS
    # the host loop's parts (synchronised host timers, 5 rounds)
    parts = {"gather_ms": [], "train_ms": [], "aggregate_ms": []}
    from fedml_tpu_torch.core.pytree import tree_weighted_mean
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.parallel.cohort import train_cohort
    params = host.init_params()
    for r in range(6):
        t0 = time.perf_counter()
        cohort = gather_cohort(data.train,
                               sample_clients(r, data.client_num, m),
                               pad_to=m, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stacked, _ = train_cohort(host._local_train, params, cohort)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params = tree_weighted_mean(stacked, cohort["num_samples"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if r:
            parts["gather_ms"].append((t1 - t0) * 1e3)
            parts["train_ms"].append((t2 - t1) * 1e3)
            parts["aggregate_ms"].append((t3 - t2) * 1e3)
    paths["host_loop"].update({k: statistics.median(v)
                               for k, v in parts.items()})
    phase("device round", resident_train_gb=resident_gb,
          rounds=DEVICE_ROUNDS, vs_host_loop=out, vs_cpu_max_abs_diff=cpu_diff,
          tol=ROUND_TOL, paths=paths,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del host, graphed, scanned, state
    torch.cuda.empty_cache()
    return out, cpu_diff, paths


@contextlib.contextmanager
def recording_runs():
    """Record each ``FedAvg.run``'s algorithm and returned params (the CLI
    runner keeps neither)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg
    real = FedAvg.run
    runs = []

    def run(self, *a, **kw):
        params = real(self, *a, **kw)
        runs.append((self, {k: v.clone() for k, v in params.items()}))
        return params

    FedAvg.run = run
    try:
        yield runs
    finally:
        FedAvg.run = real


@contextlib.contextmanager
def env(name: str, value):
    import os
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def run_scanned(data):
    """Phase 13: 21 rounds, evaluation every 10, through the CLI's runner:
    the host loop (device-data budget 0), the K=1 graph and
    ``--rounds_per_dispatch 10``; eval rounds [0, 10, 20] on each, the
    final params bit-equal in deterministic mode; steady rounds/s and the
    capture time in the default mode."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config, run_fedavg
    from fedml_tpu_torch.utils.metrics import MetricsSink

    variants = {"host_loop": ("0", 1), "graph_k1": (None, 1),
                "graph_k10": (None, SCAN_K)}
    result = {}
    for mode, ctx in (("deterministic", deterministic),
                      ("default", contextlib.nullcontext)):
        finals, rows = {}, {}
        for name, (budget, k) in variants.items():
            cfg = config_from_argv(SCAN_ARGS + ["--rounds_per_dispatch",
                                                str(k)])
            check_config(cfg)
            with ctx(), env("FEDML_TPU_DEVICE_DATA_BYTES", budget), \
                    recording_runs() as runs, MetricsSink(None) as sink:
                t0 = time.perf_counter()
                summary = run_fedavg(cfg, data, sink)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            algo, finals[name] = runs[-1]
            graph = (getattr(algo._scanned_rounds, "graph", None)
                     or getattr(algo._device_round, "graph", None))
            evals = [h["round"] for h in algo.history]
            if evals != [0, 10, 20]:
                fail(f"{name} evaluated at rounds {evals}, need [0, 10, 20]")
            if (graph is None) != (name == "host_loop"):
                fail(f"{name} ran {'a' if graph else 'no'} graph")
            if graph is not None and (graph.captures, graph.replays) \
                    != (1, cfg.comm_round):
                fail(f"{name} captured {graph.captures} graphs and replayed "
                     f"{graph.replays} times; need 1 and {cfg.comm_round}")
            rows[name] = dict(
                rounds_per_s=summary["rounds_per_s"], run_s=run_s,
                capture_ms=graph.capture_s * 1e3 if graph else None,
                replays=graph.replays if graph else 0,
                test_acc=summary["test_acc"], eval_rounds=evals)
            del algo, graph, runs
            torch.cuda.empty_cache()
        for name in ("graph_k1", "graph_k10"):
            rows[name]["bit_equal_to_host_loop"] = bit_equal(
                finals[name], finals["host_loop"])
            rows[name]["max_abs_diff_to_host_loop"] = max_diff(
                finals[name], finals["host_loop"])
        if mode == "deterministic" and not all(
                rows[n]["bit_equal_to_host_loop"]
                for n in ("graph_k1", "graph_k10")):
            fail(f"scanned rounds differ from the host loop in "
                 f"deterministic mode: {rows}")
        result[mode] = rows
    phase("scanned rounds", rounds=21, k=SCAN_K, **result)
    return result


def check_byzantine(data):
    """Phase 14: ``--algo fedavg_robust --defense <rule>`` for each of the
    five rules: one round on the card (TF32 off) against the same round on
    the CPU (ROUND_TOL); Krum and multi-Krum pick the same clients on
    both."""
    import dataclasses
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobust
    from fedml_tpu_torch.core.byzantine import krum_weights
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.stacking import gather_cohort
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  fedavg_robust_config)
    from fedml_tpu_torch.parallel.cohort import train_cohort

    rows = {}
    with tf32_off():
        for rule, extra in BYZ_ARGS.items():
            cfg = config_from_argv(["--algo", "fedavg_robust", "--defense",
                                    rule, *extra, *COMMON_ARGS])
            m = cfg.client_num_per_round
            ids = sample_clients(0, data.client_num, m)
            out, sel = {}, {}
            for dev in ("cuda", "cpu"):
                algo = FedAvgRobust(_make_workload(cfg, data), data,
                                    fedavg_robust_config(
                                        dataclasses.replace(cfg,
                                                            platform=dev)),
                                    device=dev)
                init = algo.init_params()
                cohort = gather_cohort(data.train, ids, pad_to=m, device=dev)
                t0 = time.perf_counter()
                params, _ = algo.cohort_step(init, cohort)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    round_ms = (time.perf_counter() - t0) * 1e3
                out[dev] = {k: v.cpu() for k, v in params.items()}
                if rule in ("krum", "multi_krum"):
                    stacked, _ = train_cohort(algo._local_train, init, cohort)
                    w = krum_weights(stacked, cohort["num_samples"],
                                     cfg.byz_f,
                                     cfg.krum_m if rule == "multi_krum"
                                     else 1)
                    sel[dev] = [int(i) for i in torch.nonzero(w.cpu())]
            diff = max_diff(out["cuda"], out["cpu"])
            rows[rule] = dict(max_abs_diff=diff, round_ms=round_ms)
            if sel:
                rows[rule]["selected"] = sel
                if sel["cuda"] != sel["cpu"]:
                    fail(f"{rule} selected {sel['cuda']} on the card and "
                         f"{sel['cpu']} on the CPU")
            if not diff <= ROUND_TOL:
                fail(f"the {rule} round differs from the CPU round by "
                     f"{diff} > {ROUND_TOL}")
    phase("byzantine", tol=ROUND_TOL, tf32=False, rules=rows)
    return rows


def silo_fed(argv, data, device, init=None):
    import dataclasses
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (CrossSiloFederation,
                                                  check_config)
    from fedml_tpu_torch.utils.metrics import MetricsSink
    cfg = dataclasses.replace(config_from_argv(argv), platform=device)
    check_config(cfg)
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink, init_params=init)
    fed.server.on_round_done = None      # no evaluation
    return fed


def check_silo_robust(data):
    """Phase 15: the live cross-silo server's ``--robust_agg`` on the
    in-process hub, one round on the card (TF32 off) against the CPU:
    the defended stack (trimmed mean, clip 5) and the stream's reservoir
    (coordinate median, K=8); then, on the card, the defended mean in
    stack mode against stream mode (clip 5, sigma 0.025, 2 rounds), bit
    for bit."""
    import torch
    base = ["--algo", "cross_silo", "--silo_backend", "local", *COMMON_ARGS,
            "--comm_round", "1"]
    rows = {}
    with tf32_off():
        for name, extra in SILO_ROBUST_ARGS.items():
            cpu = silo_fed(base + extra, data, "cpu")
            init = {k: v.clone() for k, v in cpu.server.params.items()}
            gpu = silo_fed(base + extra, data, "cuda", init)
            out = {}
            for dev, fed in (("cuda", gpu), ("cpu", cpu)):
                t0 = time.perf_counter()
                fed.run()
                out[dev] = {k: v.cpu() for k, v in fed.server.params.items()}
                if dev == "cuda":
                    round_ms = (time.perf_counter() - t0) * 1e3
            diff = max_diff(out["cuda"], out["cpu"])
            moved = max_diff(out["cpu"], init)
            rows[name] = dict(max_abs_diff=diff, moved_from_init=moved,
                              round_ms=round_ms,
                              stack=gpu.server.aggregate_fn is not None)
            if not moved > 2 * ROUND_TOL or not diff <= ROUND_TOL:
                fail(f"cross-silo {name}: moved {moved}, differs from the "
                     f"CPU by {diff} (limit {ROUND_TOL})")
    means = {}
    init = None
    for mode in ("stack", "stream"):
        fed = silo_fed(SILO_MEAN_ARGS + ["--agg_mode", mode], data, "cuda",
                       init)
        if init is None:
            init = {k: v.clone() for k, v in fed.server.params.items()}
        fed.run()
        means[mode] = {k: v.clone() for k, v in fed.server.params.items()}
    same = bit_equal(means["stack"], means["stream"])
    phase("cross_silo robust", tol=ROUND_TOL, tf32=False, rules=rows,
          stack_mean_bit_equal_stream_mean=same,
          stack_vs_stream_max_abs_diff=max_diff(means["stack"],
                                                means["stream"]))
    if not same:
        fail("the defended stack mean differs from the stream mean on the "
             "card")
    return rows, same


def check_checkpoint(data, root: Path):
    """Phase 16: plain FedAvg through the CLI's runner with
    ``--checkpoint_dir``, stopped after round 2 and resumed, against an
    uninterrupted 4-round run: bit for bit on the card (deterministic
    mode; both runs take the graphed device round)."""
    import torch
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config, run_fedavg
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.utils.metrics import MetricsSink

    ckpt = root / "build" / "checkpoint_phase"
    shutil.rmtree(ckpt, ignore_errors=True)
    finals = {}
    runs_spec = {"straight": [],
                 "stopped": ["--checkpoint_dir", str(ckpt),
                             "--checkpoint_every", "1", "--comm_round",
                             str(CKPT_STOP)],
                 "resumed": ["--checkpoint_dir", str(ckpt),
                             "--checkpoint_every", "1"]}
    with deterministic():
        for name, extra in runs_spec.items():
            cfg = config_from_argv([*FEDAVG_ARGS, "--comm_round",
                                    str(CKPT_ROUNDS), *extra])
            check_config(cfg)
            t0 = time.perf_counter()
            with recording_runs() as runs, MetricsSink(None) as sink:
                run_fedavg(cfg, data, sink)
            torch.cuda.synchronize()
            algo, finals[name] = runs[-1]
            if name != "straight" and algo._device_round.graph is None:
                fail(f"the {name} run did not take the graphed device round")
            finals[name + "_rounds"] = len(algo.round_times)
            finals[name + "_s"] = time.perf_counter() - t0
            del algo, runs
    latest = RoundCheckpointer(str(ckpt)).latest_round()
    same = bit_equal(finals["resumed"], finals["straight"])
    phase("checkpoint", rounds=CKPT_ROUNDS, stopped_after=CKPT_STOP,
          resumed_rounds_run=finals["resumed_rounds"], latest_step=latest,
          bit_equal=same,
          max_abs_diff=max_diff(finals["resumed"], finals["straight"]),
          seconds={k: finals[k + "_s"] for k in runs_spec})
    if not same or latest != CKPT_ROUNDS - 1 \
            or finals["resumed_rounds"] != CKPT_ROUNDS - CKPT_STOP:
        fail("the resumed run does not continue the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    return same


# ---------------------------------------------------------------------------
# live cross-silo fault tolerance and transports: crash -> resume through
# the round journal, chaos on the threaded drive, MQTT over the repo's own
# broker (the sharded slice's configuration, K2 in every closed round)
# ---------------------------------------------------------------------------

FT_ROUNDS = 3                  # rounds of the crash-resume and MQTT runs
CRASH_AT = (("post_admission_pre_fold", 2), ("post_fold_pre_ack", 2),
            ("barrier_close", 1), ("mid_checkpoint_write", 1))
CRASH_ROUND = 1                # the round each kill lands in
CHAOS_ROUNDS = 4
CHAOS_RATES = ["--chaos_drop", "0.1", "--chaos_dup", "0.1",
               "--chaos_reorder", "0.1", "--chaos_delay", "0.1",
               "--chaos_corrupt", "0.05"]
# the straggler timeout T and the detector's dead_after_s D are picked from
# the pumped round the crash-resume phase measures: T = CHAOS_T_ROUNDS x
# that round (at least CHAOS_T_MIN_S), D = CHAOS_D_OVER_T x T
CHAOS_T_ROUNDS, CHAOS_T_MIN_S, CHAOS_D_OVER_T = 5, 1.0, 3
# per round: the server's global against the replay of that round from the
# server's previous global (the server's fold order, the plain finalize);
# and each admitted upload the chaos did not touch against its replayed
# training
CHAOS_REPLAY_TOL = ROUND_TOL
MQTT_TOL = ROUND_TOL           # MQTT global vs the pumped hub's: the fold
#                                adds in arrival order, which threads do
#                                not fix, and training carries the ulps on


def ft_cfg(extra, rounds: int):
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    cfg = config_from_argv([*SILO_ARGS, "--comm_round", str(rounds),
                            *extra])
    check_config(cfg)
    return cfg


def ft_fed(cfg, data, init=None, **kw):
    """The runner's federation for ``cfg`` (no evaluation), recording each
    closed round's wall time and global."""
    from fedml_tpu_torch.experiments.main import CrossSiloFederation
    from fedml_tpu_torch.utils.metrics import MetricsSink
    with MetricsSink(None) as sink:
        fed = CrossSiloFederation(cfg, data, sink, init_params=init, **kw)
    fed.closed = []
    mark = {"t": None}

    def on_round_done(r, params):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        fed.closed.append((r, now - (mark["t"] or fed.t_start),
                           {k: v.clone() for k, v in params.items()}))
        mark["t"] = now

    fed.server.on_round_done = on_round_done
    fed.t_start = None
    return fed


def ft_run(fed):
    import torch
    torch.cuda.synchronize()
    fed.t_start = time.perf_counter()
    return fed.run()


def rounds_per_s(fed) -> float:
    """Closed rounds after the first (which carries the warm-up) per
    second."""
    times = [dt for _, dt, _ in fed.closed][1:]
    return len(times) / sum(times) if times else 0.0


def steady_round_ms(fed) -> float:
    times = [dt for _, dt, _ in fed.closed][1:] or \
        [dt for _, dt, _ in fed.closed]
    return statistics.median(times) * 1e3


def check_silo_crash_resume(data, root: Path):
    """Phase 17: the sharded cross-silo slice killed in round 1 at four
    crash points and resumed in the same process from its checkpoint and
    journal under ``build/``: each resumed global bit-equal on the card to
    the uncrashed run's (the sharded fold state device -> host -> disk ->
    device, and the resumed K2 finalize; deterministic mode).  A journal
    whose opening-global crc was tampered with is abandoned and the run
    still ends equal.  Snapshot costs and the journaled round beside the
    plain one."""
    import torch
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                                  Faultline)
    base = root / "build" / "silo_crash"
    shutil.rmtree(base, ignore_errors=True)

    def durable(tag):
        return ["--checkpoint_dir", str(base / tag / "ck"),
                "--checkpoint_every", "1",
                "--journal_dir", str(base / tag / "j"),
                "--journal_snapshot_every", "1"]

    out = {}
    with deterministic():
        plain = ft_fed(ft_cfg([], FT_ROUNDS), data)
        init = {k: v.clone() for k, v in plain.server.params.items()}
        ft_run(plain)
        ref = ft_fed(ft_cfg(durable("ref"), FT_ROUNDS), data, init)
        snaps = []
        real_snapshot = ref.journal.snapshot

        def snapshot(*a, **kw):
            ok = real_snapshot(*a, **kw)
            if ok:
                snaps.append(dict(ref.journal.last_snapshot_ms))
            return ok

        ref.journal.snapshot = snapshot
        ft_run(ref)
        want = ref.server.params
        if not bit_equal(plain.server.params, want):
            fail("the journaled cross-silo run differs from the plain run")
        points = {}
        for point, hit in CRASH_AT:
            cfg = ft_cfg(durable(point), FT_ROUNDS)
            fl = Faultline(crashes=[CrashSpec(point=point, hit=hit,
                                              round_idx=CRASH_ROUND)])
            killed = ft_fed(cfg, data, init, faultline=fl)
            try:
                ft_run(killed)
                fail(f"the {point} kill never fired")
            except ActorKilled:
                pass
            fl.respawn()
            resumed = ft_fed(cfg, data, init)
            trained = []
            for silo in resumed.silos:
                real_fn = silo.train_fn

                def train_fn(params, client_idx, round_idx, _fn=real_fn,
                             _silo=silo.node_id):
                    trained.append((round_idx, _silo))
                    return _fn(params, client_idx, round_idx)
                silo.train_fn = train_fn
            fused_agg.reset_launch_counts()
            ft_run(resumed)
            torch.cuda.synchronize()
            k2 = fused_agg.launch_counts["shard_finalize"]
            rounds_after = len(resumed.closed)
            same = bit_equal(resumed.server.params, want)
            points[point] = dict(
                hit=hit, retasked=sorted(s for r, s in trained
                                         if r == CRASH_ROUND),
                rounds_after_resume=rounds_after, k2_launches=k2,
                bit_equal=same,
                max_abs_diff=max_diff(resumed.server.params, want))
            if not same:
                fail(f"the run resumed after a kill at {point} differs from "
                     f"the uncrashed run on the card")
            need = plain.cfg.model_shards * rounds_after
            if k2 != need or rounds_after != FT_ROUNDS - CRASH_ROUND:
                fail(f"after the {point} resume: {rounds_after} rounds "
                     f"closed, {k2} K2 launches (need "
                     f"{FT_ROUNDS - CRASH_ROUND} and {need})")
        # a journal whose opening crc disagrees with the restored global
        cfg = ft_cfg(durable("tampered"), FT_ROUNDS)
        fl = Faultline(crashes=[CrashSpec(point="barrier_close",
                                          round_idx=CRASH_ROUND)])
        try:
            ft_run(ft_fed(cfg, data, init, faultline=fl))
            fail("the tampered-journal kill never fired")
        except ActorKilled:
            pass
        path = base / "tampered" / "j" / "journal.jsonl"
        lines = path.read_text().splitlines()
        start = json.loads(lines[0])
        start["global_crc"] = (start["global_crc"] + 1) % 2 ** 32
        lines[0] = json.dumps(start, sort_keys=True)
        path.write_text("\n".join(lines) + "\n")
        tampered = ft_fed(cfg, data, init)
        abandoned = []
        real_abandon = tampered.journal.abandon
        tampered.journal.abandon = lambda r, why: (abandoned.append(
            [r, why]), real_abandon(r, why))
        ft_run(tampered)
        tampered_same = bit_equal(tampered.server.params, want)
        if abandoned != [[CRASH_ROUND, "global crc mismatch"]] \
                or not tampered_same:
            fail(f"the tampered journal: abandoned {abandoned}, bit-equal "
                 f"{tampered_same}")
    snap = {k: statistics.median(s[k] for s in snaps)
            for k in ("state_ms", "encode_ms", "write_ms", "fsync_ms",
                      "bytes")}
    out = dict(
        rounds=FT_ROUNDS, crash_round=CRASH_ROUND, snapshot_every=1,
        points=points, tampered_crc=dict(abandoned=abandoned,
                                         bit_equal=tampered_same),
        snapshots=len(snaps), snapshot_median=snap,
        snapshot_ms=[[s["state_ms"], s["encode_ms"], s["write_ms"],
                      s["fsync_ms"]] for s in snaps],
        snapshot_max_ms=max(s["state_ms"] + s["encode_ms"] + s["write_ms"]
                            + s["fsync_ms"] for s in snaps),
        plain_round_ms=steady_round_ms(plain),
        journaled_round_ms=steady_round_ms(ref),
        snapshot_ms_per_round=sum(
            s["state_ms"] + s["encode_ms"] + s["write_ms"] + s["fsync_ms"]
            for s in snaps) / FT_ROUNDS,
        bit_equal=all(p["bit_equal"] for p in points.values()))
    phase("cross_silo crash resume", **out)
    shutil.rmtree(base, ignore_errors=True)
    return out


def _tree_leaves(tree):
    from fedml_tpu_torch.comm.chaos import _array_leaves
    return _array_leaves(tree, [])


def _copy_tree(tree):
    import numpy as np
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def check_silo_chaos(data, round_ms: float):
    """Phase 18: the sharded slice on the threaded drive (each actor on
    its own thread) for 4 rounds under seeded chaos on every link but
    silo 1's (it stays clean, so a round always has a report to close on):
    every round closes, faults were injected, no upload is folded twice,
    every folded upload is finite (a NaN corruption never reaches the
    fold), K2 launches 4 times a closed round, and each round's global
    equals its replay from the server's previous global: the admitted
    silos, in the server's fold order, trained again from that global (an
    upload the chaos did not touch must match the server's within
    CHAOS_REPLAY_TOL) and folded and finalized with K2's plain version.
    An upload of a silo whose frames the chaos corrupted that round is
    replayed as the server admitted it, and those unlike their clean
    replay are counted: a flipped low-order byte leaves a valid float near
    the true one, which no screen can tell from an honest update."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fedml_tpu_torch.comm import chaos as chaos_mod
    from fedml_tpu_torch.comm.chaos import LinkChaos
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.core.pytree import (flatten_nested, nest, to_host,
                                             tree_keys)
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.experiments.main import (_make_workload,
                                                  _silo_training_setup)
    from fedml_tpu_torch.shard_spine import build_shard_spine
    from fedml_tpu_torch.shard_spine.plan import SiloShardCodec

    t_s = max(CHAOS_T_MIN_S, math.ceil(CHAOS_T_ROUNDS * round_ms / 500) / 2)
    d_s = CHAOS_D_OVER_T * t_s
    cfg = ft_cfg([*CHAOS_RATES, "--straggler_policy", "drop",
                  "--round_timeout_s", str(t_s), "--heartbeat_s", "0.05",
                  "--dead_after_s", str(d_s), "--min_silo_frac", "0.1"],
                 CHAOS_ROUNDS)
    corrupted = []
    real_corrupt = chaos_mod._corrupt_payload

    def corrupt(msg, u_leaf, u_mode, u_pos):
        out = real_corrupt(msg, u_leaf, u_mode, u_pos)
        if out is not None:
            corrupted.append(dict(
                src=msg.sender_id, dst=msg.receiver_id,
                round=msg.get(Message.ARG_ROUND),
                shard=msg.get(Message.ARG_SHARD),
                mode="nan" if u_mode < 0.5 else "flip"))
        return out

    with deterministic():
        fed = ft_fed(cfg, data)
        if fed.drive != "threaded":
            fail(f"--chaos_* took the {fed.drive} drive")
        init = {k: v.clone() for k, v in fed.server.params.items()}
        fed.chaos_plan.links[(0, 1)] = LinkChaos()
        fed.chaos_plan.links[(1, 0)] = LinkChaos()
        server = fed.server
        folds = {}
        rejected = {}
        real_note = server._note_upload

        def note_upload(silo, entry):
            if entry is None:
                rejected.setdefault(server.round_idx, []).append(silo)
            else:
                folds.setdefault(server.round_idx, []).append(
                    (silo, [_copy_tree(s) for s in entry[0]],
                     float(entry[1])))
            return real_note(silo, entry)

        server._note_upload = note_upload
        chaos_mod._corrupt_payload = corrupt
        fused_agg.reset_launch_counts()
        prof = profile(activities=[ProfilerActivity.CUDA])
        try:
            with prof:
                summary = ft_run(fed)
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - fed.t_start
        finally:
            chaos_mod._corrupt_payload = real_corrupt
        k2 = fused_agg.launch_counts["shard_finalize"]
        closed = [r for r, _, _ in fed.closed]
        faults = {}
        for t in [server.transport] + [s.transport for s in fed.silos]:
            for kind, n in t.faults.items():
                faults[kind] = faults.get(kind, 0) + n
        if server.aborted or closed != list(range(CHAOS_ROUNDS)):
            fail(f"chaos: rounds closed {closed}, aborted {server.aborted}")
        if not sum(faults.values()):
            fail("chaos: the plan injected no fault")
        if k2 != cfg.model_shards * len(closed):
            fail(f"chaos: {k2} K2 launches for {len(closed)} rounds")
        for r, row in folds.items():
            silos = [s for s, _, _ in row]
            if len(set(silos)) != len(silos):
                fail(f"chaos: round {r} folded a silo twice: {silos}")
            for _, slices, _ in row:
                if not all(np.isfinite(a).all() for sl in slices
                           for a in _tree_leaves(sl)):
                    fail(f"chaos: round {r} folded a non-finite upload")
        if not summary.get("params_finite"):
            fail("chaos: the global is not finite")
        # the replay, round by round from the server's own record
        wl = _make_workload(cfg, data)
        device = server.device
        globals_ = [init] + [p for _, _, p in fed.closed]
        _, make_train_fn = _silo_training_setup(cfg, data, wl, device, init)
        # the slice's spine, its finalize swapped for K2's plain version
        spine = build_shard_spine(init, num_shards=cfg.model_shards,
                                  norm_clip=cfg.norm_clip,
                                  noise_std=cfg.agg_noise_std, seed=cfg.seed,
                                  fused="on")
        codec = SiloShardCodec(spine.spec())
        touched = {(c["round"], c["dst"] if c["src"] == 0 else c["src"])
                   for c in corrupted}
        upload_diff, round_diff, replayed = 0.0, 0.0, 0
        touched_folded, touched_differ = 0, 0
        for r in range(CHAOS_ROUNDS):
            g = globals_[r]
            params = codec.join(spine.broadcast_slices(to_host(nest(g))))
            ids = sample_clients(r, data.client_num, len(fed.silos))
            spine.agg.reset(g)
            for silo, slices, weight in folds.get(r, []):
                new, _ = make_train_fn(silo)(flatten_nested(params),
                                             int(ids[silo - 1]), r)
                mine = codec.split(to_host(nest(
                    {k: new[k] for k in tree_keys(new)})))
                diff = max(float(np.abs(np.asarray(a, np.float64) - b).max())
                           for a_sl, b_sl in zip(mine, slices)
                           for a, b in zip(_tree_leaves(a_sl),
                                           _tree_leaves(b_sl)))
                if (r, silo) in touched:
                    # a frame of this silo's round was corrupted: the
                    # replay folds what the server admitted
                    touched_folded += 1
                    touched_differ += diff > 0
                    spine.agg.fold_slices(slices, weight)
                    continue
                upload_diff = max(upload_diff, diff)
                replayed += 1
                spine.agg.fold_slices(mine, weight)
            if folds.get(r):
                real_k2 = fused_agg.shard_finalize
                fused_agg.shard_finalize = fused_agg.shard_finalize_plain
                try:
                    out = spine.agg.finalize(r)
                finally:
                    fused_agg.shard_finalize = real_k2
                round_diff = max(round_diff, max_diff(out, globals_[r + 1]))
        if upload_diff > CHAOS_REPLAY_TOL or round_diff > CHAOS_REPLAY_TOL:
            fail(f"chaos: the replay differs (uploads {upload_diff}, rounds "
                 f"{round_diff}; limit {CHAOS_REPLAY_TOL})")
    events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    busy_s = sum(_self_device_us(e) for e in events) / 1e6
    up = [c for c in corrupted if c["src"] != 0]
    row = dict(
        rounds=CHAOS_ROUNDS, round_timeout_s=t_s, dead_after_s=d_s,
        measured_pumped_round_ms=round_ms, heartbeat_s=cfg.heartbeat_s,
        min_silo_frac=cfg.min_silo_frac, faults=faults,
        corrupted_frames={"down": sum(c["src"] == 0 for c in corrupted),
                          "up_nan": sum(c["mode"] == "nan" for c in up),
                          "up_flip": sum(c["mode"] == "flip" for c in up)},
        rejected_reports={r: sorted(v) for r, v in rejected.items()},
        rejected_by_reason=dict(server.shard_wire.admission.rejected),
        folded_per_round=[len(folds.get(r, [])) for r in range(
            CHAOS_ROUNDS)],
        dropped_silos={r: v for r, v in server.dropped_silos.items()},
        k2_launches=k2, replayed_uploads=replayed,
        touched_uploads_folded=touched_folded,
        touched_uploads_folded_unlike_replay=touched_differ,
        upload_max_abs_diff=upload_diff,
        round_max_abs_diff=round_diff, tol=CHAOS_REPLAY_TOL,
        rounds_per_s=rounds_per_s(fed), wall_s=wall_s,
        device_busy_s=busy_s, device_idle_share=1 - busy_s / wall_s)
    phase("cross_silo chaos threaded", **row)
    return row


def in_silo_order(fed, timeout_s: float = 120.0) -> None:
    """Hold each silo's upload until every lower-numbered silo has
    reported this round, so the server folds in the pumped hub's order
    (silo 1, 2, ...) while the silos still train at once on their own
    threads."""
    server = fed.server
    for silo in fed.silos:
        real_fn, before = silo.train_fn, set(range(1, silo.node_id))

        def train_fn(params, client_idx, round_idx, _fn=real_fn,
                     _before=before):
            out = _fn(params, client_idx, round_idx)
            deadline = time.monotonic() + timeout_s
            while server.round_idx == round_idx \
                    and not _before <= set(server._received):
                if time.monotonic() > deadline:
                    fail(f"silo order: round {round_idx} never got silos "
                         f"{sorted(_before)}")
                time.sleep(0.001)
            return out
        silo.train_fn = train_fn


def check_silo_mqtt(data):
    """Phase 19: the sharded slice over the repo's MQTT broker on the
    loopback, the server and 10 silo threads each on a `MiniMqttClient`
    wrapped in `ResilientTransport`, 3 rounds: K2 launches 4 times a
    round, and the global agrees with the pumped hub run of the same seeds
    within MQTT_TOL (the uploads are held to the hub's arrival order, so
    bit for bit is expected and reported); rounds/s, the bytes through
    the broker and the MQTT round beside the hub round."""
    import torch
    from fedml_tpu_torch.comm import mqtt_transport
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
    from fedml_tpu_torch.comm.resilient import ResilientTransport, RetryPolicy
    from fedml_tpu_torch.core import fused_agg

    cfg = ft_cfg([], FT_ROUNDS)
    with deterministic():
        hub = ft_fed(cfg, data)
        init = {k: v.clone() for k, v in hub.server.params.items()}
        ft_run(hub)
        broker = MqttBroker()
        try:
            def transport(node):
                return ResilientTransport(
                    mqtt_transport.MqttTransport(node, "127.0.0.1",
                                                 broker.port),
                    RetryPolicy(max_attempts=4), seed=cfg.seed)

            fed = ft_fed(cfg, data, init, transport_factory=transport)
            if fed.drive != "threaded":
                fail(f"the MQTT federation took the {fed.drive} drive")
            in_silo_order(fed)
            fused_agg.reset_launch_counts()
            summary = ft_run(fed)
            torch.cuda.synchronize()
            k2 = fused_agg.launch_counts["shard_finalize"]
        finally:
            broker.stop()
    diff = max_diff(fed.server.params, hub.server.params)
    row = dict(
        rounds=FT_ROUNDS, client=type(fed.server.transport.inner._client)
        .__name__, k2_launches=k2, max_abs_diff_vs_hub=diff, tol=MQTT_TOL,
        bit_equal_hub=bit_equal(fed.server.params, hub.server.params),
        rounds_per_s=rounds_per_s(fed), hub_rounds_per_s=rounds_per_s(hub),
        round_ms=steady_round_ms(fed), hub_round_ms=steady_round_ms(hub),
        broker_bytes_in_per_round=broker.bytes_in / FT_ROUNDS,
        broker_bytes_out_per_round=broker.bytes_out / FT_ROUNDS,
        dead_letters=fed.server.transport.dead_letters + sum(
            s.transport.dead_letters for s in fed.silos))
    row["mqtt_over_hub_ms"] = row["round_ms"] - row["hub_round_ms"]
    phase("cross_silo mqtt", **row)
    if k2 != cfg.model_shards * FT_ROUNDS or fed.server.round_idx != FT_ROUNDS:
        fail(f"mqtt: {fed.server.round_idx} rounds, {k2} K2 launches")
    if not summary.get("params_finite") or not diff <= MQTT_TOL:
        fail(f"mqtt: the global differs from the hub's by {diff} (limit "
             f"{MQTT_TOL})")
    return row


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


K4_KERNELS = {"flash_fwd": "flash_fwd_kernel",
              "flash_bwd_dkv": "flash_bwd_dkv_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel"}


def graph_kernel_counts(dot: str, names) -> dict:
    """Kernel nodes of a CUDA graph's Graphviz dump
    (``cudaGraphDebugDotPrint``) whose label names each of ``names``: the
    text split at each node's definition, each node counted once."""
    nodes = re.split(r'\n\s*"?graph_\d+_node_\d+"?\s*\[', dot)[1:]
    return {n: sum(1 for node in nodes if n in node) for n in names}


def run_lm_slice(data, root: Path):
    """The transformer slice's main path: FedAvg through the API on the
    flash model, LM_ROUNDS rounds with an evaluation at the first and the
    last.  The rounds run as replays of one captured CUDA graph, so the
    kernels launched in training are those of the warm-up round (through
    the wrappers) and the captured ones once per replay: the capture must
    hold n_layers x S launches of each K4 kernel, by the wrappers' counts
    during the capture and by the graph's own kernel nodes, and the graph
    must replay once a round; evaluation launches only K4f (counted
    apart)."""
    import torch
    from fedml_tpu_torch.models import flash_attention as fa
    from fedml_tpu_torch.parallel import cohort

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
    dot_dir = root / "build" / "graphs"
    shutil.rmtree(dot_dir, ignore_errors=True)
    cohort.GRAPH_DOT_DIR = str(dot_dir)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        params = algo.run()
        torch.cuda.synchronize()
    finally:
        cohort.GRAPH_DOT_DIR = None
    run_s = time.perf_counter() - t0
    total = dict(fa.launch_counts)
    graph = getattr(algo._device_round, "graph", None)
    if graph is None:
        fail("the transformer slice did not run the graphed device round")
    steps = int(data.train["mask"].shape[1]) * LM_FEDAVG["epochs"]
    per_round = LM["n_layers"] * steps
    captured = {k: graph.captured_launches.get(k, 0) for k in total}
    warmup = {k: graph.warmup_launches.get(k, 0) for k in total}
    wrapper_train = {k: total[k] - eval_counts[k] for k in total}
    nodes = graph_kernel_counts(Path(graph.dot_path).read_text(),
                                K4_KERNELS.values())
    nodes = {k: nodes[v] for k, v in K4_KERNELS.items()}
    if graph.captures != 1 or graph.replays != LM_ROUNDS:
        fail(f"the transformer slice captured {graph.captures} graphs and "
             f"replayed {graph.replays} times; need 1 and {LM_ROUNDS}")
    if any(captured[k] != per_round or nodes[k] != per_round
           or warmup[k] != per_round * graph.warmup_rounds
           or wrapper_train[k] != warmup[k] + captured[k] for k in total):
        fail(f"the transformer slice's graph holds {nodes} K4 kernel nodes "
             f"and its capture launched {captured} (warm-up {warmup}, "
             f"wrapper calls in training {wrapper_train}); each K4 kernel "
             f"must appear n_layers x S = {per_round} times a round")
    if eval_counts["flash_bwd_dkv"] or eval_counts["flash_bwd_dq"] \
            or not eval_counts["flash_fwd"]:
        fail(f"evaluation launched {eval_counts}; it runs K4f only")
    # launches on the main path: the eager ones (warm-up, evaluation) and
    # the captured ones once per replay
    train = {k: warmup[k] + captured[k] * graph.replays for k in total}
    launches = {k: train[k] + eval_counts[k] for k in total}
    last = algo.history[-1]
    finite = all(bool(v.isfinite().all()) for v in params.values())
    if not finite or not all(
            float(last[k]) == float(last[k]) for k in ("train_loss",
                                                       "test_loss")):
        fail(f"the transformer slice produced non-finite values: {last}")
    steady = algo.round_times[1:]
    phase("transformer slice", graph_kernel_nodes=nodes,
          captured_launches=captured, warmup_launches=warmup,
          replays=graph.replays, train_launches=train,
          eval_launches=eval_counts, launches_per_round=per_round,
          steps_per_round=steps, capture_ms=graph.capture_s * 1e3,
          run_s=run_s, rounds_per_s=len(steady) / sum(steady),
          steady_round_ms=sum(steady) / len(steady) * 1e3,
          train_loss=last["train_loss"], test_loss=last["test_loss"],
          test_acc=last["test_acc"], params_finite=finite,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, per_round, len(steady) / sum(steady)


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
    ptxas = {name: ptxas_report(cuda_build.build_log(name))
             for name in ("robust_agg", "secagg_mask")}
    phase("kernel build K1 K3", ptxas=ptxas)
    _, sm_hz = sm_clocks_hz()

    from fedml_tpu_torch.algorithms.fedavg import round_seed_words
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.models import CNNOriginalFedAvg
    from fedml_tpu_torch.core.pytree import tree_keys

    cnn = dict(CNNOriginalFedAvg(only_digits=False).named_parameters())
    leaf_sizes = {k.replace(".", "/"): p.numel() for k, p in cnn.items()}
    leaf_sizes = {k: leaf_sizes[k] for k in tree_keys(leaf_sizes)}
    rows, worst = check_kernel(leaf_sizes, round_seed_words(0, 0), sm_hz)
    k1_table = check_k1_table(leaf_sizes, round_seed_words(0, 1), sm_hz)

    cfg = config_from_argv(SLICE_ARGS)
    data, (launches, norm_launches), summary = run_slice(cfg)
    profile_rounds(cfg, data)
    round_diff = round_parity(cfg, data)

    mask_rows, mask_worst = check_secagg_kernel(leaf_sizes, sm_hz)
    k3_table = check_k3_table(leaf_sizes, sm_hz)
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

    _, device_round_cpu_diff, paths = check_device_round(data)
    scanned = run_scanned(data)
    check_byzantine(data)
    check_silo_robust(data)
    check_checkpoint(data, root)
    crash = check_silo_crash_resume(data, root)
    chaos = check_silo_chaos(data, crash["plain_round_ms"])
    mqtt = check_silo_mqtt(data)

    flash_build = check_flash_build(libs["flash_attention"])
    flash_rows, flash_worst = check_flash_kernel()
    check_flash_nan()
    data_lm = lm_data()
    k4_launches, k4_per_round, lm_rounds_per_s = run_lm_slice(data_lm, root)
    profile_lm(data_lm)
    lm_diff = lm_round_parity(data_lm)
    lm_bench = lm_bench_step()
    lm_cli = run_lm_cli()

    # one round of the defended slice: the norm pass and one aggregate
    # launch over the CNN's leaves
    clean = [r for r in rows if r["leaf"] in leaf_sizes and not r["sigma"]]
    noisy, quiet = k1_table["table"][SIGMA], k1_table["table"][0.0]
    norm = k1_table["clip_norm"]
    kernels = [{
        "name": "robust_agg", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/robust_agg.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:79",
        "launches": launches,
        "max_abs_err": max(worst, *k1_table["max_abs_err"].values()),
        "ms": noisy["ms"], "plain_ms": noisy["plain_ms"],
        "bound_ms": noisy["bound_ms"], "bound_by": noisy["bound_by"],
        "bound_term": noisy["bound_term"],
        "library_ms": sum(r["library_ms"] for r in clean),
        # the kernel at the library call's configuration (sigma = 0): no
        # single PyTorch call computes the noisy function
        "ms_at_library_config": quiet["ms"],
        "gauss_max_abs_err": k1_table["gauss_max_abs_err"],
        "gauss_tol": K1_GAUSS_TOL,
    }, {
        "name": "clip_norm", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/robust_agg.cu",
        "replaces": "fedml_tpu/core/pallas_agg.py:250",
        "launches": norm_launches,
        "max_abs_err": k1_table["scales_max_abs_diff"],
        "ms": norm["ms"], "plain_ms": norm["plain_ms"],
        "bound_ms": norm["bound_ms"], "bound_by": norm["bound_by"],
        # no single PyTorch call computes the per-client norm over all the
        # leaves; plain_ms is the eager clip pass the kernel replaced
        "library_ms": None,
    }]
    # one round of the secure slice: one launch per group of 5
    per_round = turbo_cfg.group_num
    path = k3_table["path"]
    kernels.append({
        "name": "secagg_mask", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/secagg_mask.cu",
        "replaces": "fedml_tpu/secure/pallas_mask.py:72",
        "launches": mask_launches, "max_abs_err": mask_worst,
        "ms": per_round * path["ms"],
        "plain_ms": per_round * path["plain_ms"],
        "bound_ms": per_round * path["bound_ms"],
        "bound_by": path["bound_by"], "bound_term": path["bound_term"],
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
          silo_resume_bit_equal=crash["bit_equal"],
          silo_chaos_rounds_per_s=chaos["rounds_per_s"],
          silo_mqtt_rounds_per_s=mqtt["rounds_per_s"],
          lm_flash_vs_blockwise_max_abs_diff=lm_diff,
          lm_rounds_per_s=lm_rounds_per_s,
          lm_bench_tokens_per_s={k: v["tokens_per_s"]
                                 for k, v in lm_bench.items()},
          lm_cli_rounds_per_s=lm_cli["rounds_per_s"],
          device_round_vs_cpu_max_abs_diff=device_round_cpu_diff,
          fedavg_round_ms={k: v["round_ms"] for k, v in paths.items()},
          fedavg_rounds_per_s={k: v["rounds_per_s"]
                               for k, v in scanned["default"].items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
