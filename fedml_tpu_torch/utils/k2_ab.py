"""Time builds of a kernel's source side by side on one card, in one
process: K2 (the shard finalize), K1 (the robust aggregate), K3 (the
secagg mask), or the bf16 K4f, K4dkv and K4dq (flash attention).

    python3 -m fedml_tpu_torch.utils.k2_ab [k2] A.cu B.cu [C.cu ...]
    python3 -m fedml_tpu_torch.utils.k2_ab k1 A.cu B.cu [C.cu ...]
    python3 -m fedml_tpu_torch.utils.k2_ab k3 A.cu B.cu [C.cu ...]
    python3 -m fedml_tpu_torch.utils.k2_ab k4f A.cu B.cu [C.cu ...]
    python3 -m fedml_tpu_torch.utils.k2_ab k4dkv A.cu B.cu [C.cu ...]
    python3 -m fedml_tpu_torch.utils.k2_ab k4dq A.cu B.cu [C.cu ...]

Run from the root of a checkout on a machine with a GPU.  Each source is a
version of the kernel's file under ``csrc/`` (for example the parent
commit's, from ``git show``, and the working tree's); each is built with
the port's ``nvcc`` flags (``-I csrc``) into its own library under
``build/kernels/ab/`` (its ``nvcc`` log, ptxas's lines included, beside
it) and loaded with ctypes.  Every version is checked against the plain
version first, then the versions are timed in turns (A B C, C B A,
twice), each turn the mean device time of 50 calls from
``torch.profiler``, and the median of the four turns is kept.  Prints JSON
lines, times in microseconds.  Exits non-zero without a GPU.

* k2: ``shard_finalize_f32`` at the FEMNIST CNN's four shards at S=4, the
  whole model and sizes 3, 1 and 0 mod 4, sigma 0 and 0.025: bit-equal to
  ``shard_finalize_plain`` at sigma 0, within 1e-6 at sigma > 0;
  ``torch.div`` by a device scalar (the same function, bit for bit) and by
  a Python float (a multiply by the reciprocal) timed beside them.
* k1: a round of the defended slice's aggregate over the CNN's 8 leaves
  for 10 clients, clip scales given, sigma 0 and 0.025: one table launch
  for a source that has ``robust_agg_table_f32``, else one launch per leaf;
  within 1e-5 of ``robust_agg_plain`` leaf by leaf.  The norm pass of a
  source that has ``clip_norm_f32`` is timed beside the eager clip pass.
* k3: a round's masking of one group of 5 over the CNN's 8 leaves: one
  table launch (the pair keys derived in it) for a source that has
  ``secagg_mask_table_i32``, else one launch per leaf with the pair seeds
  already on the card; bit-equal to ``quantize_mask_plain`` leaf by leaf.
  The host derivation of the pair seeds that the per-leaf form needs is
  timed beside it.
* k4f, k4dkv, k4dq: ``flash_fwd_bf16``, ``flash_bwd_dkv_bf16`` or
  ``flash_bwd_dq_bf16`` of a ``flash_attention.cu`` at the bf16 LM's
  vmapped call, [B, T, H, d] = [8, 2048, 8, 32] (bf16 q, k, v, dO from a
  seed; m, l and di from the plain forward): o, dk, dv, dq within 2^-7 x
  max|ref| of the plain versions,
  m and l within 1e-5 x max|ref|; beside each, the wrapper's host time
  (its enqueue), and for k4f scaled_dot_product_attention's bf16 forward
  (a yardstick the port never calls).  Each row names the card and its
  power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from fedml_tpu_torch.core import fused_agg as fa
from fedml_tpu_torch.utils import cuda_build

SIZES = {"s0": 422_238, "s1": 422_944, "s2": 422_208, "s3": 422_656,
         "full": 1_690_046, "odd": 1_000_003, "one": 1_000_001,
         "four": 1_000_004}
WSUM, STEP, SEED_WORD = 123.0, 7, fa.shard_seed_word(0, 1)
N_CLIENTS, GROUP, SIGMA, CLIP_BOUND = 10, 5, 0.025, 5.0


def bind_k2(handle):
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.shard_finalize_f32.argtypes = [p, p, ctypes.c_longlong, f32,
                                          i32, i32, f32, p]
    handle.shard_finalize_f32.restype = i32
    return handle


def bind_k1(handle):
    """K1's entry points on a source's library: a leaf-table source's
    through ``fused_agg.bind_k1``; an older per-leaf source has only
    ``robust_agg_f32``, of the same signature."""
    if hasattr(handle, "robust_agg_table_f32"):
        return fa.bind_k1(handle)
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    handle.robust_agg_f32.argtypes = [p, p, p, p, p, i64, i64, i32, i32, f32,
                                      p]
    handle.robust_agg_f32.restype = i32
    return handle


def bind_k3(handle):
    """K3's entry points on a source's library: a leaf-table source's
    through ``fused_mask.bind_k3``; an older per-leaf source has only
    ``secagg_mask_i32``, of the same signature."""
    from fedml_tpu_torch.secure import fused_mask as fm
    if hasattr(handle, "secagg_mask_table_i32"):
        return fm.bind_k3(handle)
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    handle.secagg_mask_i32.argtypes = [p, p, p, p, i64, i32, i32, i64, f32,
                                       f32, p]
    handle.secagg_mask_i32.restype = i32
    return handle


def build(sources, bind):
    """One library per source, keyed by the source as given, every nvcc
    started together; ``bind`` declares the entry points."""
    out_dir = cuda_build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{i}_{Path(src).stem}.so"
        procs[src] = (lib, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{log}")
        lib.with_suffix(".log").write_text(log)      # ptxas -v, per kernel
        libs[src] = bind(ctypes.CDLL(str(lib)))
    return libs


def kernel_us(fn, reps: int = 50, tries: int = 3) -> float:
    """Mean device time (us) of the kernels one call of ``fn`` launches,
    from torch.profiler; a window in which the profiler recorded no device
    time (it happens now and then) is profiled again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA)
        if total:
            return total / reps
    sys.exit("torch.profiler recorded no device time")


def in_turns(calls) -> dict:
    """Median device time (us) of each named call over four turns, the
    order reversed every other turn."""
    names = list(calls)
    turns = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            turns[name].append(kernel_us(calls[name]))
    return {n: statistics.median(t) for n, t in turns.items()}


def host_us(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def enqueue_us(fn, reps: int = 20) -> float:
    """Host time (us) of one call of ``fn`` that only enqueues work: the
    clock stops before the closing synchronize (the calls queue behind
    the device's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def cnn_leaf_sizes():
    """The FEMNIST CNN's leaves in JAX's leaf order, by size."""
    from fedml_tpu_torch.core.pytree import tree_keys
    from fedml_tpu_torch.models import CNNOriginalFedAvg
    cnn = {k.replace(".", "/"): p.numel() for k, p in
           CNNOriginalFedAvg(only_digits=False).named_parameters()}
    return {k: cnn[k] for k in tree_keys(cnn)}


def run_k2(sources) -> None:
    libs = build(sources, bind_k2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    wsum_t = torch.tensor(WSUM, device=dev)
    names = list(libs)
    for size, d in SIZES.items():
        acc = torch.randn(d, generator=gen, device=dev) * 40
        out = torch.empty_like(acc)
        row = {"size": size, "d": d}
        for sigma in (0.0, 0.025):
            want = fa.shard_finalize_plain(acc, WSUM, SEED_WORD, STEP, sigma)

            def call(name):
                rc = libs[name].shard_finalize_f32(
                    acc.data_ptr(), out.data_ptr(), d, WSUM,
                    fa.to_int32(SEED_WORD), STEP, sigma,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f"{name}: CUDA error {rc}")

            for name in names:
                call(name)
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int32),
                                   want.view(torch.int32))
                if not same and (not sigma
                                 or float((out - want).abs().max()) > 1e-6):
                    sys.exit(f"{name} differs from the plain version at "
                             f"{size}, sigma {sigma}")
            row[f"sigma={sigma}"] = in_turns(
                {name: (lambda name=name: call(name)) for name in names})
        row["div_by_device_scalar"] = kernel_us(
            lambda: torch.div(acc, wsum_t))
        row["div_by_float"] = kernel_us(lambda: torch.div(acc, WSUM))
        print(json.dumps(row), flush=True)


def run_k1(sources) -> None:
    libs = build(sources, bind_k1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sizes = cnn_leaf_sizes()
    keys = list(sizes)
    layout = fa.LeafLayout(keys, list(sizes.values()), range(len(keys)),
                           [True] * len(keys))
    xs = [torch.randn(N_CLIENTS, d, generator=gen, device=dev) * 0.05
          for d in sizes.values()]
    gs = [torch.randn(d, generator=gen, device=dev) for d in sizes.values()]
    scales = torch.rand(N_CLIENTS, generator=gen, device=dev)
    w = torch.rand(N_CLIENTS, generator=gen, device=dev) + 0.5
    ratios = (w / w.sum()).contiguous()
    s0, s1 = 123, -456

    def call(name, sigma):
        fa._lib_handle = libs[name]
        if hasattr(libs[name], "robust_agg_table_f32"):
            flat = fa.robust_agg_table(layout, xs, gs, scales, ratios, s0, s1,
                                       sigma)
            return layout.views(flat, [(d,) for d in layout.sizes])
        return [fa.robust_agg(x, g, scales, ratios, fa.leaf_seed(s0, li),
                              fa.leaf_seed(s1, li), sigma)
                for li, (x, g) in enumerate(zip(xs, gs))]

    for sigma in (0.0, SIGMA):
        want = [fa.robust_agg_plain(x, g, scales, ratios,
                                    fa.leaf_seed(s0, li),
                                    fa.leaf_seed(s1, li), sigma)
                for li, (x, g) in enumerate(zip(xs, gs))]
        for name in libs:
            err = max(float((a - b).abs().max())
                      for a, b in zip(call(name, sigma), want))
            if not err <= 1e-5:
                sys.exit(f"{name} differs from the plain version by {err} "
                         f"at sigma {sigma}")
        row = {"kernel": "k1", "sigma": sigma, "leaves": len(keys),
               "n": N_CLIENTS}
        row["round_us"] = in_turns(
            {name: (lambda name=name: call(name, sigma)) for name in libs})
        row["host_us"] = {name: host_us(lambda name=name: call(name, sigma))
                          for name in libs}
        print(json.dumps(row), flush=True)
    tree = {k: x for k, x in zip(keys, xs)}
    glob = {k: g for k, g in zip(keys, gs)}
    eager = lambda: fa.clip_scales_plain(tree, glob, CLIP_BOUND,
                                         lambda k: True)
    row = {"kernel": "k1 clip norm", "eager_us": kernel_us(eager),
           "eager_host_us": host_us(eager)}
    for name, lib in libs.items():
        if hasattr(lib, "clip_norm_f32"):
            fa._lib_handle = lib
            norm = lambda: fa.clip_norm(layout, xs, gs, CLIP_BOUND)
            diff = float((norm() - eager()).abs().max())
            row[name] = {"us": kernel_us(norm), "host_us": host_us(norm),
                         "max_abs_diff_from_eager": diff}
    print(json.dumps(row), flush=True)


def run_k3(sources) -> None:
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.secure import fused_mask as fm
    from fedml_tpu_torch.secure.secagg import ring_budget_scale
    libs = build(sources, bind_k3)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    sizes = cnn_leaf_sizes()
    keys = list(sizes)
    layout = fm.mask_layout(keys, list(sizes.values()))
    clip = 2.0**14
    scale = ring_budget_scale(GROUP, clip)
    key = prng.fold_in(prng.key(9), 3)
    xs = [torch.randn(GROUP, d, generator=gen, device=dev) * 3
          for d in sizes.values()]
    w = torch.rand(GROUP, generator=gen, device=dev) + 0.5
    w = (w / w.sum()).contiguous()

    def host_seeds():
        base = fm.pair_seeds(key, 0, GROUP, GROUP)
        return [torch.as_tensor(fm.leaf_seeds(base, li)).to(dev)
                for li in range(len(keys))]

    seeds = host_seeds()
    want = [fm.quantize_mask_plain(x, w, s, 0, scale, clip)
            for x, s in zip(xs, seeds)]

    def call(name):
        fm._lib_handle = libs[name]
        if hasattr(libs[name], "secagg_mask_table_i32"):
            buf = fm.quantize_mask_table(layout, xs, w, key, 0, GROUP, scale,
                                         clip)
            return layout.views(buf, [(d,) for d in layout.sizes])
        return [fm.quantize_mask(x, w, s, 0, scale, clip)
                for x, s in zip(xs, seeds)]

    for name in libs:
        if not all(torch.equal(a, b) for a, b in zip(call(name), want)):
            sys.exit(f"{name} differs from the plain version")
    row = {"kernel": "k3", "n": GROUP, "leaves": len(keys),
           "group_us": in_turns({name: (lambda name=name: call(name))
                                 for name in libs}),
           "host_us": {name: host_us(lambda name=name: call(name))
                       for name in libs},
           "host_pair_seeds_us": host_us(host_seeds, 5)}
    print(json.dumps(row), flush=True)


K4_SHAPE = (8, 2048, 8, 32)      # [B, T, H, d]: the bf16 LM's vmapped call
K4_BF16_TOL, K4_ML_TOL = 2.0 ** -7, 1e-5     # x max|ref|


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def run_k4(sources, mode: str) -> None:
    import torch.nn.functional as F
    from fedml_tpu_torch.models import flash_attention as fa
    libs = build(sources, fa.bind_k4)
    b, t, h, d = K4_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    po, pm, pl = fa.flash_fwd_bf16_plain(q, k, v)
    bwd = (q, k, v, do, pm, pl, (po.float() * do.float()).sum(-1))
    if mode == "k4f":
        kernel = lambda: fa.flash_fwd(q, k, v)
        want = {"o": (po, K4_BF16_TOL), "m": (pm, K4_ML_TOL),
                "l": (pl, K4_ML_TOL)}
    elif mode == "k4dkv":
        kernel = lambda: fa.flash_bwd_dkv(*bwd)
        want = dict(zip(("dk", "dv"), ((x, K4_BF16_TOL) for x in
                                       fa.flash_bwd_dkv_bf16_plain(*bwd))))
    else:
        kernel = lambda: (fa.flash_bwd_dq(*bwd),)
        want = {"dq": (fa.flash_bwd_dq_bf16_plain(*bwd), K4_BF16_TOL)}

    def call(name):
        fa._lib_handle = libs[name]
        return kernel()

    errs = {}
    for name in libs:
        print(f"checking {name}", file=sys.stderr, flush=True)
        got = call(name)
        torch.cuda.synchronize()
        errs[name] = {}
        for (key, (ref, tol)), x in zip(want.items(), got):
            err = float((x.float() - ref.float()).abs().max())
            errs[name][key] = err
            if not err <= tol * float(ref.float().abs().max()):
                sys.exit(f"{name}: {key} differs from the plain version by "
                         f"{err} (limit {tol} x max|ref|)")
    row = {"kernel": mode, "card": card(), "shape_BTHd": list(K4_SHAPE),
           "max_abs_err": errs,
           "device_us": in_turns({name: (lambda name=name: call(name))
                                  for name in libs}),
           "wrapper_host_us": {name: enqueue_us(lambda name=name: call(name))
                               for name in libs}}
    if mode == "k4f":
        row["sdpa_forward_device_us"] = kernel_us(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    print(json.dumps(row), flush=True)


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false; this needs a GPU")
    kernel = "k2"
    if argv and argv[0] in ("k1", "k2", "k3", "k4f", "k4dkv", "k4dq"):
        kernel, argv = argv[0], argv[1:]
    if len(argv) < 2:
        sys.exit(__doc__)
    if kernel in ("k4f", "k4dkv", "k4dq"):
        run_k4(argv, kernel)
        return
    {"k1": run_k1, "k2": run_k2, "k3": run_k3}[kernel](argv)


if __name__ == "__main__":
    main(sys.argv[1:])
