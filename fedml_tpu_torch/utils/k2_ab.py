"""Time builds of K2's source side by side on one card, in one process.

    python3 -m fedml_tpu_torch.utils.k2_ab A.cu B.cu [C.cu ...]

Run from the root of a checkout on a machine with a GPU.  Each source is a
version of ``csrc/shard_finalize.cu`` (for example the parent commit's,
from ``git show``, and the working tree's); each is built with the port's
``nvcc`` flags into its own library under ``build/kernels/ab/`` and loaded
with ctypes.  At
every size (the FEMNIST CNN's four shards at S=4, the whole model, and
sizes 3, 1 and 0 mod 4) and at sigma 0 and 0.025, every version must be
bit-equal to ``shard_finalize_plain`` at sigma 0 and within 1e-6 of it at
sigma > 0; then the versions are timed in turns (A B C, C B A, twice), each
turn the mean device time of 50 launches from ``torch.profiler``, and the
median of the four turns is kept.  ``torch.div`` by a device scalar (the
same function, bit for bit) and by a Python float (a multiply by the
reciprocal) are timed beside them.  Prints one JSON line per size, times
in microseconds.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from fedml_tpu_torch.core import fused_agg as fa
from fedml_tpu_torch.utils import cuda_build

SIZES = {"s0": 422_238, "s1": 422_944, "s2": 422_208, "s3": 422_656,
         "full": 1_690_046, "odd": 1_000_003, "one": 1_000_001,
         "four": 1_000_004}
WSUM, STEP, SEED_WORD = 123.0, 7, fa.shard_seed_word(0, 1)


def build(sources):
    """One library per source, keyed by the source as given, every nvcc
    started together."""
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
        handle = ctypes.CDLL(str(lib))
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.shard_finalize_f32.argtypes = [p, p, ctypes.c_longlong, f32,
                                              i32, i32, f32, p]
        handle.shard_finalize_f32.restype = i32
        libs[src] = handle
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


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false; this needs a GPU")
    if len(argv) < 2:
        sys.exit(__doc__)
    libs = build(argv)
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
            turns = {name: [] for name in names}
            for order in (names, names[::-1]) * 2:
                for name in order:
                    turns[name].append(kernel_us(lambda: call(name)))
            row[f"sigma={sigma}"] = {n: statistics.median(t)
                                     for n, t in turns.items()}
        row["div_by_device_scalar"] = kernel_us(
            lambda: torch.div(acc, wsum_t))
        row["div_by_float"] = kernel_us(lambda: torch.div(acc, WSUM))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
