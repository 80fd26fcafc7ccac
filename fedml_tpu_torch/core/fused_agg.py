"""The fused aggregation kernels: robust aggregation (K1) and the shard
finalize (K2).

**K1** — port of ``fedml_tpu/core/pallas_agg.py::make_fused_robust_aggregate``.
On the GPU each float leaf is one launch of the hand-written CUDA kernel
``csrc/robust_agg.cu`` (the port of the Pallas ``_agg_kernel``):

    out = sum_i r_i * (g + s_i * (x_i - g) + sigma * n_i)

with r_i the normalised sample weights, s_i the per-client norm-diff clip
scale and n_i the JAX package's murmur3 counter PRG + Box-Muller stream,
reproduced bit for bit in its uniforms.  The clip scales need the global
update norm across all leaves, so they are a torch reduction before the
launches (``_clip_scales``), as they were an XLA reduction in JAX.

**K2** — port of ``make_fused_shard_finalize``: one launch per shard of the
sharded streaming fold (``csrc/shard_finalize.cu``, the port of the Pallas
``_finalize_kernel``) computes ``acc / wsum (+ sigma * n)`` over the
shard's float pieces concatenated in slice-key order.

``robust_agg_plain`` and ``shard_finalize_plain`` are the same arithmetic
written step by step in PyTorch.  The wrappers take them only for tensors
on the CPU; a CUDA tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from fedml_tpu_torch.core.murmur import (M32, fmix, index_hash, mul32,
                                         seed_salts, to_int32)
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.core.robust import (_masked_global_norm,
                                         default_is_weight_param)

# The JAX kernel's VMEM budget caps the cohort; the CUDA kernel has no such
# limit, but both packages refuse the same cohorts.
MAX_CLIENTS = 512

# launches of each kernel since the last reset (the wrapper adds one per
# launch and nowhere else)
launch_counts = {"robust_agg": 0, "shard_finalize": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# the noise stream, in int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def _client_salt(s0: int, s1: int, i: int) -> int:
    return fmix(s0 ^ ((s1 + mul32(i, 0x85EBCA6B)) & M32))


def _uniforms(idx_h: torch.Tensor, salt: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two f32 uniforms per element: u1 in (0, 1), u2 in [0, 1)."""
    bits1 = fmix(idx_h ^ salt)
    bits2 = fmix(bits1 ^ 0x27D4EB2F)
    u1 = (bits1 >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)
    u2 = (bits2 >> 8).to(torch.float32) * (2.0 ** -24)
    return u1, u2


def _gaussian(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def noise_uniforms_plain(d: int, seed0: int, seed1: int, client: int,
                         device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    s0, s1 = seed_salts(seed0, seed1)
    return _uniforms(index_hash(d, device), _client_salt(s0, s1, client))


# ---------------------------------------------------------------------------
# the plain version and the kernel wrapper
# ---------------------------------------------------------------------------

def robust_agg_plain(x: torch.Tensor, g: torch.Tensor, scales: torch.Tensor,
                     ratios: torch.Tensor, seed0: int, seed1: int,
                     sigma: float) -> torch.Tensor:
    """What the kernel computes, one client at a time, in f32.  x [N, D],
    g [D], scales and ratios [N]; returns [D] in g's dtype."""
    n, d = x.shape
    gf = g.to(torch.float32)
    acc = torch.zeros(d, dtype=torch.float32, device=x.device)
    if sigma:
        idx_h = index_hash(d, x.device)
        s0, s1 = seed_salts(seed0, seed1)
    for i in range(n):
        term = gf + scales[i] * (x[i].to(torch.float32) - gf)
        if sigma:
            u1, u2 = _uniforms(idx_h, _client_salt(s0, s1, i))
            term = term + sigma * _gaussian(u1, u2)
        acc = acc + ratios[i] * term
    return acc.to(g.dtype)


_lib_handle = None


def _lib():
    """The kernel library, built from source at first use."""
    global _lib_handle
    if _lib_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        lib = cuda_build.load("robust_agg")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.robust_agg_f32.argtypes = [p, p, p, p, p, i64, i64, i32, i32,
                                       ctypes.c_float, p]
        lib.robust_agg_f32.restype = i32
        lib.noise_uniforms_f32.argtypes = [p, p, i64, i32, i32, i32, p]
        lib.noise_uniforms_f32.restype = i32
        _lib_handle = lib
    return _lib_handle


_k2_handle = None


def _k2_lib():
    """The shard-finalize kernel library, built from source at first use."""
    global _k2_handle
    if _k2_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        lib = cuda_build.load("shard_finalize")
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        lib.shard_finalize_f32.argtypes = [p, p, i64, f32, i32, i32, f32, p]
        lib.shard_finalize_f32.restype = i32
        lib.shard_uniforms_f32.argtypes = [p, p, i64, i32, i32, p]
        lib.shard_uniforms_f32.restype = i32
        _k2_handle = lib
    return _k2_handle


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"robust_agg: {msg}")


def robust_agg(x: torch.Tensor, g: torch.Tensor, scales: torch.Tensor,
               ratios: torch.Tensor, seed0: int, seed1: int,
               sigma: float) -> torch.Tensor:
    """One leaf of the fused aggregate: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return robust_agg_plain(x, g, scales, ratios, seed0, seed1, sigma)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(all(t.device == x.device for t in (g, scales, ratios)),
           "x, g, scales and ratios must be on one device")
    _check(all(t.dtype == torch.float32 for t in (x, g, scales, ratios)),
           "the kernel takes float32 tensors")
    _check(all(t.is_contiguous() for t in (x, g, scales, ratios)),
           "tensors must be contiguous")
    _check(x.dim() == 2 and g.shape == (x.shape[1],)
           and scales.shape == ratios.shape == (x.shape[0],),
           f"shapes x {tuple(x.shape)}, g {tuple(g.shape)}, scales "
           f"{tuple(scales.shape)}, ratios {tuple(ratios.shape)}")
    out = torch.empty_like(g)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().robust_agg_f32(
            x.data_ptr(), g.data_ptr(), scales.data_ptr(), ratios.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], to_int32(seed0),
            to_int32(seed1), float(sigma), stream)
    if rc != 0:
        raise RuntimeError(f"robust_agg kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["robust_agg"] += 1
    return out


def noise_uniforms(d: int, seed0: int, seed1: int, client: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's uniforms for one client (a probe of the noise stream;
    the aggregation path never calls it)."""
    device = torch.device(device)
    if device.type == "cpu":
        return noise_uniforms_plain(d, seed0, seed1, client)
    u1 = torch.empty(d, dtype=torch.float32, device=device)
    u2 = torch.empty_like(u1)
    with torch.cuda.device(device):
        rc = _lib().noise_uniforms_f32(
            u1.data_ptr(), u2.data_ptr(), d, to_int32(seed0),
            to_int32(seed1), client,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"noise_uniforms kernel launch failed: CUDA "
                           f"error {rc}")
    return u1, u2


# ---------------------------------------------------------------------------
# the aggregate the cohort engine calls
# ---------------------------------------------------------------------------

def _clip_scales(stacked: Tree, global_params: Tree, norm_bound: float,
                 is_weight) -> torch.Tensor:
    """Per-client min(1, bound / ||x_i - g||) over weight leaves, from the
    same norm helper as the unfused clip, so "which leaves count" cannot
    drift between the two backends."""
    diff = {k: stacked[k] - global_params[k] for k in stacked}
    norms = _masked_global_norm(diff, is_weight, batch_dims=1)
    return torch.clamp(norm_bound / torch.clamp(norms, min=1e-12), max=1.0)


def make_fused_robust_aggregate(norm_bound: Optional[float] = None,
                                noise_std: float = 0.0,
                                is_weight=default_is_weight_param):
    """Returns ``aggregate(stacked, weights, global_params, seed_words)``
    (``needs_global`` is set, so the cohort engine passes the round
    context).  ``norm_bound=None`` disables clipping, ``noise_std=0`` the
    noise.  ``seed_words`` are the round's two int32 seed words; leaf
    ``li`` (in JAX's leaf order) is keyed by ``seed + li * 31337`` with
    int32 wraparound."""

    def aggregate(stacked: Tree, weights: torch.Tensor, global_params: Tree,
                  seed_words: Sequence[int]) -> Tree:
        w = torch.as_tensor(weights, dtype=torch.float32)
        ratios = (w / torch.clamp(w.sum(), min=1e-12)).contiguous()
        n = int(w.shape[0])
        if n > MAX_CLIENTS:
            raise ValueError(
                f"cohort of {n} clients exceeds the fused kernel's limit "
                f"(max {MAX_CLIENTS}); use the torch defense backend for "
                f"cohorts this large")
        ones = torch.ones(n, dtype=torch.float32, device=w.device)
        if norm_bound is not None:
            scales = _clip_scales(stacked, global_params, norm_bound,
                                  is_weight).contiguous()
        else:
            scales = ones
        seed0, seed1 = (int(s) for s in seed_words)
        out = {}
        for li, k in enumerate(tree_keys(stacked)):
            x, g = stacked[k], global_params[k]
            if not x.dtype.is_floating_point:
                r = ratios.reshape((-1,) + (1,) * (x.dim() - 1))
                out[k] = (x.to(torch.float32) * r).sum(0).to(x.dtype)
                continue
            # the kernel works in f32 and the result takes g's dtype, as in
            # the Pallas kernel (a no-op for f32 leaves)
            agg = robust_agg(
                x.reshape(n, -1).to(torch.float32).contiguous(),
                g.reshape(-1).to(torch.float32).contiguous(),
                scales if is_weight(k) else ones, ratios,
                to_int32(seed0 + li * 31337), to_int32(seed1 + li * 31337),
                float(noise_std))
            out[k] = agg.reshape(g.shape).to(g.dtype)
        return out

    aggregate.needs_global = True
    return aggregate


# ---------------------------------------------------------------------------
# K2: the fused shard finalize of the sharded streaming fold
# ---------------------------------------------------------------------------

def shard_seed_word(seed: int, shard: int) -> int:
    """The shard's seed word, ``seed ^ (shard * 0x9E3779B9)`` mod 2^32, as
    an int32: decorrelates the shards' noise streams."""
    return to_int32((int(seed) & M32) ^ mul32(int(shard) & M32, 0x9E3779B9))


def _shard_salt(seed_word: int, step: int) -> int:
    s0, s1 = seed_salts(seed_word, step)
    return fmix(s0 ^ s1)


def shard_uniforms_plain(d: int, seed_word: int, step: int, device="cpu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _uniforms(index_hash(d, device), _shard_salt(seed_word, step))


def shard_finalize_plain(acc: torch.Tensor, wsum: float, seed_word: int,
                         step: int, sigma: float) -> torch.Tensor:
    """What K2 computes, step by step: ``acc / wsum`` (an IEEE division by
    a device scalar, never a multiply by its reciprocal) plus, at sigma >
    0, ``sigma * n[d]`` for the flat index d.  acc is [D] f32."""
    out = acc / torch.tensor(wsum, dtype=torch.float32, device=acc.device)
    if sigma:
        u1, u2 = shard_uniforms_plain(acc.shape[0], seed_word, step,
                                      acc.device)
        out = out + sigma * _gaussian(u1, u2)
    return out


def shard_finalize(acc: torch.Tensor, wsum: float, seed_word: int, step: int,
                   sigma: float) -> torch.Tensor:
    """One shard's finalize: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  ``wsum``, ``seed_word`` and ``step`` are
    host scalars.  Any contiguous 1-D view is taken: the kernel runs its
    float4 body (with a scalar tail) when ``acc`` starts on a 16-byte
    boundary, and one element a thread when it does not."""
    if acc.device.type == "cpu":
        return shard_finalize_plain(acc, wsum, seed_word, step, sigma)
    if acc.device.type != "cuda":
        raise ValueError(f"shard_finalize: unsupported device {acc.device}")
    if acc.dtype != torch.float32 or acc.dim() != 1 \
            or not acc.is_contiguous():
        raise ValueError(f"shard_finalize: the kernel takes a contiguous "
                         f"1-D float32 tensor, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    out = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        rc = _k2_lib().shard_finalize_f32(
            acc.data_ptr(), out.data_ptr(), acc.shape[0], float(wsum),
            to_int32(seed_word), to_int32(step), float(sigma),
            torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shard_finalize kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["shard_finalize"] += 1
    return out


def shard_uniforms(d: int, seed_word: int, step: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's noise uniforms (a probe of the stream; the finalize
    path never calls it)."""
    device = torch.device(device)
    if device.type == "cpu":
        return shard_uniforms_plain(d, seed_word, step)
    u1 = torch.empty(d, dtype=torch.float32, device=device)
    u2 = torch.empty_like(u1)
    with torch.cuda.device(device):
        rc = _k2_lib().shard_uniforms_f32(
            u1.data_ptr(), u2.data_ptr(), d, to_int32(seed_word),
            to_int32(step), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shard_uniforms kernel launch failed: CUDA "
                           f"error {rc}")
    return u1, u2


def make_fused_shard_finalize(*, noise_std: float = 0.0, seed: int = 0,
                              shard_salt: int = 0):
    """The fused finalize of one shard: ``fn(acc_pieces, wsum, ref_pieces,
    step) -> out_pieces``, the pieces keyed like the shard's wire slice
    body.  Float pieces are concatenated in sorted key order into one f32
    buffer and finalized by ONE `shard_finalize` launch; integer pieces
    (step counters) take the scalar epilogue ``(acc / wsum)`` cast back,
    never noised.  Each piece leaves in its reference dtype."""
    seed_word = shard_seed_word(seed, shard_salt)
    sigma = float(noise_std)

    def finalize(acc_pieces, wsum: float, ref_pieces, step: int):
        keys = sorted(acc_pieces)
        fkeys = [k for k in keys if ref_pieces[k].dtype.is_floating_point]
        out = {}
        for k in keys:
            if k not in fkeys:
                a = acc_pieces[k]
                w = torch.tensor(wsum, dtype=a.dtype, device=a.device)
                out[k] = (a / w).to(ref_pieces[k].dtype)
        if fkeys:
            flat = torch.cat([acc_pieces[k].to(torch.float32).reshape(-1)
                              for k in fkeys])
            flat_out = shard_finalize(flat, wsum, seed_word, int(step), sigma)
            off = 0
            for k in fkeys:
                n = acc_pieces[k].numel()
                out[k] = flat_out[off:off + n].reshape(
                    acc_pieces[k].shape).to(ref_pieces[k].dtype)
                off += n
        return out

    return finalize
