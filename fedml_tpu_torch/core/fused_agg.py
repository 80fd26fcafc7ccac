"""The fused aggregation kernels: robust aggregation (K1) and the shard
finalize (K2).

**K1** — port of ``fedml_tpu/core/pallas_agg.py::make_fused_robust_aggregate``.
On the GPU a round is two launches of the hand-written CUDA kernels of
``csrc/robust_agg.cu`` over a table of the model's float leaves
(``LeafLayout``): the clip-norm pass (``clip_norm``, the port of the
Pallas path's XLA phase 1), which leaves each client's clip scale on the
card, and the aggregate (``robust_agg_table``, the port of the Pallas
``_agg_kernel``):

    out = sum_i r_i * (g + s_i * (x_i - g) + sigma * n_i)

with r_i the normalised sample weights, s_i the per-client norm-diff clip
scale and n_i the JAX package's murmur3 counter PRG + Box-Muller stream,
reproduced bit for bit in its uniforms.  The result lands in one flat f32
buffer, and each leaf of the output tree is a view of it.  ``robust_agg``
is the same kernel over one leaf.

**K2** — port of ``make_fused_shard_finalize``: one launch per shard of the
sharded streaming fold (``csrc/shard_finalize.cu``, the port of the Pallas
``_finalize_kernel``) computes ``acc / wsum (+ sigma * n)`` over the
shard's float pieces concatenated in slice-key order.

``robust_agg_plain``, ``clip_scales_plain`` and ``shard_finalize_plain``
are the same arithmetic written step by step in PyTorch.  The wrappers take
them only for tensors on the CPU; a CUDA tensor gets the kernel or an
exception.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
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
launch_counts = {"robust_agg": 0, "clip_norm": 0, "shard_finalize": 0}


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


def leaf_seed(seed: int, leaf_id: int) -> int:
    """Leaf ``leaf_id``'s seed word: ``seed + leaf_id * 31337``, int32
    wraparound."""
    return to_int32(int(seed) + leaf_id * 31337)


# ---------------------------------------------------------------------------
# the plain versions
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


def clip_scales_plain(stacked: Tree, global_params: Tree, norm_bound: float,
                      is_weight) -> torch.Tensor:
    """Per-client min(1, bound / ||x_i - g||) over weight leaves, from the
    same norm helper as the unfused clip, so "which leaves count" cannot
    drift between the two backends: what ``clip_norm`` computes."""
    diff = {k: stacked[k] - global_params[k] for k in stacked}
    norms = _masked_global_norm(diff, is_weight, batch_dims=1)
    return torch.clamp(norm_bound / torch.clamp(norms, min=1e-12), max=1.0)


# ---------------------------------------------------------------------------
# the leaf table
# ---------------------------------------------------------------------------

# the columns of a table row (robust_agg.cu's Col)
X, G, OUT, D, SEED0, SEED1, CLIPPED = range(7)


class LeafLayout:
    """The table of a tree structure's float leaves, built once: each
    leaf's element count and its offset in the flat output (a multiple of
    4 floats, so every leaf's output starts 16-byte aligned).  Leaves of
    no element get no row; ``norm_rows`` are the weight leaves' rows.  The
    grid (which blocks take which leaf, and launches of up to 64 leaves)
    is decided by the kernels' entry points (``csrc/leaf_table.cuh``).
    K3's launch (``secure/fused_mask.py``) uses the same offsets, as
    columns."""

    def __init__(self, keys: Sequence[str], sizes: Sequence[int],
                 leaf_ids: Sequence[int], weight: Sequence[bool]):
        self.keys, self.sizes = list(keys), [int(d) for d in sizes]
        self.leaf_ids, self.weight = list(leaf_ids), [bool(w) for w in weight]
        self.offsets, off = [], 0
        for d in self.sizes:
            self.offsets.append(off)
            off += -(-d // 4) * 4
        self.out_numel = off
        self.rows = [j for j, d in enumerate(self.sizes) if d]
        self.norm_rows = [j for j in self.rows if self.weight[j]]

    def agg_table(self, xs, gs, out: torch.Tensor, seed0: int,
                  seed1: int) -> np.ndarray:
        """This call's aggregate rows: each leaf's pointers, D, seed words
        (``leaf_seed``) and clipped flag."""
        return np.array([
            [xs[j].data_ptr(), gs[j].data_ptr(),
             out.data_ptr() + 4 * self.offsets[j], self.sizes[j],
             leaf_seed(seed0, self.leaf_ids[j]),
             leaf_seed(seed1, self.leaf_ids[j]), self.weight[j]]
            for j in self.rows], np.int64).reshape(-1, 7)

    def norm_table(self, xs, gs) -> np.ndarray:
        """This call's norm-pass rows (weight leaves; out and seeds
        unused)."""
        return np.array([
            [xs[j].data_ptr(), gs[j].data_ptr(), 0, self.sizes[j], 0, 0, 1]
            for j in self.norm_rows], np.int64).reshape(-1, 7)

    def views(self, buf: torch.Tensor, shapes) -> List[torch.Tensor]:
        """Each leaf's slice of the last axis of ``buf`` (the flat output,
        or a [R, C] buffer), viewed to its shape (leading axes kept)."""
        lead = tuple(buf.shape[:-1])
        return [buf[..., o:o + d].view(lead + tuple(s)) for o, d, s in
                zip(self.offsets, self.sizes, shapes)]


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle = None


def bind_k1(lib):
    """Declare K1's C entry points on a ctypes handle of robust_agg.cu."""
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.robust_agg_f32.argtypes = [p, p, p, p, p, i64, i64, i32, i32, f32, p]
    lib.robust_agg_f32.restype = i32
    lib.robust_agg_table_f32.argtypes = [p, i32, p, p, i64, f32, p, p]
    lib.robust_agg_table_f32.restype = i32
    lib.clip_norm_blocks.argtypes = [p, i32]
    lib.clip_norm_blocks.restype = i64
    lib.clip_norm_f32.argtypes = [p, i32, p, p, p, i64, f32, p, p]
    lib.clip_norm_f32.restype = i32
    lib.noise_probe_f32.argtypes = [p, p, p, i64, i32, i32, i32, p]
    lib.noise_probe_f32.restype = i32
    return lib


def _lib():
    """The kernel library, built from source at first use."""
    global _lib_handle
    if _lib_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        _lib_handle = bind_k1(cuda_build.load("robust_agg"))
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


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def robust_agg(x: torch.Tensor, g: torch.Tensor, scales: torch.Tensor,
               ratios: torch.Tensor, seed0: int, seed1: int,
               sigma: float) -> torch.Tensor:
    """One leaf of the fused aggregate: the CUDA kernel (a one-leaf table)
    for CUDA tensors, the plain version for CPU tensors."""
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
    _check(x.shape[0] <= MAX_CLIENTS,
           f"{x.shape[0]} clients exceed the kernel's {MAX_CLIENTS}")
    out = torch.empty_like(g)
    with torch.cuda.device(x.device):
        rc = _lib().robust_agg_f32(
            x.data_ptr(), g.data_ptr(), scales.data_ptr(), ratios.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], to_int32(seed0),
            to_int32(seed1), float(sigma), _stream(x.device))
    _raise_on(rc, "robust_agg")
    launch_counts["robust_agg"] += 1
    return out


def _check_table(layout: LeafLayout, xs, gs, n: int) -> torch.device:
    """The leaves' device, after checking that every leaf is a contiguous
    f32 tensor of its shape on one CUDA device."""
    dev = xs[0].device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(n <= MAX_CLIENTS, f"{n} clients exceed the kernel's {MAX_CLIENTS}")
    for j, d in enumerate(layout.sizes):
        x, g = xs[j], gs[j]
        _check(x.device == dev and g.device == dev,
               "every leaf must be on one device")
        _check(x.dtype == g.dtype == torch.float32,
               "the kernel takes float32 leaves")
        _check(x.is_contiguous() and g.is_contiguous(),
               "leaves must be contiguous")
        _check(x.shape == (n, d) and g.shape == (d,),
               f"leaf {layout.keys[j]}: x {tuple(x.shape)}, g "
               f"{tuple(g.shape)} against [{n}, {d}]")
    return dev


def clip_norm(layout: LeafLayout, xs, gs, norm_bound: float) -> torch.Tensor:
    """The clip scales [N] of the cohort over the layout's weight leaves
    (xs[j] [N, D_j], gs[j] [D_j]): the norm kernel for CUDA leaves, left
    on the card; the plain version for CPU leaves.  One launch per 64
    weight leaves; the pass's last block writes the scales."""
    n = int(xs[0].shape[0])
    if not layout.norm_rows:                 # no weight leaf: no clip
        return torch.ones(n, dtype=torch.float32, device=xs[0].device)
    if xs[0].device.type == "cpu":
        keys = [layout.keys[j] for j in layout.norm_rows]
        return clip_scales_plain(
            {k: xs[j] for k, j in zip(keys, layout.norm_rows)},
            {k: gs[j] for k, j in zip(keys, layout.norm_rows)},
            norm_bound, lambda k: True)
    dev = _check_table(layout, xs, gs, n)
    lib = _lib()
    table = layout.norm_table(xs, gs)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev)   # the ticket
    partial = torch.empty(
        n * lib.clip_norm_blocks(table.ctypes.data, len(table)),
        dtype=torch.float32, device=dev)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.clip_norm_f32(
            table.ctypes.data, len(table), partial.data_ptr(),
            scales.data_ptr(), done.data_ptr(), n, float(norm_bound),
            _stream(dev), ctypes.byref(launches))
    _raise_on(rc, "clip_norm")
    launch_counts["clip_norm"] += launches.value
    return scales


def robust_agg_table(layout: LeafLayout, xs, gs,
                     scales: Optional[torch.Tensor], ratios: torch.Tensor,
                     seed0: int, seed1: int, sigma: float) -> torch.Tensor:
    """Every leaf of the layout in one launch (per 64 leaves): the flat f32
    output, leaf j at ``layout.offsets[j]``.  ``scales`` [N] clips the
    weight leaves (None: no clip); leaf j's seed words are ``seed +
    layout.leaf_ids[j] * 31337``.  The CUDA kernel for CUDA leaves (the
    scales and ratios on their device), the plain version leaf by leaf for
    CPU leaves."""
    n = int(ratios.shape[0])
    if xs[0].device.type == "cpu":
        flat = torch.zeros(layout.out_numel, dtype=torch.float32)
        ones = torch.ones(n, dtype=torch.float32)
        for j, d in enumerate(layout.sizes):
            s = scales if scales is not None and layout.weight[j] else ones
            li = layout.leaf_ids[j]
            flat[layout.offsets[j]:layout.offsets[j] + d] = robust_agg_plain(
                xs[j], gs[j], s, ratios, leaf_seed(seed0, li),
                leaf_seed(seed1, li), sigma)
        return flat
    dev = _check_table(layout, xs, gs, n)
    for t in (scales, ratios):
        _check(t is None or (t.device == dev and t.dtype == torch.float32
                             and t.shape == (n,) and t.is_contiguous()),
               "scales and ratios must be contiguous float32 [N] on the "
               "leaves' device")
    flat = torch.empty(layout.out_numel, dtype=torch.float32, device=dev)
    table = layout.agg_table(xs, gs, flat, seed0, seed1)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _lib().robust_agg_table_f32(
            table.ctypes.data, len(table),
            None if scales is None else scales.data_ptr(), ratios.data_ptr(),
            n, float(sigma), _stream(dev), ctypes.byref(launches))
    _raise_on(rc, "robust_agg")
    launch_counts["robust_agg"] += launches.value
    return flat


def noise_probe(d: int, seed0: int, seed1: int, client: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's uniforms u1, u2 and Gaussians for one client (a probe
    of the noise stream; the aggregation path never calls it).  On the CPU:
    the plain uniforms and the precise Gaussians."""
    device = torch.device(device)
    if device.type == "cpu":
        u1, u2 = noise_uniforms_plain(d, seed0, seed1, client)
        return u1, u2, _gaussian(u1, u2)
    u1, u2, gauss = (torch.empty(d, dtype=torch.float32, device=device)
                     for _ in range(3))
    with torch.cuda.device(device):
        rc = _lib().noise_probe_f32(
            u1.data_ptr(), u2.data_ptr(), gauss.data_ptr(), d,
            to_int32(seed0), to_int32(seed1), client, _stream(device))
    _raise_on(rc, "noise_probe")
    return u1, u2, gauss


def noise_uniforms(d: int, seed0: int, seed1: int, client: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's uniforms for one client."""
    return noise_probe(d, seed0, seed1, client, device)[:2]


# ---------------------------------------------------------------------------
# the aggregate the cohort engine calls
# ---------------------------------------------------------------------------

def make_fused_robust_aggregate(norm_bound: Optional[float] = None,
                                noise_std: float = 0.0,
                                is_weight=default_is_weight_param):
    """Returns ``aggregate(stacked, weights, global_params, seed_words)``
    (``needs_global`` is set, so the cohort engine passes the round
    context).  ``norm_bound=None`` disables clipping, ``noise_std=0`` the
    noise.  ``seed_words`` are the round's two int32 seed words; leaf
    ``li`` (in JAX's leaf order) is keyed by ``seed + li * 31337`` with
    int32 wraparound.  Float leaves go through one ``clip_norm`` and one
    ``robust_agg_table`` call over the tree's ``LeafLayout`` (built once
    per tree structure); each output leaf is a view of the flat result.
    Integer leaves (step counters) take the weighted mean, cast back."""
    layouts = {}

    def layout_of(stacked: Tree, keys) -> LeafLayout:
        sig = tuple((k, tuple(stacked[k].shape), stacked[k].dtype)
                    for k in keys)
        layout = layouts.get(sig)
        if layout is None:
            fl = [(li, k) for li, k in enumerate(keys)
                  if stacked[k].dtype.is_floating_point]
            if norm_bound is not None and any(
                    is_weight(k) and not stacked[k].dtype.is_floating_point
                    for k in keys):
                raise ValueError("the clip norm runs over float leaves; an "
                                 "integer leaf is selected by is_weight")
            layout = layouts[sig] = LeafLayout(
                [k for _, k in fl], [stacked[k][0].numel() for _, k in fl],
                [li for li, _ in fl], [is_weight(k) for _, k in fl])
        return layout

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
        seed0, seed1 = (int(s) for s in seed_words)
        keys = tree_keys(stacked)
        layout = layout_of(stacked, keys)
        # the kernels work in f32 and the result takes g's dtype, as in the
        # Pallas kernel (a no-op for f32 leaves)
        xs = [stacked[k].reshape(n, -1).to(torch.float32).contiguous()
              for k in layout.keys]
        gs = [global_params[k].reshape(-1).to(torch.float32).contiguous()
              for k in layout.keys]
        out = {}
        if layout.keys:
            scales = (clip_norm(layout, xs, gs, norm_bound)
                      if norm_bound is not None else None)
            flat = robust_agg_table(layout, xs, gs, scales, ratios, seed0,
                                    seed1, float(noise_std))
            views = layout.views(flat, [global_params[k].shape
                                        for k in layout.keys])
            out = {k: v.to(global_params[k].dtype)
                   for k, v in zip(layout.keys, views)}
        for k in keys:
            x = stacked[k]
            if k not in out:
                r = ratios.reshape((-1,) + (1,) * (x.dim() - 1))
                out[k] = (x.to(torch.float32) * r).sum(0).to(x.dtype)
        return {k: out[k] for k in keys}

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
