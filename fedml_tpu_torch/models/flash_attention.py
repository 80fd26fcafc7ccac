"""Causal flash attention (K4): the port of the transformer's Pallas path.

``fedml_tpu/models/transformer.py::_pallas_flash`` calls JAX's Pallas
library flash attention (``jax.experimental.pallas.ops.tpu
.flash_attention``, causal, ``sm_scale = 1/sqrt(d)``): a ``custom_vjp``
over three kernels, the forward (which also keeps the row max m and the
normaliser l) and the backward's dK/dV and dQ kernels, with
``di = sum(o * dO)`` computed between them.  Here the three kernels are
the hand-written CUDA kernels of ``csrc/flash_attention.cu``:

* ``flash_fwd(q, k, v) -> (o, m, l)``;
* ``flash_bwd_dkv(q, k, v, do, m, l, di) -> (dk, dv)``;
* ``flash_bwd_dq(q, k, v, do, m, l, di) -> dq``,

over ``[B, H, T, d]`` f32 or bf16 tensors, m, l and di ``[B, H, T]`` f32.
Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``flash_fwd_plain``, ``flash_bwd_dkv_plain``,
``flash_bwd_dq_plain``, beside it) for CPU tensors; it never falls back
from one to the other.

bf16 (``--compute_dtype bfloat16``): the library multiplies bf16 x bf16
into f32 and rounds to bf16 at four points (P before P V; P^T before
P^T dO; dS before dS^T Q and before dS K), keeping m, l, di and every sum
f32 and writing o, dq, dk, dv in bf16.  bf16 inputs dispatch to the
``_bf16`` kernels, whose plain versions (``flash_fwd_bf16_plain`` ...)
upcast (exactly), compute in f32 and round at the same four points and
on output.  Their launches count apart (``flash_fwd_bf16`` ...).
The plain backward halves take m, l and di as the kernels do, so each
kernel can be held against its own plain version.

``flash_attention(q, k, v)`` is the model's entry: ``[B, T, H, d]`` in and
out, as ``_pallas_flash`` takes it, differentiable through an
``autograd.Function`` whose backward is the two backward kernels.  Local
training maps it over the client axis with ``torch.func.vmap`` and takes
gradients with ``torch.func.grad``; the Function's ``vmap`` rules fold the
mapped axis into B (attention is independent per (b, h)), so a kernel sees
plain tensors and launches once for the whole cohort.

The library's shape contract is kept with its own words: its default
128-wide blocks refuse a sequence shorter than 128 or not divisible by
128, on any device.  The kernels take f32 or bf16 and head sizes 16, 32
and 64.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

# the library's default block sizes (BlockSizes.get_default)
BLOCK = 128
# the head sizes the CUDA kernels are built for
KERNEL_HEAD_DIMS = (16, 32, 64)
# the library's mask value, DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# the kernels by input dtype
KERNELS = {torch.float32: ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
           torch.bfloat16: ("flash_fwd_bf16", "flash_bwd_dkv_bf16",
                            "flash_bwd_dq_bf16")}
# launches of each kernel since the last reset (the wrapper adds one per
# launch and nowhere else)
launch_counts = {name: 0 for names in KERNELS.values() for name in names}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def check_seq_len(t: int) -> None:
    """The library's ``_verify_block`` checks on its default blocks for
    self-attention (query and key lengths equal), in its order and words:
    ``block_q`` must not exceed the query length, and ``block_k_major``
    must divide the key length."""
    if BLOCK > t:
        raise ValueError(f"block_q={BLOCK} should be smaller or equal to "
                         f"q_seq_len={t}")
    if t % BLOCK:
        raise ValueError(f"kv_seq_len={t} should be divisible by "
                         f"block_k_major={BLOCK}")


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _masked_scores(q, k):
    """mask(q k^T * scale), [B, H, T, T], masked entries MASK_VALUE."""
    t = q.shape[-2]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.where(causal, s, MASK_VALUE)


def flash_fwd_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """What K4f computes, as dense PyTorch: o [B, H, T, d], the row max m
    and the normaliser l = sum exp(s - m), both [B, H, T]."""
    s = _masked_scores(q, k)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    return torch.matmul(p, v) / l[..., None], m, l


def _probs_and_ds(q, k, v, do, m, l, di):
    """The backward's recomputed p = exp(s - m) * (1 / l) and
    ds = p * (dO v^T - di) * scale, both [B, H, T, T]."""
    p = torch.exp(_masked_scores(q, k) - m[..., None]) * (1.0 / l)[..., None]
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - di[..., None])
    return p, ds * (1.0 / math.sqrt(q.shape[-1]))


def flash_bwd_dkv_plain(q, k, v, do, m, l, di
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K4dkv computes: dk = ds^T q and dv = p^T dO."""
    p, ds = _probs_and_ds(q, k, v, do, m, l, di)
    return (torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), do))


def flash_bwd_dq_plain(q, k, v, do, m, l, di) -> torch.Tensor:
    """What K4dq computes: dq = ds k."""
    _, ds = _probs_and_ds(q, k, v, do, m, l, di)
    return torch.matmul(ds, k)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def flash_fwd_bf16_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """What the bf16 K4f computes: the f32 forward on the upcast inputs
    with P rounded to bf16 before P V; o in bf16, m and l f32."""
    q, k, v = _f32(q, k, v)
    s = _masked_scores(q, k)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(_round_bf16(p), v) / l[..., None]
    return o.to(torch.bfloat16), m, l


def flash_bwd_dkv_bf16_plain(q, k, v, do, m, l, di
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the bf16 K4dkv computes: dk = bf16(ds)^T q and dv = bf16(p)^T
    dO in f32, written in bf16."""
    q, k, v, do = _f32(q, k, v, do)
    p, ds = _probs_and_ds(q, k, v, do, m, l, di)
    dk = torch.matmul(_round_bf16(ds).transpose(-1, -2), q)
    dv = torch.matmul(_round_bf16(p).transpose(-1, -2), do)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def flash_bwd_dq_bf16_plain(q, k, v, do, m, l, di) -> torch.Tensor:
    """What the bf16 K4dq computes: dq = bf16(ds) k in f32, written in
    bf16."""
    q, k, v, do = _f32(q, k, v, do)
    _, ds = _probs_and_ds(q, k, v, do, m, l, di)
    return torch.matmul(_round_bf16(ds), k).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle = None


def bind_k4(lib):
    """Declare the six entry points of a ``flash_attention`` library
    (loaded with ctypes); returns the handle."""
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.flash_fwd_f32.argtypes = [p, p, p, p, p, p, i64, i32, i32, f32, p]
    lib.flash_bwd_dkv_f32.argtypes = [p, p, p, p, p, p, p, p, p, i64, i32,
                                      i32, f32, p]
    lib.flash_bwd_dq_f32.argtypes = [p, p, p, p, p, p, p, p, i64, i32, i32,
                                     f32, p]
    lib.flash_fwd_bf16.argtypes = lib.flash_fwd_f32.argtypes
    lib.flash_bwd_dkv_bf16.argtypes = lib.flash_bwd_dkv_f32.argtypes
    lib.flash_bwd_dq_bf16.argtypes = lib.flash_bwd_dq_f32.argtypes
    for fn in (lib.flash_fwd_f32, lib.flash_bwd_dkv_f32, lib.flash_bwd_dq_f32,
               lib.flash_fwd_bf16, lib.flash_bwd_dkv_bf16,
               lib.flash_bwd_dq_bf16):
        fn.restype = i32
    return lib


def _lib():
    """The kernel library, built from source at first use."""
    global _lib_handle
    if _lib_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        _lib_handle = bind_k4(cuda_build.load("flash_attention"))
    return _lib_handle


def check_dtypes(name: str, q: torch.Tensor, rows, vecs) -> None:
    """Raise unless q and ``rows`` are all f32 or all bf16 and ``vecs``
    (m, l, di) f32: the kernels take no mixed set."""
    if q.dtype not in KERNELS:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16 q, "
                         f"got {q.dtype}")
    got = [x.dtype for x in (q, *rows)] + [x.dtype for x in vecs]
    want = [q.dtype] * (1 + len(rows)) + [torch.float32] * len(vecs)
    if got != want:
        raise ValueError(f"{name}: mixed dtypes {got}; the kernel takes "
                         f"{want}")


def _check_cuda(name: str, q: torch.Tensor, rows, vecs) -> None:
    """Raise unless the kernel takes these tensors: contiguous on one CUDA
    device, q and ``rows`` (shaped like q, [B, H, T, d]) all f32 or all
    bf16, ``vecs`` (shaped like q without d) f32."""
    def bad(msg):
        raise ValueError(f"{name}: {msg}")

    if q.device.type != "cuda":
        bad(f"unsupported device {q.device}")
    if q.dim() != 4:
        bad(f"expected [B, H, T, d] tensors, got {tuple(q.shape)}")
    b, h, t, d = q.shape
    check_dtypes(name, q, rows, vecs)
    for x in (q, *rows, *vecs):
        if x.device != q.device or not x.is_contiguous():
            bad(f"the kernel takes contiguous tensors on one device, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if any(x.shape != q.shape for x in rows) \
            or any(x.shape != q.shape[:3] for x in vecs):
        bad(f"shapes {[tuple(x.shape) for x in (q, *rows, *vecs)]}")
    # the kernels copy and load 16 bytes at a time
    if any(x.data_ptr() % 16 for x in (q, *rows, *vecs)):
        bad("every tensor must start on a 16-byte boundary")
    if d not in KERNEL_HEAD_DIMS:
        bad(f"head size {d}: the kernel is built for {KERNEL_HEAD_DIMS}")
    if t % BLOCK:
        bad(f"sequence length {t} is not a multiple of {BLOCK}")
    # the grid is (B * H, T / 64): y holds at most 65535 tiles
    if not 1 <= b * h <= 2**31 - 1 or t // 64 > 65535:
        bad(f"B * H = {b * h}, T = {t} is outside the kernel's grid")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name] += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _is_bf16(q: torch.Tensor) -> bool:
    return q.dtype == torch.bfloat16


def flash_fwd(q, k, v):
    """K4f: (o, m, l) for [B, H, T, d] q, k, v; the CUDA kernel of q's
    dtype for CUDA tensors, its plain version for CPU tensors."""
    if q.device.type == "cpu":
        return (flash_fwd_bf16_plain if _is_bf16(q)
                else flash_fwd_plain)(q, k, v)
    name = "flash_fwd_bf16" if _is_bf16(q) else "flash_fwd"
    _check_cuda(name, q, (k, v), ())
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = _lib().flash_fwd_bf16 if _is_bf16(q) else _lib().flash_fwd_f32
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), b * h, t, d, 1.0 / math.sqrt(d),
                _stream(q))
    _launched(name, rc)
    return o, m, l


def flash_bwd_dkv(q, k, v, do, m, l, di):
    """K4dkv: (dk, dv); the CUDA kernel of q's dtype for CUDA tensors, its
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return (flash_bwd_dkv_bf16_plain if _is_bf16(q)
                else flash_bwd_dkv_plain)(q, k, v, do, m, l, di)
    name = "flash_bwd_dkv_bf16" if _is_bf16(q) else "flash_bwd_dkv"
    _check_cuda(name, q, (k, v, do), (m, l, di))
    b, h, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _lib().flash_bwd_dkv_bf16 if _is_bf16(q) \
        else _lib().flash_bwd_dkv_f32
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                m.data_ptr(), l.data_ptr(), di.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b * h, t, d, 1.0 / math.sqrt(d), _stream(q))
    _launched(name, rc)
    return dk, dv


def flash_bwd_dq(q, k, v, do, m, l, di):
    """K4dq: dq; the CUDA kernel of q's dtype for CUDA tensors, its plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return (flash_bwd_dq_bf16_plain if _is_bf16(q)
                else flash_bwd_dq_plain)(q, k, v, do, m, l, di)
    name = "flash_bwd_dq_bf16" if _is_bf16(q) else "flash_bwd_dq"
    _check_cuda(name, q, (k, v, do), (m, l, di))
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    fn = _lib().flash_bwd_dq_bf16 if _is_bf16(q) \
        else _lib().flash_bwd_dq_f32
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(),
                b * h, t, d, 1.0 / math.sqrt(d), _stream(q))
    _launched(name, rc)
    return dq


# ---------------------------------------------------------------------------
# autograd and vmap
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """The vmapped axis (or a broadcast of an unmapped input) folded into
    the leading B axis, contiguous."""
    x = x.expand((n,) + tuple(x.shape)) if dim is None else x.movedim(dim, 0)
    return x.reshape((n * x.shape[1],) + tuple(x.shape[2:])).contiguous()


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _folded_call(fn, info, in_dims, args):
    n = info.batch_size
    out = fn(*(_fold(a, d, n) for a, d in zip(args, in_dims)))
    if isinstance(out, torch.Tensor):
        return _unfold(out, n), 0
    return tuple(_unfold(o, n) for o in out), (0,) * len(out)


class _NoDoubleBackward:
    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention has no higher-order gradient (the library "
            "refuses it too)")


class _BwdDkv(_NoDoubleBackward, torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, do, m, l, di):
        return flash_bwd_dkv(q, k, v, do, m, l, di)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _folded_call(_BwdDkv.apply, info, in_dims, args)


class _BwdDq(_NoDoubleBackward, torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, do, m, l, di):
        return flash_bwd_dq(q, k, v, do, m, l, di)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _folded_call(_BwdDq.apply, info, in_dims, args)


class _FlashAttention(torch.autograd.Function):
    """(o, m, l) = K4f(q, k, v) over contiguous [B, H, T, d]; the backward
    is di = sum(o * dO) in torch (in f32, as the library takes it from
    bf16 o and dO), then K4dkv and K4dq."""

    @staticmethod
    def forward(q, k, v):
        return flash_fwd(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        o, m, l = output
        ctx.save_for_backward(*inputs, o, m, l)
        ctx.mark_non_differentiable(m, l)

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        di = (o.to(torch.float32) * do.to(torch.float32)).sum(dim=-1)
        dk, dv = _BwdDkv.apply(q, k, v, do, m, l, di)
        dq = _BwdDq.apply(q, k, v, do, m, l, di)
        return dq, dk, dv

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        return _folded_call(_FlashAttention.apply, info, in_dims, (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal attention with ``sm_scale = 1/sqrt(d)`` over ``[B, T, H, d]``
    q, k, v (``_pallas_flash``'s layout); returns ``[B, T, H, d]``.
    Refuses the shapes the library refuses."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: q, k, v shapes differ: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    check_seq_len(q.shape[1])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    o, _, _ = _FlashAttention.apply(qt, kt, vt)
    return o.transpose(1, 2)
