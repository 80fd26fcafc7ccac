"""Fused quantize + pairwise mask: the secure aggregator's ``cuda`` backend.

Port of ``fedml_tpu/secure/pallas_mask.py``.  On the GPU each float leaf is
one launch of the hand-written CUDA kernel ``csrc/secagg_mask.cu`` (the
port of the Pallas ``_mask_kernel``) over every client row of a group:

    out[r] = quantize(w_r * x_r) + sum_{j != i} sign_ij * fmix(h ^ salt_ij)

in the uint32 ring, for client i = first_client + r, with sign +1 for
j > i and -1 for j < i, h the murmur hash of the element index and salt_ij
hashed from the pair's seed words.  Ring values are int32 tensors holding
the uint32 bits.

The pair seeds are JAX's: ``key_data(fold_in(fold_in(round_key, lo),
hi))`` for the sorted pair, from the port's threefry (``core/prng.py``),
and leaf ``li`` (JAX's leaf order) adds ``li * 31337`` to both words with
int32 wraparound, so same-shape leaves get distinct masks.  This is a
different mask stream than the ``torch`` backend's (threefry bits); every
client of a group must use the same backend for the masks to cancel.  The
stream is a murmur3 counter PRG keyed by the 64-bit pair secret, not a
cryptographic PRF: the JAX module's security note applies unchanged.

``quantize_mask_plain`` is the same arithmetic written step by step in
PyTorch.  The wrapper ``quantize_mask`` takes it only for tensors on the
CPU; a CUDA tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.murmur import M32, fmix, index_hash, seed_salts

LEAF_SEED_STRIDE = 31337
# the salts of one row live in the kernel's shared memory (4 bytes each);
# a grid's second dimension holds at most 65535 rows
MAX_CLIENTS = 8192
MAX_ROWS = 65535

# launches of each kernel since the last reset (the wrapper adds one per
# launch and nowhere else)
launch_counts = {"secagg_mask": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# pair seeds
# ---------------------------------------------------------------------------

def pair_seeds(round_key: prng.Key, first_client: int, rows: int,
               n_clients: int) -> np.ndarray:
    """int32 [rows, n_clients, 2]: row r, column j holds both words of the
    key of the pair (first_client + r, j), as JAX's ``derive_pair_seeds``
    gives them (the column j == i is derived too and never used)."""
    memo = {}
    out = np.empty((rows, n_clients, 2), np.int32)
    for r in range(rows):
        i = first_client + r
        for j in range(n_clients):
            pair = (min(i, j), max(i, j))
            if pair not in memo:
                memo[pair] = prng.key_words_int32(prng.fold_in(
                    prng.fold_in(round_key, pair[0]), pair[1]))
            out[r, j] = memo[pair]
    return out


def leaf_seeds(seeds: np.ndarray, leaf_id: int) -> np.ndarray:
    """The seeds of leaf ``leaf_id``: both words + leaf_id * 31337, int32
    wraparound."""
    shifted = seeds.astype(np.int64) + leaf_id * LEAF_SEED_STRIDE
    return ((shifted + 2**31) % 2**32 - 2**31).astype(np.int32)


# ---------------------------------------------------------------------------
# the plain version and the kernel wrapper
# ---------------------------------------------------------------------------

def to_ring(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 ring value with the same low 32 bits."""
    return (((v & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def quantize_mask_plain(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                        first_client: int, scale: float,
                        clip: float) -> torch.Tensor:
    """What the kernel computes, one client row and one partner at a time.
    x f32 [R, D], w f32 [R], seeds int32 [R, N, 2]; returns int32 [R, D]
    carrying the uint32 ring values."""
    rows, d = x.shape
    n_clients = seeds.shape[1]
    v = x.to(torch.float32) * w.to(torch.float32)[:, None]
    q = torch.round(torch.clamp(v, -clip, clip) * scale).to(torch.int32)
    idx_h = index_hash(d, x.device)
    s = seeds.to(torch.int64)
    out = []
    for r in range(rows):
        i = first_client + r
        acc = q[r].to(torch.int64) & M32
        for j in range(n_clients):
            if j == i:
                continue
            salt0, salt1 = seed_salts(s[r, j, 0], s[r, j, 1])
            bits = fmix(idx_h ^ (salt0 ^ salt1))
            acc = (acc + bits if j > i else acc - bits) & M32
        out.append(to_ring(acc))
    return torch.stack(out)


_lib_handle = None


def _lib():
    """The kernel library, built from source at first use."""
    global _lib_handle
    if _lib_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        lib = cuda_build.load("secagg_mask")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        f32 = ctypes.c_float
        lib.secagg_mask_i32.argtypes = [p, p, p, p, i64, i32, i32, i64, f32,
                                        f32, p]
        lib.secagg_mask_i32.restype = i32
        _lib_handle = lib
    return _lib_handle


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"quantize_mask: {msg}")


def quantize_mask(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                  first_client: int, scale: float,
                  clip: float) -> torch.Tensor:
    """One leaf's masked ring values for R client rows: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return quantize_mask_plain(x, w, seeds, first_client, scale, clip)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(w.device == seeds.device == x.device,
           "x, w and seeds must be on one device")
    _check(x.dtype == w.dtype == torch.float32, "x and w must be float32")
    _check(seeds.dtype == torch.int32, "seeds must be int32")
    _check(all(t.is_contiguous() for t in (x, w, seeds)),
           "tensors must be contiguous")
    rows, d = x.shape if x.dim() == 2 else (-1, -1)
    _check(x.dim() == 2 and w.shape == (rows,) and seeds.dim() == 3
           and seeds.shape[0] == rows and seeds.shape[2] == 2,
           f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, seeds "
           f"{tuple(seeds.shape)}")
    n_clients = seeds.shape[1]
    _check(rows <= MAX_ROWS and n_clients <= MAX_CLIENTS,
           f"{rows} rows of a {n_clients}-client group exceed the kernel's "
           f"limits ({MAX_ROWS} rows, {MAX_CLIENTS} clients)")
    _check(0 <= first_client and first_client + rows <= n_clients,
           f"rows {first_client}..{first_client + rows - 1} are not clients "
           f"of a {n_clients}-client group")
    out = torch.empty((rows, d), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().secagg_mask_i32(
            x.data_ptr(), w.data_ptr(), seeds.data_ptr(), out.data_ptr(),
            rows, n_clients, first_client, d, float(scale), float(clip),
            stream)
    if rc != 0:
        raise RuntimeError(f"secagg_mask kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["secagg_mask"] += 1
    return out
