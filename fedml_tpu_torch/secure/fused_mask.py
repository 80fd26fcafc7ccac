"""Fused quantize + pairwise mask: the secure aggregator's ``cuda`` backend.

Port of ``fedml_tpu/secure/pallas_mask.py``.  On the GPU a group's masking
is one launch of the hand-written CUDA kernel ``csrc/secagg_mask.cu`` (the
port of the Pallas ``_mask_kernel`` and of ``derive_pair_seeds``) over a
table of the group's leaves and every client row:

    out[r] = quantize(w_r * x_r) + sum_{j != i} sign_ij * fmix(h ^ salt_ij)

in the uint32 ring, for client i = first_client + r, with sign +1 for
j > i and -1 for j < i, h the murmur hash of the element index and salt_ij
hashed from the pair's key words.  Ring values are int32 tensors holding
the uint32 bits; the launch writes one [R, C] buffer in which each leaf is
a column slice.  ``quantize_mask`` is the same kernel over one leaf, with
the pair seeds given.

The pair keys are JAX's: ``key_data(fold_in(fold_in(round_key, lo),
hi))`` for the sorted pair, and leaf ``li`` (JAX's leaf order) adds ``li *
31337`` to both words with int32 wraparound, so same-shape leaves get
distinct masks.  The kernel derives them from the round key's two words in
the launch; ``pair_seeds`` and ``leaf_seeds`` are the same derivation on
the host, from the port's threefry (``core/prng.py``).  This is a different
mask stream than the ``torch`` backend's (threefry bits); every client of a
group must use the same backend for the masks to cancel.  The stream is a
murmur3 counter PRG keyed by the 64-bit pair secret, not a cryptographic
PRF: the JAX module's security note applies unchanged.

``quantize_mask_plain`` is the same arithmetic written step by step in
PyTorch, one row and one partner at a time; ``quantize_mask_pairs_plain``
renders the kernel's each-pair-once accumulation.  The wrappers take the
plain versions only for tensors on the CPU; a CUDA tensor gets the kernel
or an exception.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.fused_agg import LeafLayout
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


def salts_of_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """The salts ``fmix(s0) ^ fmix(s1 ^ 0x5BD1E995)`` of int32 seed words
    [..., 2], as int64 tensors of uint32 values [...]."""
    s = seeds.to(torch.int64)
    salt0, salt1 = seed_salts(s[..., 0], s[..., 1])
    return salt0 ^ salt1


def pair_salts_plain(round_key: prng.Key, n_clients: int, leaf_id: int,
                     device="cpu") -> torch.Tensor:
    """The salt of every pair (i, j) of an n-client group for leaf
    ``leaf_id`` (int64 [n, n] of uint32 values, 0 on the diagonal), from
    ``pair_seeds`` and ``leaf_seeds`` on the host: what the kernel derives
    from the round key in its launch."""
    seeds = leaf_seeds(pair_seeds(round_key, 0, n_clients, n_clients), leaf_id)
    salts = salts_of_seeds(torch.as_tensor(seeds))
    salts.fill_diagonal_(0)
    return salts.to(device)


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


def quantize_mask_pairs_plain(x: torch.Tensor, w: torch.Tensor,
                              salts: torch.Tensor, scale: float,
                              clip: float) -> torch.Tensor:
    """The kernel's each-pair-once form, step by step: every row of an
    N-client group (x f32 [N, D], w f32 [N], salts [N, N] from
    ``pair_salts_plain``); each pair's mask is computed once, added to
    row i and subtracted from row j.  Bit-equal to ``quantize_mask_plain``
    (the uint32 ring's addition is associative)."""
    n, d = x.shape
    v = x.to(torch.float32) * w.to(torch.float32)[:, None]
    q = torch.round(torch.clamp(v, -clip, clip) * scale).to(torch.int32)
    idx_h = index_hash(d, x.device)
    acc = [q[r].to(torch.int64) & M32 for r in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            bits = fmix(idx_h ^ int(salts[i, j]))
            acc[i] = (acc[i] + bits) & M32
            acc[j] = (acc[j] - bits) & M32
    return torch.stack([to_ring(a) for a in acc])


# ---------------------------------------------------------------------------
# the leaf table
# ---------------------------------------------------------------------------

# the columns of a table row (secagg_mask.cu's Col)
X, D, COL, LEAF_ID = range(4)


def mask_layout(keys: Sequence[str], sizes: Sequence[int]) -> LeafLayout:
    """The launch's table of a group's leaves (K1's ``LeafLayout``): leaf
    j at columns ``offsets[j]`` of the [R, out_numel] buffer (multiples of
    4, so every row of every leaf starts 16-byte aligned); its leaf id is
    its index in ``keys`` (JAX's leaf order)."""
    return LeafLayout(keys, sizes, range(len(keys)), [False] * len(keys))


def mask_table(layout: LeafLayout, xs) -> np.ndarray:
    """This call's rows: each leaf's x pointer, D, first column and leaf
    id."""
    return np.array([
        [xs[j].data_ptr(), layout.sizes[j], layout.offsets[j],
         layout.leaf_ids[j]] for j in layout.rows], np.int64).reshape(-1, 4)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_lib_handle = None


def bind_k3(lib):
    """Declare K3's C entry points on a ctypes handle of secagg_mask.cu."""
    p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_uint)
    f32 = ctypes.c_float
    lib.secagg_mask_i32.argtypes = [p, p, p, p, i64, i32, i32, i64, f32,
                                    f32, p]
    lib.secagg_mask_i32.restype = i32
    lib.secagg_mask_table_i32.argtypes = [p, i32, p, p, i64, i64, i32, i32,
                                          u32, u32, f32, f32, p, p]
    lib.secagg_mask_table_i32.restype = i32
    lib.secagg_salts_i32.argtypes = [p, i32, u32, u32, i32, p]
    lib.secagg_salts_i32.restype = i32
    return lib


def _lib():
    """The kernel library, built from source at first use."""
    global _lib_handle
    if _lib_handle is None:
        from fedml_tpu_torch.utils import cuda_build
        _lib_handle = bind_k3(cuda_build.load("secagg_mask"))
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


def quantize_mask_table(layout: LeafLayout, xs, w: torch.Tensor,
                        round_key: prng.Key, first_client: int,
                        n_clients: int, scale: float,
                        clip: float) -> torch.Tensor:
    """Every leaf of the layout for R client rows (xs[j] f32 [R, D_j], w
    f32 [R]) in one launch (per 64 leaves), the pair keys derived from
    ``round_key`` in the launch: int32 [R, C], leaf j at columns
    ``layout.offsets[j]`` (``mask_layout``).  The CUDA kernel for CUDA
    leaves (w on their device); for CPU leaves the plain version leaf by
    leaf, with the seeds from ``pair_seeds``."""
    rows = int(w.shape[0])
    dev = xs[0].device if xs else w.device
    if dev.type == "cpu":
        buf = torch.zeros((rows, layout.out_numel), dtype=torch.int32)
        base = pair_seeds(round_key, first_client, rows, n_clients)
        for j, d in enumerate(layout.sizes):
            seeds = torch.as_tensor(leaf_seeds(base, layout.leaf_ids[j]))
            c = layout.offsets[j]
            buf[:, c:c + d] = quantize_mask_plain(xs[j], w, seeds,
                                                  first_client, scale, clip)
        return buf
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(w.device == dev and w.dtype == torch.float32
           and w.is_contiguous() and w.dim() == 1,
           f"w must be a contiguous float32 vector on the leaves' device "
           f"{dev}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    for j, d in enumerate(layout.sizes):
        x = xs[j]
        _check(x.device == dev and x.dtype == torch.float32
               and x.is_contiguous() and x.shape == (rows, d),
               f"leaf {layout.keys[j]}: x {x.dtype} {tuple(x.shape)} on "
               f"{x.device}, need contiguous float32 [{rows}, {d}] on "
               f"{dev}")
    _check(rows <= MAX_ROWS and n_clients <= MAX_CLIENTS,
           f"{rows} rows of a {n_clients}-client group exceed the kernel's "
           f"limits ({MAX_ROWS} rows, {MAX_CLIENTS} clients)")
    _check(0 <= first_client and first_client + rows <= n_clients,
           f"rows {first_client}..{first_client + rows - 1} are not clients "
           f"of a {n_clients}-client group")
    buf = torch.empty((rows, layout.out_numel), dtype=torch.int32,
                      device=dev)
    table = mask_table(layout, xs)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _lib().secagg_mask_table_i32(
            table.ctypes.data, len(table), w.data_ptr(), buf.data_ptr(),
            layout.out_numel, rows, n_clients, first_client,
            round_key[0] & M32, round_key[1] & M32, float(scale), float(clip),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(launches))
    if rc != 0:
        raise RuntimeError(f"secagg_mask kernel launch failed: CUDA error "
                           f"{rc}")
    launch_counts["secagg_mask"] += launches.value
    return buf


def pair_salts(round_key: prng.Key, n_clients: int, leaf_id: int,
               device) -> torch.Tensor:
    """The salts the kernel derives in its launch for every pair of an
    n-client group and leaf ``leaf_id`` (a probe of the in-launch keys; the
    masking path never calls it): int64 [n, n] of uint32 values, 0 on the
    diagonal.  On the CPU: ``pair_salts_plain``."""
    device = torch.device(device)
    if device.type == "cpu":
        return pair_salts_plain(round_key, n_clients, leaf_id)
    out = torch.empty((n_clients, n_clients), dtype=torch.int32,
                      device=device)
    with torch.cuda.device(device):
        rc = _lib().secagg_salts_i32(
            out.data_ptr(), n_clients, round_key[0] & M32,
            round_key[1] & M32, leaf_id,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"secagg_salts kernel launch failed: CUDA error "
                           f"{rc}")
    return out.to(torch.int64) & M32
