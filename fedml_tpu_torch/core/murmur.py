"""murmur3's 32-bit finaliser and the counter-PRG pieces built on it.

The JAX package's two counter PRGs (the weak-DP noise of
``core/pallas_agg.py`` and the secure-aggregation masks of
``secure/pallas_mask.py``) hash an element's index with murmur3's
finaliser, keyed by salts hashed from int32 seed words.  Both kernels'
plain versions share these helpers.  They take Python ints or int64
tensors holding uint32 values: PyTorch's CPU tensors have no uint32
shifts or adds, so every result is masked to 32 bits, and constant
multiplies split the constant into 16-bit halves so that no int64
product overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF


def mul32(x, c: int):
    """(x * c) mod 2^32 for x < 2^32."""
    if not isinstance(x, torch.Tensor):
        return (x * c) & M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def fmix(x):
    """murmur3's 32-bit finaliser on a Python int or an int64 tensor."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def index_hash(d: int, device) -> torch.Tensor:
    """``fmix(i * 0x9E3779B9 + 1)`` for every element index i < d."""
    idx = torch.arange(d, dtype=torch.int64, device=device)
    return fmix((mul32(idx, 0x9E3779B9) + 1) & M32)


def seed_salts(seed0, seed1) -> Tuple:
    """The two salts hashed from a pair of int32 seed words."""
    return fmix(seed0 & M32), fmix((seed1 & M32) ^ 0x5BD1E995)


def to_int32(v: int) -> int:
    """Reinterpret the low 32 bits as a signed int32."""
    v &= M32
    return v - (1 << 32) if v >= (1 << 31) else v
