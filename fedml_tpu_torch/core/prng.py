"""JAX's threefry2x32 key chain, in numpy (and torch for bulk bits).

The JAX package derives its round keys, its secure-aggregation pair seeds
and the fused defense's seed words from ``jax.random`` threefry keys.  The
port reproduces them bit for bit, so that one ``--seed`` gives the same
streams in both packages.  The semantics are those of JAX with
``jax_threefry_partitionable`` on (JAX's default):

* ``key(seed)`` is ``(0, seed mod 2^32)``;
* ``fold_in(k, d)`` hashes the counter pair ``(0, d)``;
* ``split(k, n)[i]`` hashes the counter pair ``(0, i)`` (the high and low
  words of ``i``), so ``split(k, n)[i] == fold_in(k, i)``;
* ``random_bits(k, shape)`` hashes the high and low words of each flat
  row-major index and XORs the two output words.

A key is a tuple of two Python ints, the two uint32 words of
``jax.random.key_data``.  Arithmetic runs on Python ints (one key at a
time: ``fold_in``, ``split``) or on int64 tensors holding uint32 values
(``random_bits``, on any device), masked to 32 bits after each add and
shift.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.murmur import M32

Key = Tuple[int, int]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k: Key, x0, x1):
    """The Threefry-2x32 block (20 rounds) keyed by ``k`` over counter
    words ``x0``, ``x1`` (Python ints, or int64 tensors of uint32 values
    of one shape); returns the two output words."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & M32)) & M32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` (32-bit mode): the seed's low 32 bits."""
    return (0, int(seed) & M32)


def fold_in(k: Key, data: int) -> Key:
    data = int(data)
    if not 0 <= data <= M32:
        raise OverflowError(f"Python integer {data} out of bounds for uint32")
    return threefry2x32(k, 0, data)


def split(k: Key, num: int = 2) -> List[Key]:
    return [threefry2x32(k, i >> 32, i & M32) for i in range(num)]


def key_data(k: Key) -> np.ndarray:
    """The key's two words, uint32 [2]."""
    return np.array(k, np.uint32)


def key_words_int32(k: Key) -> Tuple[int, int]:
    """The key's two words reinterpreted as int32, as
    ``key_data(k).astype(uint32)[:2].astype(int32)`` gives them in JAX."""
    w = key_data(k).view(np.int32)
    return int(w[0]), int(w[1])


def random_bits_tensor(k: Key, numel: int, device) -> torch.Tensor:
    """``random_bits(k, (numel,))`` as an int64 tensor of uint32 values,
    computed on ``device``."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k, idx >> 32, idx & M32)
    return y0 ^ y1


def random_bits(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``."""
    bits = random_bits_tensor(k, math.prod(shape), "cpu")
    return bits.numpy().astype(np.uint32).reshape(tuple(shape))
