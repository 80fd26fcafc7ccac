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
  row-major index and XORs the two output words;
* ``normal(k, shape)`` maps those bits to f32 uniforms in
  ``[nextafter(-1, 0), 1)`` as ``jax.random.uniform`` does (the top 23
  bits as a mantissa) and returns ``sqrt(2) * erfinv(u)``, with erfinv
  as XLA's f32 polynomial (Giles' single-precision approximation);
* ``permutation(k, n)`` is ``jax.random.permutation``: rounds of a
  stable sort of ``arange(n)`` by fresh random bits, one ``split`` per
  round;
* ``bernoulli(k, p, shape)`` is ``uniform < p`` on f32 uniforms;
* ``randint(k, shape, lo, hi)`` (int32) splits ``k`` in two, draws 32
  bits from each half, and combines them as ``(hi_bits % span) *
  (2^32 % span) + lo_bits % span``, modulo the span, in uint32
  arithmetic (``2^32 % span`` taken as ``(2^16 % span)^2 % span``, the
  square wrapping at 2^32).

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


# XLA's f32 ErfInv (Giles, "Approximating the erfinv function"): a degree-8
# polynomial in w = -log1p(-x^2), shifted, with one coefficient table for
# w < 5 and one for the tails
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv`` as tensor ops (``erfinv(+-1) = +-inf``)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_W_LT_5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_W_GE_5[i], dtype=x.dtype,
                                        device=x.device))

    p = coeff(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(x.dtype).max, p * x)


def uniform_f32(k: Key, numel: int, device, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, (numel,), float32, minval, maxval)``.  XLA
    fuses ``floats * span + minval`` into one FMA; the product of two f32
    is exact in f64, so the f64 evaluation rounded once to f32 gives the
    same words."""
    bits = random_bits_tensor(k, numel, device)
    one = int(np.array(1.0, np.float32).view(np.uint32))
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    out = (floats.to(torch.float64) * float(span) + float(lo)).to(
        torch.float32)
    return torch.clamp_min(out, float(lo))


def bernoulli(k: Key, p: float = 0.5, shape: Sequence[int] = (),
              device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for a float ``p`` (f32): a
    bool tensor on ``device``."""
    u = uniform_f32(k, math.prod(shape), device)
    return (u < float(np.float32(p))).reshape(tuple(shape))


def randint(k: Key, shape: Sequence[int], minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32 bounds and
    result) on ``device``; ``maxval <= minval`` gives ``minval``."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise OverflowError(f"randint bounds [{minval}, {maxval}) are not "
                            f"int32")
    k1, k2 = split(k)
    numel = math.prod(shape)
    higher = random_bits_tensor(k1, numel, device)
    lower = random_bits_tensor(k2, numel, device)
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (((2 ** 16 % span) ** 2) & M32) % span
    offset = ((((higher % span) * multiplier) & M32) + lower % span) & M32
    out = minval + offset % span
    return out.to(torch.int32).reshape(tuple(shape))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(k: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape)`` (f32) on ``device``."""
    u = uniform_f32(k, math.prod(shape), device, _NORMAL_LO, 1.0)
    return (erfinv_f32(u) * _SQRT2_F32).reshape(tuple(shape))


def permutation(k: Key, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: ``ceil(3 ln n / ln(2^32 - 1))``
    rounds, each a stable sort of the running order by the bits of a
    fresh ``split`` subkey."""
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def choice_without_replacement(k: Key, n: int, m: int) -> np.ndarray:
    """``jax.random.choice(k, n, (m,), replace=False)``."""
    if m > n:
        raise ValueError(f"cannot take {m} of {n} without replacement")
    return permutation(k, n)[:m]


# -- keys as tensors: many keys at once, on any device ----------------------
# A batch of keys is an int64 tensor ``[..., 2]`` holding the two uint32
# words of each key, so a cohort's keys can be derived in one pass and
# handed to ``torch.func.vmap`` as a batched input.

def fold_in_many(k: Key, data: torch.Tensor) -> torch.Tensor:
    """``[fold_in(k, d) for d in data]`` as a ``[len(data), 2]`` int64
    tensor on ``data``'s device; ``data`` holds uint32 values."""
    y0, y1 = threefry2x32(k, torch.zeros_like(data), data & M32)
    return torch.stack([y0, y1], dim=-1)


def split_tensor(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split(k)`` of every key of a ``[..., 2]`` tensor: the two halves,
    each ``[..., 2]``."""
    k = (keys[..., 0], keys[..., 1])
    zero = torch.zeros_like(keys[..., 0])
    a = threefry2x32(k, zero, zero)
    b = threefry2x32(k, zero, zero + 1)
    return torch.stack(a, dim=-1), torch.stack(b, dim=-1)


def step_keys(keys: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The per-step dropout keys of the JAX local trainer's chain (``rng,
    dropout_rng = split(rng)`` at every step) for a ``[C, 2]`` batch of
    client keys: ``[C, num_steps, 2]``."""
    out = []
    for _ in range(num_steps):
        keys, drop = split_tensor(keys)
        out.append(drop)
    return torch.stack(out, dim=-2)
