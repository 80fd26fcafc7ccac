"""The port's numpy threefry (``fedml_tpu_torch/core/prng.py``) against
``jax.random`` with the installed JAX's defaults (threefry, partitionable
splits and bits): every function is bit-equal, over many seeds and data
words drawn by hypothesis (derandomized, so every run draws the same)."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fedml_tpu_torch.core import prng

SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)
seeds = st.integers(min_value=-2**31, max_value=2**32 - 1)
words = st.integers(min_value=0, max_value=2**32 - 1)


def _jax_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


def test_threefry_partitionable_is_on():
    """The port pins the partitionable semantics of split and bits, which
    is JAX's default."""
    assert jax.config.jax_threefry_partitionable


@SETTINGS
@given(seed=seeds)
def test_key_and_key_data(seed):
    np.testing.assert_array_equal(prng.key_data(prng.key(seed)),
                                  _jax_data(jax.random.key(seed)))


@SETTINGS
@given(seed=seeds, data=words, data2=words)
def test_fold_in_chain(seed, data, data2):
    want = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), data),
                              data2)
    got = prng.fold_in(prng.fold_in(prng.key(seed), data), data2)
    np.testing.assert_array_equal(prng.key_data(got), _jax_data(want))
    assert prng.key_words_int32(got) == tuple(
        int(v) for v in _jax_data(want).view(np.int32))


def test_fold_in_refuses_what_jax_refuses():
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.key(0), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(0), -1)


@SETTINGS
@given(seed=seeds, num=st.sampled_from([1, 2, 3, 7, 16]))
def test_split(seed, num):
    want = _jax_data(jax.random.split(jax.random.key(seed), num))
    got = np.array([prng.key_data(k) for k in prng.split(prng.key(seed),
                                                           num)])
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(seed=seeds, depth=st.integers(min_value=1, max_value=5))
def test_split_chain(seed, depth):
    """The round-key chain of FedAvg.run: rng, sub = split(rng), repeated."""
    jk, pk = jax.random.key(seed), prng.key(seed)
    for _ in range(depth):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng.split(pk)
        np.testing.assert_array_equal(prng.key_data(psub), _jax_data(jsub))
    np.testing.assert_array_equal(prng.key_data(pk), _jax_data(jk))


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 7), (2, 3, 5),
                                   (4099,)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_random_bits(shape, seed):
    k = jax.random.fold_in(jax.random.key(seed), 9)
    want = np.asarray(jax.random.bits(k, shape, np.uint32))
    pk = prng.fold_in(prng.key(seed), 9)
    got = prng.random_bits(pk, shape)
    assert got.dtype == np.uint32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    tensor = prng.random_bits_tensor(pk, int(np.prod(shape)), "cpu")
    assert tensor.dtype == torch.int64
    np.testing.assert_array_equal(tensor.numpy().astype(np.uint32),
                                  want.reshape(-1))


@pytest.mark.parametrize("seed", [7, 2**40 + 5, 123456789])
def test_normal_within_one_ulp_of_jax(seed):
    """``prng.normal`` over 10^5 draws against ``jax.random.normal``: the
    uniforms are bit-equal, erfinv is XLA's f32 polynomial; XLA's log1p
    and fused multiply-adds leave at most an ulp (1e-6 absolute)."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), (100_000,)))
    got = prng.normal(prng.key(seed), (100_000,)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6
    assert np.mean(got == want) > 0.9


@SETTINGS
@given(seed=seeds, lo=st.floats(-4, 0), span=st.floats(0.5, 8))
def test_uniform_bit_equal(seed, lo, span):
    lo, hi = np.float32(lo), np.float32(lo + span)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (257,),
                                         minval=lo, maxval=hi))
    got = prng.uniform_f32(prng.key(seed), 257, "cpu", float(lo),
                           float(hi)).numpy()
    assert np.array_equal(got, want)


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    y = prng.erfinv_f32(x)
    assert y[0] == -torch.finfo(torch.float32).max and \
        y[1] == torch.finfo(torch.float32).max and y[2] == 0
    np.testing.assert_allclose(y[3:].numpy(), np.asarray(
        jax.scipy.special.erfinv(x[3:].numpy())), atol=1e-6)


@SETTINGS
@given(seed=seeds, n=st.integers(min_value=1, max_value=5000))
def test_permutation_and_choice_bit_equal(seed, n):
    k = jax.random.key(seed)
    assert np.array_equal(prng.permutation(prng.key(seed), n),
                          np.asarray(jax.random.permutation(k, n)))
    m = max(1, n // 3)
    assert np.array_equal(
        prng.choice_without_replacement(prng.key(seed), n, m),
        np.asarray(jax.random.choice(k, n, (m,), replace=False)))
