"""The port's fused robust aggregate (``fedml_tpu_torch/core/fused_agg.py``)
against the JAX package's Pallas kernel run through the interpreter.

On the CPU the port's wrapper takes the plain PyTorch version of the CUDA
kernel, so these tests hold that arithmetic to the Pallas kernel's:

* sigma = 0: equal to the interpret-mode kernel within 2e-5 (f32 sums in
  another order);
* sigma > 0, same seed words: the noise uniforms are bit-equal to JAX's
  ``_murmur_fmix`` / ``_gaussian_from_index`` internals; the Gaussians
  agree within 1e-5 relative + 1e-6 absolute (a few ulps of log / cos /
  sqrt, which XLA and PyTorch implement differently), and so does the
  aggregate, within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.pallas_agg import (_gaussian_from_index, _murmur_fmix,
                                       make_fused_robust_aggregate as j_fused)
from fedml_tpu.core.pytree import tree_weighted_mean as j_mean
from fedml_tpu.core.robust import clip_update as j_clip
from fedml_tpu_torch.core import fused_agg
from fedml_tpu_torch.core.fused_agg import (
    MAX_CLIENTS, make_fused_robust_aggregate as t_fused, noise_uniforms,
    robust_agg, robust_agg_plain)
from fedml_tpu_torch.core.pytree import tree_weighted_mean as t_mean
from fedml_tpu_torch.core.robust import (add_gaussian_noise, clip_update,
                                         default_is_weight_param)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

W = np.array([4.0, 1.0, 0.0, 2.5, 3.0, 1.5], np.float32)  # incl. a pad slot


def _stacked_params(rng, n=6):
    """test_pallas_agg.py's tree: a batch_stats branch (never clipped), an
    int leaf, and a ragged mix of leaf shapes."""
    mk = lambda *s: rng.randn(n, *s).astype(np.float32)
    return {
        "params": {"dense": {"kernel": mk(17, 33), "bias": mk(33)},
                   "conv": {"kernel": mk(3, 3, 2, 8)}},
        "batch_stats": {"bn": {"mean": mk(8), "var": np.abs(mk(8)),
                               "num_batches_tracked": rng.randint(
                                   0, 100, (n, 1)).astype(np.int32)}},
    }


def _seed_words(key):
    """The round seed words the JAX fused aggregate derives from its key."""
    data = np.asarray(jax.random.key_data(key)).astype(np.uint32)
    return tuple(int(v) for v in data.view(np.int32)[:2])


def _both(stacked, w, key, **kw):
    g = jax.tree.map(lambda x: x[0] * 0.5, stacked)
    want = j_fused(interpret=True, **kw)(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
        jax.tree.map(jnp.asarray, g), key)
    got = t_fused(**kw)(params_from_numpy(stacked), torch.tensor(w),
                        params_from_numpy(g), _seed_words(key))
    return params_to_numpy(got), jax.tree.map(np.asarray, want)


def _assert_tree_close(got, want, atol):
    def check(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    jax.tree.map(check, got, want)


@pytest.mark.parametrize("norm_bound", [None, 0.7])
def test_plain_matches_pallas_sigma0(rng, norm_bound):
    got, want = _both(_stacked_params(rng), W, jax.random.key(0),
                      norm_bound=norm_bound, noise_std=0.0)
    _assert_tree_close(got, want, atol=2e-5)


@pytest.mark.parametrize("norm_bound", [None, 0.7])
def test_sigma0_matches_unfused_compose(rng, norm_bound):
    """The fused aggregate == per-client clip_update then the weighted
    mean, both in the port (the JAX package's own test, ported)."""
    stacked = params_from_numpy(_stacked_params(rng))
    g = {k: v[0] * 0.5 for k, v in stacked.items()}
    got = t_fused(norm_bound=norm_bound)(stacked, torch.tensor(W), g, (1, 2))
    if norm_bound is None:
        want = t_mean(stacked, torch.tensor(W))
    else:
        rows = [clip_update({k: v[i] for k, v in stacked.items()}, g,
                            norm_bound) for i in range(len(W))]
        want = t_mean(rows, torch.tensor(W))
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=0)


@pytest.mark.parametrize("key_words", [None, (0x7FFFFFF0, 0xFFFFFFF0)])
def test_plain_matches_pallas_with_noise(rng, key_words):
    """sigma > 0 with the same seed words; the second case puts both words
    where ``seed + li * 31337`` wraps around int32."""
    key = (jax.random.key(7) if key_words is None else
           jax.random.wrap_key_data(jnp.asarray(key_words, jnp.uint32)))
    got, want = _both(_stacked_params(rng), W, key, norm_bound=0.7,
                      noise_std=0.5)
    _assert_tree_close(got, want, atol=2e-5)
    # the noise is really there: sigma=0 differs by far more than that
    base, _ = _both(_stacked_params(np.random.RandomState(0)), W, key,
                    norm_bound=0.7, noise_std=0.0)
    assert np.abs(base["params"]["dense"]["kernel"]
                  - got["params"]["dense"]["kernel"]).max() > 0.05


def test_uniforms_bit_equal_and_gaussians_close():
    seed0, seed1 = _seed_words(jax.random.key(11))
    d = 4099
    idx = jnp.arange(d, dtype=jnp.uint32)
    idx_h = _murmur_fmix(idx * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
    s0 = _murmur_fmix(jnp.uint32(np.uint32(seed0 & 0xFFFFFFFF)))
    s1 = _murmur_fmix(jnp.uint32(np.uint32(seed1 & 0xFFFFFFFF))
                      ^ jnp.uint32(0x5BD1E995))
    for i in (0, 1, 9, 511):
        salt = _murmur_fmix(s0 ^ (s1 + jnp.uint32(i) * jnp.uint32(0x85EBCA6B)))
        b1 = _murmur_fmix(idx_h ^ salt)
        b2 = _murmur_fmix(b1 ^ jnp.uint32(0x27D4EB2F))
        j_u1 = np.asarray((b1 >> 8).astype(jnp.int32).astype(jnp.float32)
                          * (2.0 ** -24) + (2.0 ** -25))
        j_u2 = np.asarray((b2 >> 8).astype(jnp.int32).astype(jnp.float32)
                          * (2.0 ** -24))
        t_u1, t_u2 = noise_uniforms(d, seed0, seed1, i, "cpu")
        np.testing.assert_array_equal(t_u1.numpy().view(np.int32),
                                      j_u1.view(np.int32))
        np.testing.assert_array_equal(t_u2.numpy().view(np.int32),
                                      j_u2.view(np.int32))
        j_n = np.asarray(_gaussian_from_index(idx_h, salt))
        t_n = fused_agg._gaussian(t_u1, t_u2).numpy()
        np.testing.assert_allclose(t_n, j_n, rtol=1e-5, atol=1e-6)


def test_noise_statistics():
    """The summed noise of N clients with equal weights has std
    sigma * sqrt(sum r_i^2) = sigma / sqrt(N) (5% sampling tolerance)."""
    n, d, sigma = 4, 64 * 128, 0.5
    x = torch.zeros(n, d)
    ratios = torch.full((n,), 1.0 / n)
    out = robust_agg_plain(x, torch.zeros(d), torch.ones(n), ratios, 3, 4,
                           sigma).numpy()
    assert abs(out.mean()) < 0.01
    np.testing.assert_allclose(out.std(), sigma / np.sqrt(n), rtol=0.05)


def test_cohort_guard_refuses_in_both(rng):
    n = MAX_CLIENTS + 1
    stacked = {"w": rng.randn(n, 3).astype(np.float32)}
    g = {"w": np.zeros(3, np.float32)}
    w = np.ones(n, np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        j_fused(interpret=True)(jax.tree.map(jnp.asarray, stacked),
                                jnp.asarray(w), jax.tree.map(jnp.asarray, g),
                                jax.random.key(0))
    with pytest.raises(ValueError, match="exceeds"):
        t_fused()(params_from_numpy(stacked), torch.tensor(w),
                  params_from_numpy(g), (0, 0))


def test_wrapper_uses_plain_only_on_cpu(monkeypatch):
    """CPU tensors take the plain version and count no launch; a tensor on
    another device never falls back to it."""
    fused_agg.reset_launch_counts()
    x, g = torch.randn(3, 10), torch.randn(10)
    s, r = torch.ones(3), torch.full((3,), 1 / 3)
    torch.testing.assert_close(robust_agg(x, g, s, r, 1, 2, 0.1),
                               robust_agg_plain(x, g, s, r, 1, 2, 0.1))
    assert fused_agg.launch_counts["robust_agg"] == 0
    monkeypatch.setattr(fused_agg, "robust_agg_plain", None)
    with pytest.raises(ValueError, match="unsupported device"):
        robust_agg(x.to("meta"), g.to("meta"), s.to("meta"), r.to("meta"),
                   1, 2, 0.1)


def test_unfused_defense_matches_jax_clip(rng):
    """The torch backend's clip equals JAX's clip_update (1e-6); its noise
    (a torch.Generator stream) has the requested stddev and spares int
    leaves."""
    tree = jax.tree.map(lambda x: x[0], _stacked_params(rng))
    g = jax.tree.map(lambda x: x * 0.5, tree)
    want = jax.tree.map(np.asarray, j_clip(jax.tree.map(jnp.asarray, tree),
                                           jax.tree.map(jnp.asarray, g), 0.7))
    got = params_to_numpy(clip_update(params_from_numpy(tree),
                                      params_from_numpy(g), 0.7))
    _assert_tree_close(got, want, atol=1e-6)
    assert not default_is_weight_param("batch_stats/bn/mean")
    assert default_is_weight_param("params/dense/kernel")

    big = {"w": torch.zeros(100_000), "n": torch.zeros(3, dtype=torch.int32)}
    noised = add_gaussian_noise(big, torch.Generator().manual_seed(0), 0.25)
    np.testing.assert_allclose(float(noised["w"].std()), 0.25, rtol=0.02)
    assert torch.equal(noised["n"], big["n"])


def test_jax_compose_and_port_agree_on_clip_then_mean(rng):
    """Both packages' clip-then-mean agree (2e-5): the reference for the
    fused kernel at sigma = 0 is the same on both sides."""
    stacked = _stacked_params(rng)
    g = jax.tree.map(lambda x: x[0] * 0.5, stacked)
    clipped = jax.vmap(j_clip, in_axes=(0, None, None))(
        jax.tree.map(jnp.asarray, stacked), jax.tree.map(jnp.asarray, g), 0.7)
    want = jax.tree.map(np.asarray, j_mean(clipped, jnp.asarray(W)))
    got = params_to_numpy(t_fused(norm_bound=0.7)(
        params_from_numpy(stacked), torch.tensor(W), params_from_numpy(g),
        (5, 6)))
    _assert_tree_close(got, want, atol=2e-5)
