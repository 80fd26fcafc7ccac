"""The port's defended aggregate (``fedml_tpu_torch/robust/defense.py``)
and the streaming reservoir (``core/stream_agg.py``) against the JAX
package.

Inputs are numpy-seeded; the cohort stack holds the global at its
weight-0 slots, as the servers stage it.  Tolerances:

* every method at sigma 0, with and without a clip, against JAX's
  `make_defended_aggregate`: 1e-6 (the clip scale's sum of squares and
  the trimmed sums run in another order; the geometric median 1e-5);
* the port's stack mode against its stream mode: bit for bit (the same
  fold, slot by slot, and the same noise generator);
* sigma > 0: the same step gives the same bits, another step other bits;
* the reservoir's slot choices: bit-equal to the JAX package's (the same
  ``RandomState`` draws), and its finalize within the rule's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.robust.defense import make_defended_aggregate as j_defended
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.robust.defense import (ROBUST_AGG_METHODS,
                                            make_defended_aggregate)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

TOL = dict.fromkeys(ROBUST_AGG_METHODS, 1e-6)
TOL["geometric_median"] = 1e-5
RULE = dict(trim_frac=0.2, byz_f=1, krum_m=2)


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)}}


def _cohort(n=6, dead=(2, 5), seed=7):
    """n slots of updates around the global; ``dead`` slots hold the
    global at weight 0."""
    g = _params()
    rng = np.random.RandomState(seed)
    ups, w = [], np.zeros(n, np.float32)
    for i in range(n):
        if i in dead:
            ups.append(g)
            continue
        ups.append(jax.tree.map(lambda v: (v + rng.randn(*v.shape)).astype(
            np.float32), g))
        w[i] = 10.0 * (i + 1)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *ups)
    return g, ups, stacked, w


def _leaves(port_flat):
    return jax.tree.leaves(params_to_numpy(port_flat))


@pytest.mark.parametrize("method", ROBUST_AGG_METHODS)
@pytest.mark.parametrize("clip", [0.0, 3.0])
def test_defended_aggregate_matches_jax(method, clip):
    g, _, stacked, w = _cohort()
    want = j_defended(method, norm_clip=clip, **RULE)(
        jax.tree.map(jnp.asarray, g), stacked, w, 4)
    got = make_defended_aggregate(method, norm_clip=clip, **RULE)(
        params_from_numpy(g), params_from_numpy(stacked), w, 4)
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=TOL[method])


@pytest.mark.parametrize("clip,noise", [(0.0, 0.0), (3.0, 0.0), (0.0, 0.05),
                                        (3.0, 0.05)])
def test_stack_mode_equals_stream_mode_bit_for_bit(clip, noise):
    """The mean over the static stack equals the fold of the admitted
    uploads in slot order, bit for bit, noise included."""
    g, ups, stacked, w = _cohort()
    stack = make_defended_aggregate("mean", norm_clip=clip, noise_std=noise,
                                    seed=11)(params_from_numpy(g),
                                             params_from_numpy(stacked), w, 3)
    stream = StreamingAggregator(params_from_numpy(g), norm_clip=clip,
                                 noise_std=noise, seed=11)
    stream.reset(params_from_numpy(g))
    for u, wi in zip(ups, w):
        if wi > 0:
            stream.fold(params_from_numpy(u), wi)
    got = stream.finalize(3)
    for k in stack:
        assert stack[k].numpy().tobytes() == got[k].numpy().tobytes(), k


def test_noise_is_deterministic_per_step():
    g, _, stacked, w = _cohort()
    fn = make_defended_aggregate("trimmed_mean", noise_std=0.05, seed=2,
                                 **RULE)
    args = (params_from_numpy(g), params_from_numpy(stacked), w)
    a, b, c = fn(*args, 5), fn(*args, 5), fn(*args, 6)
    quiet = make_defended_aggregate("trimmed_mean", **RULE)(*args, 5)
    for k in a:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes()
        assert not torch.equal(a[k], c[k])
        assert 0.02 < float((a[k] - quiet[k]).std()) < 0.1


def test_defended_aggregate_validates():
    for fn in (j_defended, make_defended_aggregate):
        with pytest.raises(ValueError, match="unknown robust aggregation"):
            fn("majority")
        with pytest.raises(ValueError, match="norm_clip/noise_std"):
            fn("mean", norm_clip=-1.0)
        with pytest.raises(ValueError, match="trim_frac"):
            fn("trimmed_mean", trim_frac=0.6)


def _reservoir_pair(method, k, seed, clip=0.0):
    g = _params()
    j = JStream(g, method=method, reservoir_k=k, seed=seed, norm_clip=clip,
                **RULE)
    t = StreamingAggregator(params_from_numpy(g), method=method,
                            reservoir_k=k, seed=seed, norm_clip=clip, **RULE)
    return g, j, t


@pytest.mark.parametrize("k,n,seed", [(4, 20, 0), (4, 20, 9), (8, 8, 1),
                                      (3, 40, 5)])
def test_reservoir_slots_bit_equal_to_jax(k, n, seed):
    """Algorithm R over the same ``RandomState(seed)``: after each round
    the same uploads sit in the same slots (weights tag the uploads), over
    two rounds of one aggregator."""
    g, j, t = _reservoir_pair("coordinate_median", k, seed)
    rng = np.random.RandomState(100 + seed)
    for round_idx in range(2):
        j.reset(g)
        t.reset(params_from_numpy(g))
        for i in range(n):
            up = jax.tree.map(lambda v: (v + rng.randn(*v.shape)).astype(
                np.float32), g)
            j.fold(up, float(i + 1))
            t.fold(params_from_numpy(up), float(i + 1))
        assert t._res_weights.tobytes() == j._res_weights.tobytes()
        for a, b in zip(_leaves(t._res_stack), jax.tree.leaves(j._res_stack)):
            assert a.tobytes() == np.asarray(b).tobytes()
        assert t.count == j.count == n


@pytest.mark.parametrize("method", ROBUST_AGG_METHODS[1:])
@pytest.mark.parametrize("clip", [0.0, 3.0])
def test_reservoir_finalize_matches_jax(method, clip):
    g, j, t = _reservoir_pair(method, 4, 3, clip)
    j.reset(g)
    t.reset(params_from_numpy(g))
    rng = np.random.RandomState(8)
    for i in range(10):
        up = jax.tree.map(lambda v: (v + rng.randn(*v.shape)).astype(
            np.float32), g)
        j.fold(up, float(i + 1))
        t.fold(params_from_numpy(up), float(i + 1))
    for a, b in zip(_leaves(t.finalize(2)), jax.tree.leaves(j.finalize(2))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=TOL[method])


def test_reservoir_refuses_what_it_cannot_do():
    g, _, t = _reservoir_pair("krum", 4, 0)
    t.reset(params_from_numpy(g))
    with pytest.raises(ValueError, match="template"):
        t.fold({"dense/kernel": torch.zeros(16, 12)}, 1.0)
    assert t.count == 0
    with pytest.raises(RuntimeError, match="fold_wave"):
        t.fold_wave(params_from_numpy(g), np.ones(1))
    with pytest.raises(RuntimeError, match="abort-only"):
        t.state_dict()
    with pytest.raises(ValueError, match="reservoir_k"):
        StreamingAggregator(params_from_numpy(g), method="krum",
                            reservoir_k=0)
