"""The port's streaming fold (``fedml_tpu_torch/core/stream_agg.py``)
against the JAX package's `StreamingAggregator`.

Inputs are made with numpy from fixed seeds and handed to both.  Tolerances:

* unclipped folds, ``fold_wave`` and weight-0 slots: bit for bit (the fold
  is one multiply-add per element in slot order on both sides);
* clipped folds: ``atol=2e-6`` — the clip scale is ``bound / ||u - g||``
  and XLA's CPU reduction sums the squares in another order than
  PyTorch's, so the scale may differ in its last bit, which moves each
  clipped element by up to an ulp of the scale times ``|u - g|`` (< 10
  here);
* sigma > 0: the compose draws from a torch generator, not JAX's threefry
  normal, so only the noise statistics are pinned.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu_torch.core.stream_agg import (StreamingAggregator,
                                             zeros_acc_like)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


@pytest.fixture(autouse=True)
def no_timer_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and isinstance(t, threading.Timer)]
    assert not leaked, leaked


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
            "step": np.int32(5)}


def _uploads(n, seed=7):
    rng = np.random.RandomState(seed)
    ups, ws = [], []
    for i in range(n):
        ups.append(jax.tree.map(
            lambda v: (np.asarray(v) + rng.randn(*np.shape(v))).astype(
                np.asarray(v).dtype), _params()))
        ws.append(float(10 * (i + 1)))
    return ups, ws


def _assert_equal(port_flat, jax_tree, atol=0.0):
    got = jax.tree.leaves(params_to_numpy(port_flat))
    want = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            assert a.tobytes() == b.tobytes()


def _both(clip=0.0, noise=0.0, seed=3):
    tmpl = _params()
    j = JStream(tmpl, method="mean", norm_clip=clip, noise_std=noise,
                seed=seed)
    t = StreamingAggregator(params_from_numpy(tmpl), method="mean",
                            norm_clip=clip, noise_std=noise, seed=seed)
    j.reset(tmpl)
    t.reset(params_from_numpy(tmpl))
    return j, t


@pytest.mark.parametrize("clip,atol", [(0.0, 0.0), (5.0, 2e-6), (2.5, 2e-6)])
def test_fold_matches_jax(clip, atol):
    j, t = _both(clip)
    ups, ws = _uploads(6)
    for u, w in zip(ups, ws):
        j.fold(u, w)
        t.fold(params_from_numpy(u), w)
    assert t.count == j.count and t.weight_total == j.weight_total
    _assert_equal(t.finalize(2), j.finalize(2), atol)


def test_fold_accepts_host_arrays_from_the_wire():
    """An upload may hold the decoded frame's read-only numpy views."""
    _, a = _both()
    _, b = _both()
    for u, w in zip(*_uploads(3)):
        flat = params_from_numpy(u)
        a.fold(flat, w)
        views = {k: v.numpy() for k, v in flat.items()}
        for v in views.values():
            v.flags.writeable = False
        b.fold(views, w)
    _assert_equal(a.finalize(0), params_to_numpy(b.finalize(0)))


@pytest.mark.parametrize("clip,atol", [(0.0, 0.0), (5.0, 2e-6)])
def test_fold_wave_matches_jax_and_per_upload(clip, atol):
    ups, ws = _uploads(5)
    stk = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                       *ups)
    j, t = _both(clip)
    j.fold_wave(jax.tree.map(jax.numpy.asarray, stk),
                np.asarray(ws, np.float32))
    t.fold_wave(params_from_numpy(stk), np.asarray(ws, np.float32))
    got = t.finalize(0)
    _assert_equal(got, j.finalize(0), atol)
    _, per = _both(clip)
    for u, w in zip(ups, ws):
        per.fold(params_from_numpy(u), w)
    _assert_equal(got, params_to_numpy(per.finalize(0)))   # bit for bit


@pytest.mark.parametrize("wave", [False, True])
def test_weight_zero_slots_are_exactly_absent(wave):
    """A slot holding the reference at weight 0 (dropped, quarantined or
    rejected) adds an exact +0.0: bit-identical to never folding it, and
    to JAX's fold of the same slots."""
    tmpl = _params()
    ups, ws = _uploads(5)
    ups[2], ws[2] = tmpl, 0.0
    j, t = _both(2.0)
    _, absent = _both(2.0)
    if wave:
        stk = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *ups)
        t.fold_wave(params_from_numpy(stk), np.asarray(ws, np.float32))
        j.fold_wave(jax.tree.map(jax.numpy.asarray, stk),
                    np.asarray(ws, np.float32))
    else:
        for u, w in zip(ups, ws):
            t.fold(params_from_numpy(u), w)
            j.fold(u, w)
    for i, (u, w) in enumerate(zip(ups, ws)):
        if i != 2:
            absent.fold(params_from_numpy(u), w)
    got = t.finalize(0)
    _assert_equal(got, params_to_numpy(absent.finalize(0)))
    _assert_equal(got, j.finalize(0), atol=2e-6)
    assert t.count == (4 if wave else 5) == j.count


def test_int_leaves_accumulate_exactly():
    """acc_dtype contract: int leaves fold in an f32 accumulator and come
    back in their own dtype, as in the JAX package."""
    tmpl = {"w": np.ones(3, np.float32), "step": np.int32(4)}
    ups = [{"w": np.full(3, i, np.float32), "step": np.int32(i)}
           for i in range(1, 4)]
    j = JStream(tmpl, method="mean")
    t = StreamingAggregator(params_from_numpy(tmpl), method="mean")
    j.reset(tmpl)
    t.reset(params_from_numpy(tmpl))
    for u, w in zip(ups, (10.0, 20.0, 30.0)):
        j.fold(u, w)
        t.fold(params_from_numpy(u), w)
    acc = zeros_acc_like(params_from_numpy(tmpl))
    assert acc["step"].dtype == torch.float32
    assert acc["w"].dtype == torch.float32
    _assert_equal(t.finalize(0), j.finalize(0))


def test_sigma_pos_compose_statistics_and_step_keying():
    """The compose's noise: zero mean, the requested std, the same draw
    for the same (seed, step), another draw for another step."""
    tmpl = {"w": np.zeros((64, 128), np.float32)}
    ups = [{"w": np.random.RandomState(i).randn(64, 128).astype(np.float32)}
           for i in range(3)]

    def run(noise, step):
        t = StreamingAggregator(params_from_numpy(tmpl), method="mean",
                                noise_std=noise, seed=9)
        t.reset(params_from_numpy(tmpl))
        for u in ups:
            t.fold(params_from_numpy(u), 1.0)
        return t.finalize(step)["w"]

    delta = (run(0.5, 1) - run(0.0, 1)).ravel()
    assert abs(float(delta.mean())) < 0.02
    assert float(delta.std()) == pytest.approx(0.5, rel=0.1)
    assert torch.equal(run(0.5, 1), run(0.5, 1))
    assert not torch.allclose(run(0.5, 1), run(0.5, 2))


def test_state_dict_roundtrip_is_bit_exact():
    ups, ws = _uploads(4)
    _, a = _both(2.0)
    _, b = _both(2.0)
    for u, w in zip(ups[:2], ws[:2]):
        a.fold(params_from_numpy(u), w)
    b.load_state_dict(a.state_dict())
    for u, w in zip(ups[2:], ws[2:]):
        a.fold(params_from_numpy(u), w)
        b.fold(params_from_numpy(u), w)
    assert a.count == b.count == 4
    _assert_equal(a.finalize(0), params_to_numpy(b.finalize(0)))


@pytest.mark.parametrize("method", ["coordinate_median", "trimmed_mean",
                                    "krum", "multi_krum",
                                    "geometric_median"])
def test_reservoir_rules_are_refused_by_name(method):
    """The order-statistic rules stream into a reservoir; what the
    reservoir cannot do (fold a pre-summed wave, snapshot its draws) is
    refused naming the rule."""
    agg = StreamingAggregator(params_from_numpy(_params()), method=method)
    assert agg.defended and agg.reservoir_k == 64
    agg.reset(params_from_numpy(_params()))
    with pytest.raises(RuntimeError, match=method):
        agg.fold_wave(params_from_numpy(_params()), np.ones(1))
    with pytest.raises(RuntimeError, match=method):
        agg.state_dict()


@pytest.mark.parametrize("kind", ["params", "delta"])
def test_reservoir_matches_jax(kind):
    """Algorithm R over the JAX package's ``RandomState(seed)``: the same
    slots, bit for bit, over two rounds (with an upload offered past K),
    and the trimmed mean over them within 1e-6."""
    tmpl = _params()
    j = JStream(tmpl, method="trimmed_mean", kind=kind, reservoir_k=3,
                seed=4, trim_frac=0.2)
    t = StreamingAggregator(params_from_numpy(tmpl), method="trimmed_mean",
                            kind=kind, reservoir_k=3, seed=4, trim_frac=0.2)
    ups, ws = _uploads(7)
    for round_idx in range(2):
        j.reset(tmpl)
        t.reset(params_from_numpy(tmpl))
        for u, w in zip(ups, ws):
            j.fold(u, w)
            t.fold(params_from_numpy(u), w)
        assert t._res_weights.tobytes() == j._res_weights.tobytes()
        _assert_equal(t._res_stack, j._res_stack)
        _assert_equal(t.finalize(round_idx), j.finalize(round_idx),
                      atol=1e-6)


def test_validation_and_lifecycle_errors():
    tmpl = params_from_numpy(_params())
    with pytest.raises(ValueError, match="unknown streaming"):
        StreamingAggregator(tmpl, method="majority_vote")
    with pytest.raises(ValueError, match="kind"):
        StreamingAggregator(tmpl, kind="gradients")
    agg = StreamingAggregator(tmpl, method="mean")
    with pytest.raises(RuntimeError, match="before reset"):
        agg.fold(tmpl, 1.0)
    agg.reset(tmpl)
    with pytest.raises(RuntimeError, match="no folded uploads"):
        agg.finalize(0)
