"""The port's learning-health observatory (``obs/health.py``) against the
JAX package.

* `HealthAccumulator` fed the same uploads writes ``health.jsonl`` lines
  bit-equal to JAX's (the ``ts`` timing field aside): exact, sketched
  (a ``sketch_coords`` cap below the model) and default, ``params`` and
  ``delta`` kinds, rejections, exclusions, staleness, edge rollups and
  the suppressed-payload path.  Uploads given as the port's flat dicts
  of tensors give the same bits as the nested numpy trees (the sketch is
  cut where the leaves live and reaches the host in one copy).
* A whole live federation (3 silos, stream mode, clip 2.0, 3 rounds)
  writes lines that agree with JAX's within 1e-5 relative (the clipped
  globals differ by a few ulps, as the cross-silo tests pin).
* `Welford`, `merge_moments` and `compact_summary` equal JAX's (exact).
"""

import json

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import cross_silo as j_cross_silo
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.obs import health as j_health
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.core.pytree import tree_keys
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.obs import health
from fedml_tpu_torch.utils.jax_params import params_from_numpy


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": (rng.randn(3, 3, 2, 4) * scale)
                     .astype(np.float32),
                     "bias": (rng.randn(4) * scale).astype(np.float32)},
            "dense": {"kernel": (rng.randn(36, 5) * scale)
                      .astype(np.float32)}}


def _flat_tensors(tree):
    flat = params_from_numpy(tree)
    return {k: flat[k].clone() for k in tree_keys(flat)}


def _strip(line):
    return json.dumps({k: v for k, v in line.items() if k != "ts"},
                      sort_keys=True)


def _feed(acc, as_tensors, kind, rounds=3):
    """One scripted sequence of rounds: admitted uploads with and without
    a screen norm, a rejection, an exclusion, staleness, an edge
    summary; the global moves each round."""
    lines = []
    conv = _flat_tensors if as_tensors else (lambda t: t)
    for r in range(rounds):
        ref = _tree(100 + r)
        acc.round_start(r, conv(ref), expected=[1, 2, 3, 4],
                        excluded=[5] if r == 1 else [])
        for silo in (1, 2, 3):
            up = _tree(10 * r + silo, scale=0.5 + silo)
            norm = 1.25 * silo if silo == 2 else None
            acc.observe_admitted(silo, conv(up), 10.0 + silo, norm=norm,
                                 staleness=(silo % 2) if kind == "delta"
                                 else None)
        acc.observe_rejected(4, "norm_outlier")
        acc.note_edge(7, {"norm": {"count": 2, "mean": 1.0, "std": 0.5,
                                   "min": 0.5, "max": 1.5}})
        lines.append(acc.round_end(r, new_global=conv(_tree(101 + r)),
                                   quorum=3))
    return lines


@pytest.mark.parametrize("kind", ["params", "delta"])
@pytest.mark.parametrize("cap", [0, 50, 1_000_000])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_lines_bit_equal_to_jax(tmp_path, kind, cap, as_tensors):
    want_acc = j_health.HealthAccumulator(
        kind=kind, sketch_coords=cap,
        ledger_path=str(tmp_path / "j.jsonl"))
    got_acc = health.HealthAccumulator(
        kind=kind, sketch_coords=cap,
        ledger_path=str(tmp_path / "t.jsonl"))
    want = _feed(want_acc, False, kind)
    got = _feed(got_acc, as_tensors, kind)
    assert [_strip(x) for x in got] == [_strip(x) for x in want]
    on_disk = [json.loads(line) for line in
               (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [_strip(x) for x in on_disk] == [_strip(x) for x in want]
    assert got_acc.per_silo() == want_acc.per_silo()
    assert got_acc.round_summary() == want_acc.round_summary()
    assert got_acc.healthz() == want_acc.healthz()


def test_sketch_is_one_prefix_copy_and_matches_jax():
    tree = _tree(5)
    for cap in (0, 7, 50, 10_000):
        want_vec, want_scale = j_health._sketch_f32(tree, cap)
        for given in (tree, _flat_tensors(tree)):
            vec, scale = health._sketch_f32(given, cap)
            assert vec.dtype == np.float32 and scale == want_scale
            assert vec.tobytes() == want_vec.tobytes()


def test_suppressed_payload_and_moments_equal_jax(tmp_path):
    want = j_health.HealthAccumulator(
        suppress_payload="secagg_pairwise_masking", alarms=False)
    got = health.HealthAccumulator(
        suppress_payload="secagg_pairwise_masking", alarms=False)
    for acc in (want, got):
        acc.round_start(0, _tree(1), expected=[1, 2])
        acc.observe_admitted(1, _tree(2), 4.0)
    assert _strip(got.round_end(0, new_global=_tree(3))) == \
        _strip(want.round_end(0, new_global=_tree(3)))
    summaries = [{"count": 3, "mean": 1.5, "std": 0.25, "min": 1.0,
                  "max": 2.0}, {"count": 0}, None,
                 {"count": 2, "mean": -0.5, "std": 1.0, "min": -1.5,
                  "max": 0.5}]
    assert health.merge_moments(summaries) == \
        j_health.merge_moments(summaries)
    w_t, w_j = health.Welford(), j_health.Welford()
    for x in (3.0, -1.0, 2.5, 1e-3):
        w_t.push(x)
        w_j.push(x)
    assert w_t.summary() == w_j.summary()
    assert health.HEALTH_SLOS == j_health.HEALTH_SLOS
    assert health.ALARMS == j_health.ALARMS
    with pytest.raises(ValueError, match="unknown health thresholds"):
        health.HealthAccumulator(thresholds={"norm_cv": 1.0})


def _update(silo, round_idx, v):
    rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
    return (np.asarray(v) + rng.randn(*np.shape(v)).astype(np.float32)
            * 0.1).astype(np.float32)


def test_federation_lines_agree_with_jax(tmp_path):
    rounds, n = 3, 3
    init = _tree(3)
    j_acc = j_health.HealthAccumulator(kind="params")
    hub = JHub(codec_roundtrip=True)
    server = j_cross_silo.FedAvgServerActor(
        hub.transport(0), init, n, n, rounds, health=j_acc,
        stream_agg=JStream(init, method="mean", norm_clip=2.0))
    silos = [j_cross_silo.FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r, i=i: (jax.tree.map(lambda v: _update(i, r, v), p),
                              10 + i)) for i in range(1, n + 1)]
    j_lines = _drive(hub, server, silos, j_acc)

    t_acc = health.HealthAccumulator(kind="params")
    hub = LocalHub(codec_roundtrip=True)
    flat = params_from_numpy(init)
    server = FedAvgServerActor(
        hub.transport(0), flat, n, n, rounds, health=t_acc,
        stream_agg=StreamingAggregator(flat, method="mean", norm_clip=2.0))
    silos = [FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r, i=i: ({k: _update(i, r, p[k])
                               for k in tree_keys(p)}, 10 + i))
        for i in range(1, n + 1)]
    t_lines = _drive(hub, server, silos, t_acc)
    assert len(t_lines) == len(j_lines) == rounds
    for g, w in zip(t_lines, j_lines):
        _assert_close(g, w)


def _drive(hub, server, silos, acc):
    lines = []
    real = acc.round_end

    def keep(*a, **k):
        lines.append(real(*a, **k))
        return lines[-1]

    acc.round_end = keep
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    server.finish()
    return lines


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "ts":
                _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                   err_msg=path)
    else:
        assert got == want, path
