"""The port's adversary harness (``fedml_tpu_torch/robust/adversary.py``
and ``data/edge_case.apply_pixel_trigger``) against the JAX package's.

The attacks are host numpy in both packages, so every attacked upload,
every poisoned shard and every poisoned wave summary is held BIT-EQUAL to
the JAX package's on the same numpy-seeded inputs (the port's train fns
take flat dicts; the wrapper nests them at its boundary).  On the live
path, a defended port federation with an attacker runs bit for bit
against the JAX package's (unclipped stream mean: exact sums), and the
``--adversary`` CLI wiring strikes and quarantines the attacker and keeps
a NaN bomb out of the global.
"""

import threading

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.data import edge_case as j_edge
from fedml_tpu.robust import AdmissionPipeline as JAdmission
from fedml_tpu.robust import TrustTracker as JTrust
from fedml_tpu.robust import adversary as ja
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.core.pytree import flatten_nested, nest
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.data import edge_case as t_edge
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import ExperimentConfig
from fedml_tpu_torch.robust import AdmissionPipeline, TrustTracker
from fedml_tpu_torch.robust import adversary as ta
from fedml_tpu_torch.utils.jax_params import params_from_numpy


@pytest.fixture(autouse=True)
def no_timer_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and isinstance(t, threading.Timer)]
    assert not leaked, leaked


def _nested(seed=0):
    rng = np.random.RandomState(seed)
    return {"Conv_0": {"kernel": rng.randn(3, 3, 1, 4).astype(np.float32),
                       "bias": rng.randn(4).astype(np.float32)},
            "Dense_0": {"kernel": rng.randn(8, 5).astype(np.float32),
                        "bias": rng.randn(5).astype(np.float32)}}


def _j_train(params, client_idx, round_idx):
    rng = np.random.RandomState(100 + client_idx + 7 * int(round_idx))
    return jax.tree.map(lambda v: np.asarray(v) + rng.randn(*v.shape)
                        .astype(np.float32) * 0.1, params), 12


def _t_train(params, client_idx, round_idx):
    """The same update on the port's flat dicts (leaves drawn in JAX's
    leaf order)."""
    new, n = _j_train(nest(params), client_idx, round_idx)
    return flatten_nested(new), n


@pytest.mark.parametrize("spec", [
    "2:scale:20,3:sign_flip", "4:nan_bomb", "1:inflate:1e9,2:backdoor",
    "1:gauss:0.5, 3:backdoor:7", "", "2:sign_flip:3"])
def test_spec_parses_as_the_jax_package(spec):
    assert ta.parse_adversary_spec(spec) == {
        s: ta.Attack(a.kind, a.param)
        for s, a in ja.parse_adversary_spec(spec).items()}


@pytest.mark.parametrize("spec", ["2", "x:scale", "0:scale", "2:zap",
                                  "2:scale,2:gauss", "1:2:3:4"])
def test_bad_specs_fail_with_the_jax_message(spec):
    with pytest.raises(ValueError) as want:
        ja.parse_adversary_spec(spec)
    with pytest.raises(ValueError) as got:
        ta.parse_adversary_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind,param", [
    ("sign_flip", 1.0), ("sign_flip", 3.0), ("scale", 20.0),
    ("gauss", 0.5), ("nan_bomb", 0.0), ("inflate", 1e9),
    ("backdoor", -1.0)])
def test_every_attack_is_bit_equal_to_the_jax_package(kind, param):
    glob = _nested(1)
    jfn = ja.make_malicious_train_fn(ja.Attack(kind, param), _j_train,
                                     silo=3, seed=11)
    tfn = ta.make_malicious_train_fn(ta.Attack(kind, param), _t_train,
                                     silo=3, seed=11)
    for r in range(3):
        want, wn = jfn(glob, 5, r)
        got, gn = tfn(flatten_nested(glob), 5, r)
        assert gn == wn
        want = flatten_nested(jax.tree.map(np.asarray, want))
        assert list(got) == list(want)
        for k in want:
            assert np.asarray(got[k]).dtype == want[k].dtype
            assert np.asarray(got[k]).tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("poison_frac,trigger", [(1.0, 3), (0.5, 2),
                                                 (0.0, 3)])
def test_backdoor_transform_and_trigger_are_bit_equal(poison_frac, trigger):
    rng = np.random.RandomState(4)
    shard = {"x": rng.rand(3, 5, 28, 28, 1).astype(np.float32),
             "y": rng.randint(0, 10, (3, 5)).astype(np.int32),
             "mask": (rng.rand(3, 5) > 0.2).astype(np.float32)}
    want = ja.make_backdoor_shard_transform(
        7, trigger_size=trigger, poison_frac=poison_frac, seed=2)(
            shard, 4, 1)
    got = ta.make_backdoor_shard_transform(
        7, trigger_size=trigger, poison_frac=poison_frac, seed=2)(
            shard, 4, 1)
    for k in ("x", "y", "mask"):
        assert got[k].tobytes() == want[k].tobytes() and \
            got[k].dtype == want[k].dtype
    x = rng.rand(6, 32, 32, 3).astype(np.float32)
    for a, b in zip(t_edge.apply_pixel_trigger(x, 9, trigger, 0.5),
                    j_edge.apply_pixel_trigger(x, 9, trigger, 0.5)):
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype


@pytest.mark.parametrize("kind,param", [("sign_flip", 2.0), ("scale", 50.0),
                                        ("gauss", 5.0), ("nan_bomb", 0.0)])
def test_wave_attacks_are_bit_equal_to_the_jax_package(kind, param):
    mean, glob = flatten_nested(_nested(2)), flatten_nested(_nested(3))
    want = ja.poison_wave_summary(ja.WaveAttack(3, 1, kind, param),
                                  mean, glob, seed=5)
    got = ta.poison_wave_summary(ta.WaveAttack(3, 1, kind, param),
                                 mean, glob, seed=5)
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("spec", ["3:0:scale:50", "1:0:sign_flip,2:1:gauss:5",
                                  "1:0:nan_bomb", "0:0:inflate", "-1:0:scale",
                                  "1:0:scale,1:0:gauss", "1:scale"])
def test_wave_specs_parse_or_fail_as_the_jax_package(spec):
    try:
        want = ja.parse_wave_adversary_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ta.parse_wave_adversary_spec(spec)
        assert str(got.value) == str(e)
        return
    got = ta.parse_wave_adversary_spec(spec)
    assert {k: (a.round_idx, a.wave, a.kind, a.param)
            for k, a in got.items()} == \
        {k: (a.round_idx, a.wave, a.kind, a.param) for k, a in want.items()}
    assert ta.attacked_silos({1: ta.Attack("scale", 2.0),
                              3: ta.Attack("nan_bomb", 0.0)},
                             ["nan_bomb"]) == [3]


# ---------------------------------------------------------------------------
# the live path
# ---------------------------------------------------------------------------

def _lr(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)}}


def _j_honest(params, client_idx, round_idx):
    return jax.tree.map(lambda v: np.asarray(v) + np.float32(0.01),
                        params), 10


def _t_honest(params, client_idx, round_idx):
    return {k: np.asarray(v) + np.float32(0.01)
            for k, v in params.items()}, 10


@pytest.mark.parametrize("kind,param", [("scale", 100.0),
                                        ("nan_bomb", 0.0),
                                        ("inflate", 1e9)])
def test_attacked_federation_is_bit_equal_to_the_jax_package(kind, param):
    """4 silos, silo 2 attacking, admission (quarantine after 2 strikes,
    sample cap 1000) and the unclipped stream mean, 6 rounds."""
    rounds, n = 6, 4
    jhub = JHub(codec_roundtrip=True)
    jadm = JAdmission(_lr(), norm_min_history=3, max_num_samples=1000,
                      trust=JTrust(strikes_to_quarantine=2,
                                   quarantine_rounds=10))
    jserver = jcs.FedAvgServerActor(
        jhub.transport(0), _lr(), n, n, rounds, admission=jadm,
        stream_agg=JStream(_lr(), method="mean", kind="params"))
    jsilos = [jcs.FedAvgClientActor(
        i, jhub.transport(i),
        ja.make_malicious_train_fn(ja.Attack(kind, param), _j_honest, i)
        if i == 2 else _j_honest) for i in range(1, n + 1)]
    for a in [jserver] + jsilos:
        a.register_handlers()
    jserver.start()
    jhub.pump()

    init = params_from_numpy(_lr())
    hub = LocalHub(codec_roundtrip=True)
    adm = AdmissionPipeline(_lr(), norm_min_history=3, max_num_samples=1000,
                            trust=TrustTracker(strikes_to_quarantine=2,
                                               quarantine_rounds=10))
    server = FedAvgServerActor(
        hub.transport(0), init, n, n, rounds, admission=adm,
        stream_agg=StreamingAggregator(init, method="mean", kind="params"))
    silos = [FedAvgClientActor(
        i, hub.transport(i),
        ta.make_malicious_train_fn(ta.Attack(kind, param), _t_honest, i)
        if i == 2 else _t_honest) for i in range(1, n + 1)]
    for a in [server] + silos:
        a.register_handlers()
    server.start()
    hub.pump()
    assert server.round_idx == jserver.round_idx == rounds
    want = flatten_nested(jax.tree.map(np.asarray, jserver.params))
    assert {k: v.numpy().tobytes() for k, v in server.params.items()} == \
        {k: v.tobytes() for k, v in want.items()}
    assert adm.rejected == jadm.rejected
    assert adm.trust.state(2, rounds) == jadm.trust.state(2, rounds)
    assert all(bool(v.isfinite().all()) for v in server.params.values())


def test_cli_adversary_strikes_quarantines_and_stops_the_nan():
    """``--adversary 2:scale:20,3:nan_bomb`` on the CLI's cross_silo: the
    NaN never reaches the global, silo 2 is struck and quarantined."""
    cfg = ExperimentConfig(
        algo="cross_silo", model="lr", dataset="mnist",
        client_num_in_total=12, client_num_per_round=4, batch_size=4,
        comm_round=5, agg_mode="stream", norm_clip=5.0, admission="on",
        norm_screen_min_history=2, strikes_to_quarantine=2,
        adversary="2:scale:20,3:nan_bomb", platform="cpu",
        frequency_of_the_test=100, log_stdout=False)
    t_main.check_config(cfg)
    fed = t_main.CrossSiloFederation(cfg, t_main.load_experiment_data(cfg),
                                     _Sink())
    out = fed.run()
    adm = fed.server.admission
    assert out["params_finite"]
    assert adm.rejected["nonfinite"] >= 1
    assert adm.rejected["norm_outlier"] >= 1
    assert any(2 in v for v in fed.server.dropped_silos.values())


def test_cli_adversary_names_only_deployed_silos():
    cfg = ExperimentConfig(algo="cross_silo", model="lr", dataset="mnist",
                           client_num_in_total=8, client_num_per_round=3,
                           adversary="5:scale:2", platform="cpu")
    with pytest.raises(ValueError, match="only 3 silos"):
        t_main.CrossSiloFederation(cfg, t_main.load_experiment_data(cfg),
                                   _Sink())


class _Sink:
    def log(self, row, step=None):
        pass
