"""The port's cross-device wave engine (``algorithms/cross_device.py``,
``device_cohort/waves.py``) against the JAX package's, mirroring
``tests/test_cross_device.py``.

Limits, per test:

* wave-chunked == single-wave: bit for bit with ``client_axis="scan"``
  (every client trains alone, so a client's arithmetic does not depend on
  the wave it sits in), dropout on; under ``vmap`` within
  ``CHUNK_VMAP_TOL``: PyTorch's CPU elementwise kernels compute the last
  partial vector of a tensor with the scalar function (sigmoid's tail
  differs by an ulp), and its reductions split across threads by the
  output's size, so an element's bits depend on the width of the
  ``[wave, ...]`` tensor it sits in (measured: <= 3.4e-8 after 2 rounds);
* the stream fold: ``fold_wave`` == per-upload folds, bit for bit;
* the samplers: both bit-equal to the JAX package's;
* port ``CrossDevice`` against JAX ``CrossDevice``, 2 rounds, from one
  init: ``atol=2e-5, rtol=2e-4``, the FedAvg oracle's limits;
* `WaveAdmission`: the same verdicts and reasons as JAX's on the same
  wave means, norms within 1e-12 relative (f64 sums over the leaves in
  another order).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.cross_device import CrossDevice as JCrossDevice
from fedml_tpu.algorithms.cross_device import (
    CrossDeviceConfig as JCrossDeviceConfig)
from fedml_tpu.core.sampling import sample_clients_jax as j_sample_jax
from fedml_tpu.data import load_data as j_load_data
from fedml_tpu.device_cohort import WaveAdmission as JWaveAdmission
from fedml_tpu.device_cohort import plan_waves as j_plan_waves
from fedml_tpu.experiments.models import create_workload as j_create_workload
from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                     CrossDeviceConfig)
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.sampling import sample_clients, sample_clients_jax
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.device_cohort import WaveAdmission, plan_waves
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.experiments.models import create_workload, sample_shape_of
from fedml_tpu_torch.parallel.cohort import client_keys
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy

CHUNK_VMAP_TOL = 1e-6
JAX_ATOL, JAX_RTOL = 2e-5, 2e-4
LOCAL_ALGS = ("sgd", "fedprox", "fednova", "scaffold")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these tests run many small ops, on which
    torch's thread pool spins when the workers of a parallel test run
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return load_data("mnist", batch_size=4, num_clients=24, seed=0)


@pytest.fixture(scope="module")
def workload(data):
    return create_workload("lr", "mnist", data.class_num,
                           sample_shape_of(data))


def _cfg(**kw):
    base = dict(comm_round=2, client_num_per_round=12, epochs=1,
                batch_size=4, wave_size=5, seed=0, frequency_of_the_test=10)
    base.update(kw)
    return CrossDeviceConfig(**base)


def _init(workload):
    return workload.init(torch.Generator().manual_seed(0))


def _run(workload, data, params=None, checkpointer=None, **kw):
    algo = CrossDevice(workload, data, _cfg(**kw), device="cpu")
    return algo.run(params=params if params is not None else _init(workload),
                    checkpointer=checkpointer)


def _bit_equal(a, b):
    return all(a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in a)


def _max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


# ---------------------------------------------------------------------------
# the fold contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_alg", ["sgd", "fedprox"])
def test_wave_chunked_bit_identical_to_single_wave_scan(workload, data,
                                                        local_alg):
    single = _run(workload, data, wave_size=12, client_axis="scan",
                  local_alg=local_alg)
    chunked = _run(workload, data, wave_size=5, client_axis="scan",
                   local_alg=local_alg)            # padded last wave
    assert _bit_equal(single, chunked)


@pytest.mark.parametrize("local_alg", LOCAL_ALGS)
def test_wave_chunked_matches_single_wave_vmap(workload, data, local_alg):
    single = _run(workload, data, wave_size=12, local_alg=local_alg)
    chunked = _run(workload, data, wave_size=5, local_alg=local_alg)
    assert _max_diff(single, chunked) <= CHUNK_VMAP_TOL


def test_dropout_cnn_chunked_bit_identical_to_single_wave():
    """CNNDropOut in train mode: the masks are keyed by the round's key,
    the global cohort slot and the step, so a wave-chunked round draws
    the single-wave round's masks and lands on its bits; another seed
    draws other masks."""
    cdata = load_data("femnist", batch_size=20, num_clients=10, seed=0)
    wl = create_workload("cnn", "femnist", cdata.class_num,
                         sample_shape_of(cdata))
    assert wl.stochastic
    p0 = _init(wl)
    kw = dict(comm_round=1, client_num_per_round=5, batch_size=20,
              lr=0.1, client_axis="scan")
    single = _run(wl, cdata, params=p0, wave_size=5, **kw)
    chunked = _run(wl, cdata, params=p0, wave_size=2, **kw)
    assert _bit_equal(single, chunked)
    other = _run(wl, cdata, params=p0, wave_size=2, seed=1, **kw)
    assert not _bit_equal(single, other)


def test_client_keys_follow_jax_fold_in_and_split_chain():
    """A client's key is ``fold_in(round_key, offset + i)`` and its step
    keys the JAX trainer's ``rng, dropout_rng = split(rng)`` chain, bit
    for bit."""
    words = prng.key_words_int32(prng.fold_in(prng.key(5), 9))
    keys = client_keys(words, 4, 7, "cpu")
    steps = prng.step_keys(keys, 3)
    rk = jax.random.wrap_key_data(np.array(
        [w & 0xFFFFFFFF for w in words], np.uint32))
    for i in range(4):
        k = jax.random.fold_in(rk, 7 + i)
        np.testing.assert_array_equal(keys[i].numpy(),
                                      np.asarray(jax.random.key_data(k)))
        for s in range(3):
            k, drop = jax.random.split(k)
            np.testing.assert_array_equal(
                steps[i, s].numpy(), np.asarray(jax.random.key_data(drop)))


def test_fold_wave_matches_per_upload_folds():
    """One fold_wave over [W, ...] == W per-upload fold() calls in slot
    order, bit for bit, weight-0 slots included (clip on)."""
    rng = np.random.RandomState(0)
    tmpl = {"w": torch.zeros(7, 3), "b": torch.zeros(5)}
    ups = [{"w": torch.tensor(rng.standard_normal((7, 3)),
                              dtype=torch.float32),
            "b": torch.tensor(rng.standard_normal(5), dtype=torch.float32)}
           for _ in range(6)]
    weights = np.asarray([3.0, 1.0, 0.0, 2.0, 0.0, 5.0], np.float32)
    a = StreamingAggregator(tmpl, method="mean", norm_clip=0.5)
    a.reset(tmpl)
    for u, w in zip(ups, weights):
        if w > 0:
            a.fold(u, np.float32(w))
    b = StreamingAggregator(tmpl, method="mean", norm_clip=0.5)
    b.reset(tmpl)
    b.fold_wave({k: torch.stack([u[k] for u in ups]) for k in tmpl},
                weights)
    assert b.count == 4 == a.count
    assert a.weight_total == b.weight_total
    assert _bit_equal(a.finalize(0), b.finalize(0))


def test_fold_wave_chunk_boundaries_are_invisible():
    rng = np.random.RandomState(1)
    tmpl = {"k": torch.zeros(11)}
    stacked = torch.tensor(rng.standard_normal((8, 11)), dtype=torch.float32)
    w = np.asarray([1, 2, 3, 0, 4, 5, 0, 6], np.float32)
    one = StreamingAggregator(tmpl, method="mean")
    one.reset(tmpl)
    one.fold_wave({"k": stacked}, w)
    two = StreamingAggregator(tmpl, method="mean")
    two.reset(tmpl)
    two.fold_wave({"k": stacked[:3]}, w[:3])
    two.fold_wave({"k": stacked[3:]}, w[3:])
    assert _bit_equal(one.finalize(0), two.finalize(0))


def test_all_pad_wave_folds_as_weight_zero():
    tmpl = {"k": torch.zeros(4)}
    agg = StreamingAggregator(tmpl, method="mean")
    agg.reset(tmpl)
    agg.fold_wave({"k": torch.full((3, 4), 7.25)}, np.zeros(3, np.float32))
    assert agg.count == 0 and agg.weight_total == 0.0
    real = torch.ones(2, 4) * torch.tensor([[2.0], [4.0]])
    agg.fold_wave({"k": real}, np.asarray([1.0, 3.0], np.float32))
    out = agg.finalize(0)["k"]
    torch.testing.assert_close(out, torch.full((4,), (2.0 + 3 * 4.0) / 4.0))


def test_engine_skips_an_all_pad_wave(workload, data):
    """A wave whose live clients all hold no samples weighs 0: the engine
    skips it before admission and the round closes over the rest."""
    algo = CrossDevice(workload, data, _cfg(comm_round=1,
                                            frequency_of_the_test=1),
                       device="cpu")
    inner = algo._wave_fn
    calls = {"n": 0}

    def weightless_second(params, wave_data, words, offset):
        if calls["n"] == 1:
            wave_data = dict(wave_data,
                             num_samples=wave_data["num_samples"] * 0)
        calls["n"] += 1
        return inner(params, wave_data, words, offset)

    algo._wave_fn = weightless_second
    algo.run(params=_init(workload))
    assert algo.history[-1]["folded_waves"] == algo.history[-1]["waves"] - 1
    assert algo.admission.admitted == algo.history[-1]["waves"] - 1


def test_plan_waves_shapes():
    waves = plan_waves(np.arange(11), 4)
    assert [w.n_live for w in waves] == [4, 4, 3]
    assert [w.offset for w in waves] == [0, 4, 8]
    for ids, size in ((np.arange(11), 4), (np.arange(1000), 256),
                      (np.arange(3), 8), (np.arange(0), 4)):
        mine, ref = plan_waves(ids, size), j_plan_waves(ids, size)
        assert [(w.offset, w.ids.tolist()) for w in mine] \
            == [(w.offset, w.ids.tolist()) for w in ref]
    with pytest.raises(ValueError):
        plan_waves(np.arange(4), 0)


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(100, 10), (3400, 1000), (200, 100),
                                 (16, 6), (5, 8)])
def test_sample_clients_jax_bit_equal(n, m):
    """The engine's jax sampler key, ``fold_in(fold_in(key(seed),
    0x5A4D50), round)``, and the ids it draws equal the JAX package's."""
    for seed, r in ((0, 0), (0, 3), (7, 1)):
        key = prng.fold_in(prng.fold_in(prng.key(seed), 0x5A4D50), r)
        jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                     0x5A4D50), r)
        np.testing.assert_array_equal(
            sample_clients_jax(key, n, m),
            np.asarray(j_sample_jax(jkey, n, m)))


@pytest.mark.parametrize("sampler", ["numpy", "jax"])
def test_engine_cohorts_bit_equal_to_jax(workload, data, sampler):
    jwl = j_create_workload("lr", "mnist", data.class_num,
                            sample_shape_of(data))
    jdata = j_load_data("mnist", batch_size=4, num_clients=24, seed=0)
    mine = CrossDevice(workload, data, _cfg(sampler=sampler, seed=3),
                       device="cpu")
    ref = JCrossDevice(jwl, jdata, JCrossDeviceConfig(
        comm_round=2, client_num_per_round=12, epochs=1, batch_size=4,
        wave_size=5, seed=3, frequency_of_the_test=10, sampler=sampler))
    for r in range(5):
        np.testing.assert_array_equal(mine._sample_round(r),
                                      ref._sample_round(r))


def test_numpy_and_jax_samplers_diverge_and_are_deterministic():
    n, m = 100, 10
    np_ids = [sample_clients(r, n, m) for r in range(4)]
    jx_ids = [sample_clients_jax(prng.fold_in(prng.key(0), r), n, m)
              for r in range(4)]
    assert any(not np.array_equal(np.sort(a), np.sort(b))
               for a, b in zip(np_ids, jx_ids))
    assert all(np.array_equal(b, sample_clients_jax(
        prng.fold_in(prng.key(0), r), n, m)) for r, b in enumerate(jx_ids))


def test_sampler_choice_recorded_in_metrics(tmp_path):
    main(["--algo", "cross_device", "--model", "lr", "--dataset", "mnist",
          "--client_num_in_total", "16", "--client_num_per_round", "6",
          "--wave_size", "3", "--comm_round", "2",
          "--frequency_of_the_test", "1", "--batch_size", "4",
          "--sampler", "jax", "--run_dir", str(tmp_path), "--log_stdout",
          "false", "--platform", "cpu"])
    rows = [json.loads(line) for line in
            open(os.path.join(tmp_path, "metrics.jsonl"))]
    per_round = [r for r in rows if "sampler" in r]
    assert len(per_round) == 2
    assert all(r["sampler"] == "jax" and r["local_alg"] == "sgd"
               and r["waves"] == 2 for r in per_round)


def test_resume_rederives_same_cohorts(workload, data, tmp_path):
    """Kill after round 2 and resume: the final params equal the
    uninterrupted run's bit for bit (both samplers; scaffold's variates
    ride the checkpoint)."""
    for sampler, alg in (("numpy", "sgd"), ("jax", "sgd"),
                         ("numpy", "scaffold")):
        straight = _run(workload, data, comm_round=4, sampler=sampler,
                        local_alg=alg)
        d = str(tmp_path / f"{sampler}-{alg}")
        _run(workload, data, comm_round=2, sampler=sampler, local_alg=alg,
             checkpointer=RoundCheckpointer(d, save_every=1))
        resumed = _run(workload, data, comm_round=4, sampler=sampler,
                       local_alg=alg,
                       checkpointer=RoundCheckpointer(d, save_every=1))
        assert _bit_equal(straight, resumed), (sampler, alg)


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_alg", LOCAL_ALGS)
def test_cross_device_matches_jax_engine(data, local_alg):
    """Two rounds of the port's engine against JAX's, from one init, on
    byte-equal twins: same cohorts, waves and trainers."""
    jdata = j_load_data("mnist", batch_size=4, num_clients=24, seed=0)
    jwl = j_create_workload("lr", "mnist", jdata.class_num,
                            sample_shape_of(jdata))
    twl = create_workload("lr", "mnist", data.class_num,
                          sample_shape_of(data))
    p0 = jwl.init(jax.random.key(4), jax.tree.map(
        lambda v: v[0, 0], {k: jdata.train[k] for k in ("x", "y", "mask")}))
    kw = dict(comm_round=2, client_num_per_round=12, epochs=1, batch_size=4,
              wave_size=5, seed=0, frequency_of_the_test=10, lr=0.1,
              local_alg=local_alg, mu=0.3)
    want = JCrossDevice(jwl, jdata, JCrossDeviceConfig(**kw)).run(params=p0)
    algo = CrossDevice(twl, data, CrossDeviceConfig(**kw), device="cpu")
    got = algo.run(params=params_from_numpy(jax.tree.map(np.asarray, p0)))
    want = params_from_numpy(jax.tree.map(np.asarray, want))
    moved = _max_diff(want, params_from_numpy(jax.tree.map(np.asarray, p0)))
    assert moved > 100 * JAX_ATOL
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=JAX_ATOL, rtol=JAX_RTOL, err_msg=k)


def test_wave_admission_verdicts_match_jax():
    """The same wave means through both screens: the same verdicts and
    reasons in the same order, norms within 1e-12 relative."""
    rng = np.random.RandomState(3)
    shapes = {"Dense_0/kernel": (6, 4), "Dense_0/bias": (4,),
              "Conv_0/kernel": (3, 3, 1, 2)}
    g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def nested(flat):
        out = {}
        for k, v in flat.items():
            a, b = k.split("/")
            out.setdefault(a, {})[b] = v
        return out

    mine = WaveAdmission(g, norm_k=2.0, norm_min_history=3)
    ref = JWaveAdmission(nested(g), norm_k=2.0, norm_min_history=3)
    means = [{k: g[k] + s * rng.randn(*v.shape).astype(np.float32)
              for k, v in g.items()}
             for s in (0.1, 0.11, 0.09, 0.1, 0.105, 3.0, 0.1)]
    means.insert(2, {k: np.full_like(v, np.nan) for k, v in g.items()})
    means.insert(4, {k: v[..., :1] for k, v in g.items()})
    for rnd in range(2):
        mine.round_start()
        ref.round_start()
        for m in means:
            a, b = mine.screen(m, g), ref.screen(nested(m), nested(g))
            assert (a.ok, a.reason) == (b.ok, b.reason)
            if b.norm is not None:
                assert abs(a.norm - b.norm) <= 1e-12 * b.norm
    assert mine.rejected == ref.rejected
    assert mine.rejected["norm_outlier"] > 0
    assert mine.admitted == ref.admitted


def test_engine_rejects_a_poisoned_wave(workload, data):
    """A wave whose summary turns non-finite is discarded whole: the fold
    never sees it and the round closes over the remaining waves."""
    algo = CrossDevice(workload, data, _cfg(comm_round=1,
                                            frequency_of_the_test=1),
                       device="cpu")
    inner = algo._wave_fn
    calls = {"n": 0}

    def poison(params, wave_data, words, offset):
        stacked, w, mean, total, aux = inner(params, wave_data, words,
                                             offset)
        if calls["n"] == 1:
            mean = {k: v * float("nan") for k, v in mean.items()}
        calls["n"] += 1
        return stacked, w, mean, total, aux

    algo._wave_fn = poison
    out = algo.run(params=_init(workload))
    assert algo.admission.rejected["nonfinite"] == 1
    assert algo.history[-1]["folded_waves"] == algo.history[-1]["waves"] - 1
    assert all(bool(v.isfinite().all()) for v in out.values())


# ---------------------------------------------------------------------------
# local algorithms against the port's own algorithms
# ---------------------------------------------------------------------------

def test_local_algs_match_the_port_algorithms(workload, data):
    """fedprox / scaffold / fednova waves against the port's FedProx,
    SCAFFOLD and FedNova (mu 0) on the same seed: the same rounds summed
    in another order (1e-5)."""
    from fedml_tpu_torch.algorithms.fednova import FedNova, FedNovaConfig
    from fedml_tpu_torch.algorithms.fedprox import FedProx, FedProxConfig
    from fedml_tpu_torch.algorithms.scaffold import Scaffold, ScaffoldConfig
    common = dict(comm_round=3, client_num_per_round=12, epochs=1,
                  batch_size=4, seed=0, frequency_of_the_test=10)
    for alg, cls, cfg in (
            ("fedprox", FedProx, FedProxConfig(mu=0.1, **common)),
            ("scaffold", Scaffold, ScaffoldConfig(**common)),
            ("fednova", FedNova, FedNovaConfig(mu=0.0, **common))):
        p = _run(workload, data, comm_round=3, local_alg=alg, mu=0.1)
        q = cls(workload, data, cfg, device="cpu").run(
            params=_init(workload))
        assert _max_diff(p, q) < 1e-5, alg
        base = _run(workload, data, comm_round=3)
        assert not _bit_equal(base, p), alg


def test_server_opt_steps_the_wave_finalize(tmp_path):
    """``--server_opt adam`` on the engine: a finite run whose global
    differs from the plain engine's; with ``--local_alg fednova`` it is
    refused."""
    from fedml_tpu_torch.server_opt import ServerOptConfigError
    base = ["--algo", "cross_device", "--model", "lr", "--dataset", "mnist",
            "--client_num_in_total", "12", "--client_num_per_round", "6",
            "--wave_size", "4", "--comm_round", "2", "--batch_size", "4",
            "--platform", "cpu", "--log_stdout", "false"]
    plain = main(base)
    adam = main(base + ["--server_opt", "adam", "--server_lr", "0.01"])
    assert adam["params_finite"]
    assert adam["test_loss"] != plain["test_loss"]
    with pytest.raises(ServerOptConfigError, match="fednova"):
        main(base + ["--server_opt", "adam", "--local_alg", "fednova"])


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

_GATE_BASE = ["--model", "lr", "--dataset", "mnist", "--platform", "cpu",
              "--client_num_in_total", "8", "--comm_round", "1"]


@pytest.mark.parametrize("flags,exc,match", [
    (["--algo", "cross_device", "--secagg", "pairwise", "--agg_mode",
      "stream"], ValueError, "secagg"),
    (["--algo", "cross_device", "--edge_aggregators", "2"],
     ValueError, "transport-actor topology"),
    (["--algo", "cross_device", "--silo_backend", "grpc"], ValueError,
     "silo_backend"),
    (["--algo", "cross_device", "--robust_agg", "krum"], ValueError,
     "order-statistic"),
    (["--algo", "cross_device", "--adversary", "2:scale:20"],
     ValueError, "adversary"),
    (["--algo", "cross_device", "--rounds_per_dispatch", "4"], ValueError,
     "rounds_per_dispatch"),
    (["--algo", "cross_device", "--wave_adversary", "0:0:nan"],
     ValueError, "unknown wave attack kind"),
    # the health observatory is ported; JAX's --adaptive gate instead
    (["--algo", "cross_device", "--adaptive", "true"], ValueError,
     "requires --health"),
    # the wave mesh is ported: JAX's gate on the wave size
    (["--algo", "cross_device", "--mesh_clients", "4", "--wave_size", "6"],
     ValueError, "multiple of the mesh clients axis"),
    # serving is ported: JAX's gate (cross_silo only)
    (["--algo", "cross_device", "--serve_port", "8080"],
     ValueError, "cross_silo only"),
    (["--algo", "cross_device", "--wave_size", "-2"], ValueError,
     "wave_size"),
    (["--algo", "async_fl", "--cross_device", "true"], ValueError,
     "cannot combine"),
])
def test_cross_device_config_gates(flags, exc, match):
    with pytest.raises(exc, match=match):
        main(_GATE_BASE + flags)


def test_cross_device_shorthand_selects_the_engine(tmp_path):
    out = main(_GATE_BASE + ["--cross_device", "true",
                             "--client_num_per_round", "4",
                             "--log_stdout", "false"])
    assert out["local_alg"] == "sgd" and out["waves"] == 1


def test_engine_constructor_gates(workload, data, tmp_path):
    with pytest.raises(ValueError, match="local_alg"):
        CrossDevice(workload, data, _cfg(local_alg="ditto"), device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        CrossDevice(workload, data, _cfg(sampler="torch"), device="cpu")
    with pytest.raises(ValueError, match="wave_size"):
        CrossDevice(workload, data, _cfg(wave_size=-2), device="cpu")
    with pytest.raises(ValueError, match="sgd"):
        CrossDevice(workload, data,
                    _cfg(local_alg="scaffold", client_optimizer="adam"),
                    device="cpu")
    with pytest.raises(ValueError, match="client_axis"):
        CrossDevice(workload, data,
                    _cfg(local_alg="fednova", client_axis="scan"),
                    device="cpu")
    from fedml_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="multiple of the mesh"):
        CrossDevice(workload, data, _cfg(), device="cpu",
                    mesh=Mesh({"clients": 2}, device="cpu"))
    # the observability and publish seams are ported: taken, with JAX's
    # gate on a controller without the health observatory
    from fedml_tpu_torch.obs import PerfRecorder
    perf = PerfRecorder(str(tmp_path / "perf.jsonl"))
    try:
        CrossDevice(workload, data, _cfg(), device="cpu", perf=perf,
                    health=object(), slo=object(), controller=object())
    finally:
        perf.close()
    with pytest.raises(ValueError, match="requires the health"):
        CrossDevice(workload, data, _cfg(), device="cpu",
                    controller=object())
    CrossDevice(workload, data, _cfg(), device="cpu", publish=object())
    with pytest.raises(ValueError, match="fednova"):
        CrossDevice(workload, data, _cfg(local_alg="fednova"),
                    device="cpu", server_opt=object())


def test_wave_size_auto_derivation(workload, data):
    cfg = _cfg(wave_size=0, client_num_per_round=12)
    algo = CrossDevice(workload, data, cfg, device="cpu")
    assert algo.cfg.wave_size == 12 and cfg.wave_size == 0
    big = CrossDevice(workload, load_data("mnist", batch_size=4,
                                          num_clients=400, seed=0),
                      _cfg(wave_size=0, client_num_per_round=300),
                      device="cpu")
    assert big.cfg.wave_size == 256
