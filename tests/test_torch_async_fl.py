"""The port's asynchronous buffered aggregation
(``fedml_tpu_torch/algorithms/async_fl.py``) against the JAX package's.

* The async runner on a small MNIST twin (LR, 4 silos, goal 2, 4
  versions) from the JAX runner's init: the hubs pump in the same order,
  so the staleness sequence is EQUAL and the global within 1e-5 (the two
  packages' local SGD round differently in the last bits) — in the host
  f64 mode, the clipped stream mode and the defended stack mode.
* The version step's arithmetic: staleness discounts, the absolute
  damping of a stale buffer, the at-most-once guard, forged and late
  uploads, the CRC dedupe of rejected frames (``_payload_crc`` equal to
  the JAX package's on the same frame), bench and probation release.
* The server-optimizer seam: ``apply_delta`` against the JAX package's
  on the same inputs (1e-6 relative: XLA may contract ``w − lr·Δ``
  into one fused multiply-add), and
  ``state_template``.
* ``goal == n_silos`` with zero staleness is one synchronous FedAvg round
  (1e-6); a kill at the last version's barrier close and a resume from
  the checkpoint and journal give the straight run's global bit for bit.
"""

import importlib
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import async_fl as j_async
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.experiments.config import ExperimentConfig as JConfig
from fedml_tpu.server_opt import ServerOptimizer as JServerOpt
from fedml_tpu_torch.algorithms import async_fl as t_async
from fedml_tpu_torch.algorithms.async_fl import AsyncFedServerActor
from fedml_tpu_torch.algorithms.cross_silo import MsgType
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import ExperimentConfig
from fedml_tpu_torch.robust import AdmissionPipeline, TrustTracker
from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                              Faultline)
from fedml_tpu_torch.server_opt import ServerOptimizer
from fedml_tpu_torch.utils.jax_params import params_from_numpy

j_main = importlib.import_module("fedml_tpu.experiments.main")


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith("ingest-fold"))]
    assert not leaked, leaked


class _Sink:
    def log(self, row, step=None):
        pass


_ARGS = dict(algo="async_fl", model="lr", dataset="mnist",
             client_num_in_total=10, client_num_per_round=4, batch_size=8,
             lr=0.1, epochs=1, async_goal=2, comm_round=4,
             frequency_of_the_test=100, log_stdout=False)


@pytest.mark.parametrize("flags", [
    dict(),
    dict(agg_mode="stream", norm_clip=5.0),
    dict(robust_agg="trimmed_mean", trim_frac=0.25),
])
def test_runner_matches_jax_run_async_fl(monkeypatch, flags):
    args = dict(_ARGS, **flags)
    jcfg = JConfig(**args, platform="cpu")
    jdata = j_main.load_experiment_data(jcfg)
    jinit, _ = j_main._silo_training_setup(jcfg, jdata,
                                           j_main._make_workload(jcfg, jdata))
    servers = []

    class Recording(j_async.AsyncFedServerActor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(j_async, "AsyncFedServerActor", Recording)
    j_main.run_async_fl(jcfg, jdata, None, _Sink())
    js = servers[0]
    want = params_from_numpy(jax.tree.map(np.asarray, js.params))

    tcfg = ExperimentConfig(**args, platform="cpu")
    t_main.check_config(tcfg)
    fed = t_main.AsyncFederation(
        tcfg, t_main.load_experiment_data(tcfg), _Sink(),
        init_params=params_from_numpy(jax.tree.map(np.asarray, jinit)))
    out = fed.run()
    ts = fed.server
    assert ts.version == js.version == 4 and out["params_finite"]
    assert list(ts.staleness_seen) == list(js.staleness_seen)
    assert max(ts.staleness_seen) > 0        # stale deltas really mixed
    moved = max(float((want[k] - torch.as_tensor(
        np.asarray(jax.tree.leaves(jinit)[i]))).abs().max())
        for i, k in enumerate(sorted(want)))
    assert moved > 1e-3
    for k in want:
        np.testing.assert_allclose(ts.params[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-5)
    assert out["mean_staleness"] == pytest.approx(
        float(np.mean(js.staleness_seen)))


def _server(alpha, n=2, goal=2, version=1, **kw):
    hub = LocalHub()
    for i in range(1, n + 1):    # sink endpoints for the task sends
        hub.transport(i)
    server = AsyncFedServerActor(
        hub.transport(0), {"w": torch.zeros(1)}, 8, n, num_versions=3,
        aggregation_goal=goal, server_lr=1.0, staleness_exponent=alpha,
        **kw)
    server.register_handlers()
    server.version = version

    def upload(sender, value, base, num_samples=10):
        m = Message(MsgType.C2S_MODEL, sender, 0)
        m.add(Message.ARG_MODEL_PARAMS, {"w": np.asarray([value],
                                                         np.float32)})
        m.add(Message.ARG_NUM_SAMPLES, num_samples)
        m.add(Message.ARG_ROUND, base)
        server._on_model(m)
    return server, upload


def test_staleness_discounts_and_absolute_damping():
    server, upload = _server(alpha=1.0)
    upload(1, 3.0, 1)      # fresh: ratio 0.5, discount 1
    upload(2, 9.0, 0)      # stale s=1: ratio 0.5, discount 0.5
    assert float(server.params["w"]) == 3.75
    assert list(server.staleness_seen) == [0, 1]
    server, upload = _server(alpha=1.0)
    upload(1, 4.0, 0)
    upload(2, 8.0, 0)      # a uniformly stale buffer is damped
    assert float(server.params["w"]) == 3.0
    server, upload = _server(alpha=1.0)
    upload(1, 4.0, 1, num_samples=30)
    upload(2, 8.0, 1, num_samples=10)
    assert float(server.params["w"]) == 5.0
    server.finish()


def test_duplicates_forged_tags_and_late_uploads_are_ignored():
    server, upload = _server(alpha=0.0, goal=2, version=1)
    upload(1, 1.0, 1)
    upload(1, 7.0, 1)                  # duplicate (silo, base): ignored
    upload(2, 5.0, 2)                  # a forged future version: rejected
    assert len(server._buffer) == 1
    upload(2, 3.0, 1)
    assert server.version == 2 and float(server.params["w"]) == 2.0
    upload(1, 9.0, 1)                  # already consumed
    assert server._buffer == []
    server.finish()


def test_rejected_frames_dedupe_by_payload_crc():
    """A duplicated rejected frame strikes once; a fresh offense from the
    same (silo, base) strikes again; the CRC is the JAX package's."""
    adm = AdmissionPipeline({"w": np.zeros(1, np.float32)}, kind="delta",
                            trust=TrustTracker(strikes_to_quarantine=10))
    server, upload = _server(alpha=0.0, admission=adm, version=0)
    upload(1, np.nan, 0)
    upload(1, np.nan, 0)               # the same frame: one strike
    assert adm.rejected["nonfinite"] == 1
    upload(1, np.inf, 0)               # a fresh offense
    assert adm.rejected["nonfinite"] == 2
    server.finish()
    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.ones(2, np.int32)}
    frame = Message(3, 1, 0).add("model_params", tree).to_bytes()
    got = t_async._payload_crc(Message.from_bytes(frame).get("model_params"))
    want = j_async._payload_crc(
        JMessage.from_bytes(frame).get("model_params"))
    assert got == want != -1


def test_quarantined_silo_is_benched_then_released_on_probation():
    adm = AdmissionPipeline({"w": np.zeros(1, np.float32)}, kind="delta",
                            trust=TrustTracker(strikes_to_quarantine=1,
                                               quarantine_rounds=1))
    server, upload = _server(alpha=0.0, n=3, goal=2, admission=adm,
                             version=0)
    upload(3, np.nan, 0)               # quarantined, benched
    assert server._benched == {3}
    assert server._effective_goal() == 2
    upload(1, 1.0, 0)
    upload(2, 1.0, 0)                  # version 0 closes
    assert server.version == 1
    upload(1, 1.0, 1)
    upload(2, 1.0, 1)                  # version 1: the sentence expired
    assert server._benched == set()
    server.finish()


@pytest.mark.parametrize("name", ["plain", "momentum", "adam", "fedac"])
def test_apply_delta_matches_the_jax_seam(name):
    rng = np.random.RandomState(0)
    tmpl = {"dense": {"kernel": rng.randn(5, 4).astype(np.float32),
                      "bias": rng.randn(4).astype(np.float32)}}
    kw = dict(lr=0.05)
    j = JServerOpt(name, tmpl, **kw)
    t = ServerOptimizer(name, params_from_numpy(tmpl), **kw)
    jp, tp = tmpl, params_from_numpy(tmpl)
    for step in range(3):
        d = {"dense": {"kernel": rng.randn(5, 4).astype(np.float32),
                       "bias": rng.randn(4).astype(np.float32)}}
        jp = j.apply_delta(jp, d, step)
        tp = t.apply_delta(tp, params_from_numpy(d), step)
    want = params_from_numpy(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert t.step_count == j.step_count == 3
    # the restore template: zero-filled, the state_dict's layout
    tt, js_ = t.state_template(), j.state_template()
    assert sorted(tt) == sorted(js_)
    state = t.state_dict()
    assert sorted(tt) == sorted(state)
    for slot in ("trace", "mu", "nu", "x"):
        if slot in tt:
            assert all(not np.any(v) for v in tt[slot].values())


_ORACLE = dict(model="lr", dataset="mnist", client_num_in_total=8,
               client_num_per_round=4, batch_size=64, epochs=1, lr=0.1,
               comm_round=1, frequency_of_the_test=1, log_stdout=False,
               platform="cpu")


def test_goal_equals_cohort_is_one_fedavg_round():
    fed = t_main.main(ExperimentConfig(algo="fedavg", **_ORACLE))
    asy = t_main.main(ExperimentConfig(algo="async_fl", async_goal=4,
                                       **_ORACLE))
    assert asy["mean_staleness"] == 0.0
    np.testing.assert_allclose(asy["train_acc"], fed["train_acc"],
                               rtol=1e-6)
    np.testing.assert_allclose(asy["train_loss"], fed["train_loss"],
                               rtol=1e-5)


def test_kill_at_the_last_barrier_close_resumes_bit_identical(tmp_path):
    def cfg(d):
        return ExperimentConfig(
            algo="async_fl", model="lr", dataset="mnist",
            client_num_in_total=10, client_num_per_round=4, batch_size=8,
            async_goal=4, comm_round=3, agg_mode="stream", norm_clip=5.0,
            server_opt="adam", server_lr=0.01, journal=True,
            journal_dir=str(d / "j"), checkpoint_dir=str(d / "ck"),
            checkpoint_every=1, frequency_of_the_test=100,
            platform="cpu", log_stdout=False)
    data = t_main.load_experiment_data(cfg(tmp_path / "a"))
    straight = t_main.AsyncFederation(cfg(tmp_path / "a"), data, _Sink())
    straight.run()
    want = {k: v.numpy().tobytes() for k, v in straight.server.params.items()}
    fl = Faultline(crashes=[CrashSpec(point="barrier_close", hit=1,
                                      round_idx=2)])
    killed = t_main.AsyncFederation(cfg(tmp_path / "b"), data, _Sink(),
                                    faultline=fl)
    with pytest.raises(ActorKilled):
        killed.run()
    assert killed.server.version == 2
    resumed = t_main.AsyncFederation(cfg(tmp_path / "b"), data, _Sink())
    resumed.run()
    assert resumed.server.version == 3
    assert {k: v.numpy().tobytes()
            for k, v in resumed.server.params.items()} == want


@pytest.mark.parametrize("flags,match", [
    (dict(wire_compression="topk"), "only applies to --algo cross_silo"),
    (dict(silo_backend="grpc"), "local hub only"),
    (dict(edge_aggregators=2), "per-silo deltas"),
    (dict(secagg="pairwise", agg_mode="stream"), "async_fl"),
    (dict(min_quorum=0.5), "no barrier"),
])
def test_async_gates(flags, match):
    cfg = ExperimentConfig(algo="async_fl", model="lr", dataset="mnist",
                           client_num_in_total=8, client_num_per_round=4,
                           platform="cpu", **flags)
    with pytest.raises(ValueError, match=match):
        t_main.check_config(cfg)
        t_main.AsyncFederation(cfg, t_main.load_experiment_data(cfg),
                               _Sink())
