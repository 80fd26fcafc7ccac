"""The port's reliability tracker (``fedml_tpu_torch/robust/degrade.py``)
against the JAX package's, and its seams on the live actor and the CLI.

* The tracker is host Python and numpy in both packages, so under one
  scripted event sequence every deadline, verdict, ledger and state dict
  is held EQUAL (no tolerance), and a ``state_dict`` written by either
  package loads in the other and re-derives the same deadline.
* The live actor's ``degrade`` seam runs on the port's hub: a timed-out
  round closes at the quorum and books network debt (never a strike), a
  correlated miss with dead letters holds and then abandons with the
  global unchanged, the tracker's history rides the checkpoint and the
  journal (``lat_s``) across a kill, and an attacker is struck as a
  payload fault only.
* ``degrade_setup`` refuses what the JAX package's ``_degrade_setup``
  refuses, with its message.
* The wave engine's ``degrade`` seam merges the indebted clients into the
  next round's cohort as the JAX engine does (equal cohorts).
"""

import dataclasses
import threading

import numpy as np
import pytest

from fedml_tpu.experiments.config import ExperimentConfig as JConfig
from fedml_tpu.experiments.main import _degrade_setup as j_degrade_setup
from fedml_tpu.robust import degrade as jd
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor,
                                                   MsgType)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import ExperimentConfig
from fedml_tpu_torch.robust import AdmissionPipeline, TrustTracker
from fedml_tpu_torch.robust import degrade as td
from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                              Faultline)
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy
from fedml_tpu_torch.utils.journal import RoundJournal


@pytest.fixture(autouse=True)
def no_timer_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and isinstance(t, threading.Timer)]
    assert not leaked, leaked


TRACKER_KW = dict(min_quorum=0.5, adaptive_deadline=True,
                  deadline_floor_s=0.2, deadline_quantile=0.9,
                  deadline_slack=1.5, partition_frac=0.5,
                  partition_max_holds=2, min_history=2, window=8)


def _script(mod, seed):
    """One event sequence through a tracker of ``mod``; every output."""
    rng = np.random.RandomState(seed)
    t = mod.ReliabilityTracker(4, **TRACKER_KW)
    out = []
    for r in range(6):
        expected = {1, 2, 3, 4}
        t.round_start(r, expected)
        out.append(("deadline", t.deadline_s(expected, 30.0)))
        got = set()
        for silo in (1, 2, 3, 4):
            if rng.rand() < 0.8:
                t.observe_completion(silo, float(rng.exponential(2.0)))
                t.note_accept(silo)
                got.add(silo)
        if rng.rand() < 0.4:
            t.note_dead_letter("send_failed", silo=int(rng.randint(1, 5)))
        v = t.assess_timeout(r, expected, got, t.quorum_for(4),
                             detector_states={s: "suspect"
                                              for s in expected - got})
        out.append(("verdict", v.as_dict()))
        if v.action == "close":
            for silo in sorted(expected - got):
                t.note_drop(silo)
        out.append(("ledger", t.as_ledger()))
        out.append(("priority", t.priority_clients(3)))
        out.append(("suspicion", [round(t.suspicion(s, 3.0), 12)
                                  for s in (1, 2, 3, 4)]))
    t.observe_completion(2, float("nan"))     # ignored in both
    t.observe_completion(9, 1.0)              # a foreign silo: ignored
    return out, t


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_matches_jax_under_one_event_sequence(seed):
    want, jt = _script(jd, seed)
    got, tt = _script(td, seed)
    assert got == want
    js, ts = jt.state_dict(), tt.state_dict()
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k])
        assert np.asarray(js[k]).dtype == np.asarray(ts[k]).dtype


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_loads_across_packages(direction):
    _, jt = _script(jd, 5)
    _, tt = _script(td, 5)
    src, dst_mod = (jt, td) if direction == "jax_to_port" else (tt, jd)
    dst = dst_mod.ReliabilityTracker(4, **TRACKER_KW)
    dst.load_state_dict(src.state_dict())
    expected = {1, 2, 3, 4}
    assert dst.deadline_s(expected, 30.0) == src.deadline_s(expected, 30.0)
    assert dst.priority_clients() == src.priority_clients()
    assert dst.suspicion(3, 2.5) == src.suspicion(3, 2.5)
    # the NaN padding is the layout: row s-1 is silo s's history
    lat = src.state_dict()["lat"]
    assert lat.shape == (4, 8) and np.isnan(lat).any()


@pytest.mark.parametrize("seed", range(4))
def test_quantile_and_merge_priority_match_jax(seed):
    rng = np.random.RandomState(seed)
    vals = sorted(rng.rand(int(rng.randint(1, 12))).tolist())
    for q in (0.0, 0.5, 0.9, 1.0):
        assert td._quantile(vals, q) == jd._quantile(vals, q)
    sampled = rng.permutation(30)[:10].tolist()
    pri = rng.permutation(30)[:4].tolist()
    for limit in (0, 3, 10):
        assert td.merge_priority(sampled, pri, limit) == \
            jd.merge_priority(sampled, pri, limit)


def test_vocabulary_and_attribution_equal_the_jax_package():
    assert td.FaultClass.ALL == jd.FaultClass.ALL
    for reason in ("fingerprint", "nonfinite", "norm_outlier"):
        assert td.classify_admission_reason(reason) == \
            jd.classify_admission_reason(reason)
    with pytest.raises(ValueError, match="closed"):
        td.ReliabilityTracker(2).note_fault("cosmic_ray")
    with pytest.raises(ValueError, match="min_quorum"):
        td.ReliabilityTracker(2, min_quorum=1.5)


# ---------------------------------------------------------------------------
# the CLI's degrade setup: the JAX package's gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,mode", [
    (dict(min_quorum=1.5), "sync"),
    (dict(min_quorum=0.5, straggler_policy="wait"), "sync"),
    (dict(adaptive_deadline=True, round_timeout_s=0.0), "sync"),
    (dict(partition_frac=2.0), "sync"),
    (dict(min_quorum=0.8, partition_frac=0.5), "sync"),
    (dict(min_quorum=0.5), "async"),
    (dict(adaptive_deadline=True, retask_timeout_s=0.0), "async"),
])
def test_degrade_setup_refuses_as_the_jax_package(kw, mode):
    base = dict(straggler_policy="drop", round_timeout_s=5.0)
    base.update(kw)
    with pytest.raises(ValueError) as want:
        j_degrade_setup(JConfig(**base), 4, mode=mode)
    with pytest.raises(ValueError) as got:
        t_main.degrade_setup(ExperimentConfig(**base), 4, mode=mode)
    assert str(got.value) == str(want.value)


def test_degrade_setup_builds_the_tracker():
    assert t_main.degrade_setup(ExperimentConfig(), 4) is None
    t = t_main.degrade_setup(ExperimentConfig(
        straggler_policy="drop", round_timeout_s=5.0, min_quorum=0.5,
        adaptive_deadline=True, partition_frac=0.3), 4)
    assert isinstance(t, td.ReliabilityTracker) and t.quorum_for(4) == 2
    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    jnames = {f.name for f in dataclasses.fields(JConfig)}
    fields = {"min_quorum", "adaptive_deadline", "deadline_floor_s",
              "deadline_quantile", "deadline_slack", "partition_frac",
              "partition_max_holds", "retask_timeout_s"}
    assert fields <= names and fields <= jnames
    for f in fields:
        assert getattr(ExperimentConfig(), f) == getattr(JConfig(), f)


# ---------------------------------------------------------------------------
# the live actor's degrade seam
# ---------------------------------------------------------------------------

def _params(seed=3):
    rng = np.random.RandomState(seed)
    return params_from_numpy(
        {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                   "bias": rng.randn(3).astype(np.float32)}})


def _train_fn(silo):
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        return {k: np.asarray(v) + rng.randn(*np.shape(v))
                .astype(np.float32) * 0.1 for k, v in params.items()}, \
            10 + silo
    return fn


def _nan_train(params, client_idx, round_idx):
    return {k: np.full_like(np.asarray(v), np.nan)
            for k, v in params.items()}, 10


def _federation(rounds, *, n=3, live=None, degrade=None, ck=None, jr=None,
                fl=None, extra_state=None, admission=None, train=None,
                timeout_s=300.0):
    """A pump-driven stream federation; silos not in ``live`` never
    answer (their endpoint exists, no actor handles it)."""
    init = _params(3)
    hub = LocalHub(codec_roundtrip=True)
    stream = StreamingAggregator(init, method="mean", kind="params",
                                 norm_clip=1.0, seed=0)
    server = FedAvgServerActor(
        hub.transport(0), init, n, n, rounds, checkpointer=ck, journal=jr,
        faultline=fl, stream_agg=stream, degrade=degrade,
        extra_state=extra_state, admission=admission,
        straggler_policy="drop", round_timeout_s=timeout_s,
        min_silo_frac=0.5)
    live = range(1, n + 1) if live is None else live
    silos = [FedAvgClientActor(i, hub.transport(i),
                               (train or {}).get(i, _train_fn(i)))
             for i in live]
    for i in set(range(1, n + 1)) - set(live):
        hub.transport(i)
    for a in [server] + silos:
        a.register_handlers()
    return hub, server


def _drive(hub, server, rounds, max_timeouts=12):
    """Pump; whenever the barrier stalls, deliver the timeout by hand."""
    try:
        server.start()
        hub.pump()
        sent = 0
        while not server._finished and server.round_idx < rounds \
                and sent < max_timeouts:
            server.send(MsgType.ROUND_TIMEOUT, 0,
                        **{Message.ARG_ROUND: server.round_idx})
            sent += 1
            hub.pump()
    finally:
        server.finish()


def test_timed_out_round_closes_at_quorum_and_books_network_debt():
    degrade = td.ReliabilityTracker(3, min_quorum=0.6)
    adm = AdmissionPipeline({"dense": {"kernel": np.zeros((4, 3),
                                                         np.float32),
                                       "bias": np.zeros(3, np.float32)}},
                            kind="params")
    hub, server = _federation(2, live=(1, 2), degrade=degrade,
                              admission=adm)
    _drive(hub, server, 2)
    assert server.round_idx == 2
    assert server.dropped_silos == {0: [3], 1: [3]}
    assert degrade.debt(3) == 2 and degrade.debt(1) == 0
    assert degrade.priority_clients() == [3]
    led = degrade.as_ledger()
    assert led["verdict"]["action"] == "close"
    assert led["faults"]["network"] == 2 and led["faults"]["payload"] == 0
    # a deadline drop never strikes trust
    assert adm.trust.state(3, 2) != TrustTracker.QUARANTINED
    assert all(adm.trust.strike_fault_totals()[c] == 0
               for c in ("network", "unknown"))


def test_partition_holds_then_abandons_with_the_global_unchanged():
    degrade = td.ReliabilityTracker(3, min_quorum=0.3, partition_frac=0.6,
                                    partition_max_holds=2)
    hub, server = _federation(1, live=(1,), degrade=degrade)
    before = {k: v.clone() for k, v in server.params.items()}
    server.start()
    hub.pump()
    degrade.note_dead_letter("send_failed", silo=2)   # network evidence
    actions = []
    for _ in range(3):
        server.send(MsgType.ROUND_TIMEOUT, 0,
                    **{Message.ARG_ROUND: server.round_idx})
        hub.pump()
        actions.append(degrade._last_verdict.action)
    server.finish()
    assert actions == ["hold", "hold", "abandon"]
    assert server.round_idx == 1 and degrade.holds_total == 2
    assert all(np.array_equal(before[k], server.params[k]) for k in before)


def test_adaptive_deadline_arms_below_the_cap_once_warm():
    degrade = td.ReliabilityTracker(3, adaptive_deadline=True,
                                    deadline_floor_s=1e-4, min_history=1)
    arms = []
    hub, server = _federation(3, degrade=degrade)
    orig = server._timer.arm
    server._timer.arm = lambda d, f: (arms.append(d), orig(d, f))
    _drive(hub, server, 3)
    assert arms[0] == 300.0 and arms[-1] < 300.0


def test_resume_replays_the_latency_history(tmp_path):
    """The deadline's history rides the checkpoint ("degrade" extra
    state) and the journal's accept records (``lat_s``): a server killed
    mid-round resumes with every completed round on record."""
    def mk():
        return td.ReliabilityTracker(3, min_quorum=0.5,
                                     adaptive_deadline=True,
                                     deadline_floor_s=1e-4, min_history=1)
    d1 = mk()
    fl = Faultline(crashes=[CrashSpec(point="post_fold_pre_ack", hit=2,
                                      round_idx=2)])
    hub, server = _federation(
        4, degrade=d1, fl=fl,
        ck=RoundCheckpointer(str(tmp_path / "ck"), save_every=1),
        jr=RoundJournal(str(tmp_path / "j"), snapshot_every=1),
        extra_state=t_main._compose_extra_state(
            [("degrade", (d1.state_dict, d1.load_state_dict))]))
    with pytest.raises(ActorKilled):
        server.start()
        hub.pump()
    server.finish()
    d2 = mk()
    hub, resumed = _federation(
        4, degrade=d2,
        ck=RoundCheckpointer(str(tmp_path / "ck"), save_every=1),
        jr=RoundJournal(str(tmp_path / "j"), snapshot_every=1),
        extra_state=t_main._compose_extra_state(
            [("degrade", (d2.state_dict, d2.load_state_dict))]))
    _drive(hub, resumed, 4)
    assert resumed.round_idx == 4
    for silo in (1, 2, 3):
        assert len(d2._lat[silo]) == 4


def test_attacker_strikes_payload_only():
    degrade = td.ReliabilityTracker(3, min_quorum=0.5, partition_frac=0.4)
    adm = AdmissionPipeline({"dense": {"kernel": np.zeros((4, 3),
                                                         np.float32),
                                       "bias": np.zeros(3, np.float32)}},
                            kind="params",
                            trust=TrustTracker(strikes_to_quarantine=1))
    hub, server = _federation(2, degrade=degrade, admission=adm,
                              train={3: _nan_train})
    _drive(hub, server, 2)
    sft = adm.trust.strike_fault_totals()
    assert sft["payload"] >= 1 and sft["network"] == sft["unknown"] == 0
    assert degrade._fault_counts["payload"] >= 1
    assert all(bool(v.isfinite().all()) for v in server.params.values())


def test_actor_refuses_an_uncapped_adaptive_deadline():
    with pytest.raises(ValueError, match="round_timeout_s"):
        FedAvgServerActor(LocalHub().transport(0), _params(), 2, 2, 1,
                          degrade=td.ReliabilityTracker(
                              2, adaptive_deadline=True))


# ---------------------------------------------------------------------------
# the cross-device engine's degrade seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["numpy", "jax"])
def test_wave_engine_merges_the_indebted_clients_as_jax(sampler):
    """Clients carrying debt (keyed client id + 1) claim the head of the
    next round's sample, the rest as the seeded sampler drew it — the
    same cohort as the JAX engine's; a round through the engine repays
    the debt and rides the checkpoint's extra state."""
    from fedml_tpu.algorithms.cross_device import CrossDevice as JCD
    from fedml_tpu.algorithms.cross_device import (
        CrossDeviceConfig as JCDConfig)
    from fedml_tpu.data import load_data as j_load
    from fedml_tpu.experiments.models import create_workload as j_create
    from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                         CrossDeviceConfig)
    from fedml_tpu_torch.data import load_data
    from fedml_tpu_torch.experiments.models import (create_workload,
                                                    sample_shape_of)
    kw = dict(comm_round=2, client_num_per_round=6, epochs=1, batch_size=4,
              wave_size=3, seed=0, frequency_of_the_test=10,
              sampler=sampler)
    data = load_data("mnist", batch_size=4, num_clients=20, seed=0)
    jdata = j_load("mnist", batch_size=4, num_clients=20, seed=0)
    wl = create_workload("lr", "mnist", data.class_num,
                         sample_shape_of(data))
    jwl = j_create("lr", "mnist", jdata.class_num,
                   tuple(jdata.train["x"].shape[3:]))
    trackers = []
    for mod in (td, jd):
        t = mod.ReliabilityTracker(20)
        for cid in (17, 3, 11):            # dropped: debt on cid + 1
            t.note_drop(cid + 1)
        t.note_drop(4)
        trackers.append(t)
    algo = CrossDevice(wl, data, CrossDeviceConfig(**kw), device="cpu",
                       degrade=trackers[0])
    jalgo = JCD(jwl, jdata, JCDConfig(**kw), degrade=trackers[1])
    got, want = algo._sample_round(1), jalgo._sample_round(1)
    assert list(got) == list(want)
    # silo 4 (client 3) carries two drops, then clients 11 and 17
    assert [int(c) for c in got[:3]] == [3, 11, 17]
    params = algo.run()
    assert all(bool(v.isfinite().all()) for v in params.values())
    assert trackers[0].max_debt() == 0       # every merged client completed
    assert "degrade" in algo._extra_state()
