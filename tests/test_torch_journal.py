"""The port's round journal (``utils/journal.py``), faultline
(``robust/faultline.py``) and the server's crash-consistent round against
the JAX package.

* the `RoundJournal` unit contract, case for case with
  ``tests/test_crash_recovery.py::TestJournalUnit``;
* kill → resume at the crash points of ``_FAST_POINTS`` on the stream
  mean and on the sharded spine (S = 2, the plain K2 on the CPU): the
  resumed global bit-equal to the uncrashed one; the uncrashed clipped
  stream federation within ``atol=1e-5`` of the JAX package's (the clip
  scale's sum of squares runs in another order in XLA);
* the publish point, the stale-round and crc-mismatch abandons, reservoir
  rounds abort-only, trust persistence, the config gates;
* the files are one format: a journal and its snapshot written by the JAX
  server recover in the port with equal records and fold state, and the
  reverse; an unclipped round killed in the JAX server resumes in the
  port's and ends bit-equal to the JAX package's uncrashed run.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.robust import faultline as jfl
from fedml_tpu.utils import journal as jjournal
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.core.pytree import tree_keys
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.robust.faultline import (CRASH_POINTS, ActorKilled,
                                              CrashSpec, DiskFaultInjector,
                                              DiskFaultSpec, Faultline,
                                              kill_actor)
from fedml_tpu_torch.shard_spine import build_shard_spine
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy
from fedml_tpu_torch.utils.journal import RoundJournal, tree_crc


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def _np_params(seed=3):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)}}


def _wide_params(seed=3):
    """Wide enough for a 2-shard plan at ``min_split_elems=64``."""
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)}}


def _t_train_fn(silo):
    """Deterministic in (silo, round): a re-tasked silo re-trains the bytes
    the crash lost.  The JAX test's update, leaf by leaf in JAX's order."""
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        return {k: np.asarray(params[k])
                + rng.randn(*np.shape(params[k])).astype(np.float32) * 0.1
                for k in tree_keys(params)}, 10 + silo
    return fn


def _j_train_fn(silo):
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        return jax.tree.map(
            lambda v: v + rng.randn(*np.shape(v)).astype(np.float32) * 0.1,
            params), 10 + silo
    return fn


def _run_stream(init, rounds, ck=None, jr=None, fl=None, n=3, method="mean",
                admission=None, extra_state=None, train_fn=_t_train_fn,
                norm_clip=1.0, sharded=False):
    """One pump-mode port federation over ``init`` (numpy, nested).  A
    killed server raises `ActorKilled`; its timers are reaped first."""
    hub = LocalHub(codec_roundtrip=True)
    flat = params_from_numpy(init)
    spine = None
    if sharded:
        spine = build_shard_spine(flat, num_shards=2, norm_clip=norm_clip,
                                  fused="on", min_split_elems=64)
        stream = spine.agg
    else:
        stream = StreamingAggregator(flat, method=method, kind="params",
                                     norm_clip=norm_clip, seed=0,
                                     reservoir_k=8)
    server = FedAvgServerActor(
        hub.transport(0), flat, n, n, rounds, checkpointer=ck,
        stream_agg=stream, shard_wire=spine, journal=jr, faultline=fl,
        admission=admission, extra_state=extra_state)
    silos = [FedAvgClientActor(i, hub.transport(i), train_fn(i))
             for i in range(1, n + 1)]
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    try:
        server.start()
        hub.pump()
    except ActorKilled:
        kill_actor(server)
        raise
    return server


def _j_run_stream(init, rounds, jr=None, fl=None, n=3, norm_clip=1.0):
    hub = JHub(codec_roundtrip=True)
    stream = JStream(init, method="mean", kind="params",
                     norm_clip=norm_clip, seed=0, reservoir_k=8)
    server = jcs.FedAvgServerActor(hub.transport(0), init, n, n, rounds,
                                   stream_agg=stream, journal=jr,
                                   faultline=fl)
    silos = [jcs.FedAvgClientActor(i, hub.transport(i), _j_train_fn(i))
             for i in range(1, n + 1)]
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    try:
        server.start()
        hub.pump()
    except jfl.ActorKilled:
        jfl.kill_actor(server)
        raise
    return server


def _bits(flat):
    return {k: v.numpy().tobytes() for k, v in flat.items()}


def _jax_flat(tree):
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree)).items()}


# ---------------------------------------------------------------------------
# the journal unit contract
# ---------------------------------------------------------------------------

def _agg():
    init = params_from_numpy(_np_params())
    agg = StreamingAggregator(init, method="mean", kind="params")
    agg.reset(init)
    return agg


def _upd(seed):
    return params_from_numpy(_np_params(seed))


class TestJournalUnit:
    def test_round_end_closes_recovery(self, tmp_path):
        j = RoundJournal(str(tmp_path / "j"))
        j.round_start(0, global_crc=123)
        j.note_accept(0, 1, 10.0, folded=False, reason="rejected")
        j.round_end(0)
        assert RoundJournal(str(tmp_path / "j")).recover() is None

    def test_open_round_recovers_with_snapshot_prefix(self, tmp_path):
        j = RoundJournal(str(tmp_path / "j"), snapshot_every=2)
        agg = _agg()
        j.round_start(1, global_crc=7)
        for silo in (1, 2, 3):
            agg.fold(_upd(silo), 10.0 * silo)
            j.note_accept(1, silo, 10.0 * silo, state_fn=agg.state_dict)
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec is not None and rec.round_idx == 1 and rec.resumable
        assert [s for s, _, _ in rec.folded] == [1, 2]
        assert rec.state["count"] == 2
        assert float(rec.state["wsum"]) == pytest.approx(30.0)
        assert rec.state["wsum"].dtype == np.float32
        assert all(a.dtype == np.float32 for a in rec.state["acc"])
        assert len(rec.accepts) == 3

    def test_round_start_bounds_the_file(self, tmp_path):
        j = RoundJournal(str(tmp_path / "j"))
        for r in range(5):
            j.round_start(r)
            j.note_accept(r, 1, 1.0, folded=False, reason="rejected")
            j.round_end(r)
        j.round_start(5)
        records = j.read_records()
        assert [rec["kind"] for rec in records] == ["round_start"]
        assert records[0]["round"] == 5

    def test_torn_tail_tolerated_malformed_midfile_loud(self, tmp_path):
        j = RoundJournal(str(tmp_path / "j"))
        j.round_start(0)
        j.note_accept(0, 1, 1.0, folded=False, reason="rejected")
        with open(j.records_path, "a") as f:
            f.write('{"kind": "accept", "round":')  # torn tail
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec is not None and rec.round_idx == 0
        lines = open(j.records_path).read().splitlines()
        lines[0] = "garbage{{{"
        with open(j.records_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match="malformed mid-file"):
            RoundJournal(str(tmp_path / "j")).recover()

    def test_snapshot_atomic_under_injected_fault(self, tmp_path):
        j = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        agg = _agg()
        j.round_start(0, global_crc=1)
        agg.fold(_upd(1), 10.0)
        j.note_accept(0, 1, 10.0, state_fn=agg.state_dict)
        assert set(j.last_snapshot_ms) == {"state_ms", "encode_ms",
                                           "write_ms", "fsync_ms", "bytes"}
        inj = DiskFaultInjector(
            [DiskFaultSpec(channel="journal_snapshot", hit=1)]).install()
        try:
            agg.fold(_upd(2), 20.0)
            j.note_accept(0, 2, 20.0, state_fn=agg.state_dict)
        finally:
            inj.remove()
        assert inj.injected == 1
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert [s for s, _, _ in rec.folded] == [1]
        assert rec.state["count"] == 1

    def test_abandoned_attempt_snapshot_never_restored(self, tmp_path):
        agg = _agg()
        j = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        j.round_start(1, global_crc=111)
        agg.fold(_upd(1), 10.0)
        j.note_accept(1, 1, 10.0, state_fn=agg.state_dict)
        assert os.path.exists(j.snapshot_path)
        RoundJournal(str(tmp_path / "j")).round_start(1, global_crc=222)
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec is not None and rec.round_idx == 1
        assert rec.state is None and rec.folded == []

    def test_resumed_round_keeps_snapshotting(self, tmp_path):
        agg = _agg()
        j = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        j.round_start(2, global_crc=9)
        agg.fold(_upd(1), 10.0)
        j.note_accept(2, 1, 10.0, state_fn=agg.state_dict)
        j2 = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        rec = j2.recover()
        agg2 = _agg()
        agg2.load_state_dict(rec.state)
        j2.note_resume(2, rec.folded, global_crc=rec.global_crc)
        agg2.fold(_upd(2), 20.0)
        j2.note_accept(2, 2, 20.0, state_fn=agg2.state_dict)
        rec2 = RoundJournal(str(tmp_path / "j")).recover()
        assert [s for s, _, _ in rec2.folded] == [1, 2]
        assert rec2.state["count"] == 2

    def test_crash_point_registry_is_the_jax_packages(self):
        assert CRASH_POINTS == jfl.CRASH_POINTS
        with pytest.raises(ValueError, match="unknown crash point"):
            CrashSpec(point="not_a_point")
        with pytest.raises(ValueError, match="unknown disk channel"):
            DiskFaultSpec(channel="not_a_channel")
        fl = Faultline(crashes=[CrashSpec(point="publish")])
        with pytest.raises(ValueError, match="unregistered crash point"):
            fl.maybe_crash("made_up")
        assert issubclass(ActorKilled, BaseException)
        assert not issubclass(ActorKilled, Exception)

    def test_seeded_kill_schedule_replays_the_jax_packages(self):
        def schedule(mod, seed):
            fl = mod.Faultline(kill_rate=0.3, seed=seed)
            out = []
            for i in range(50):
                try:
                    fl.maybe_crash("publish", round_idx=i)
                    out.append(False)
                except mod.ActorKilled:
                    out.append(True)
            return out
        from fedml_tpu_torch.robust import faultline as tfl
        assert schedule(tfl, 5) == schedule(jfl, 5)
        assert any(schedule(tfl, 5))
        assert schedule(tfl, 5) != schedule(tfl, 6)


# ---------------------------------------------------------------------------
# kill -> resume bit-identity
# ---------------------------------------------------------------------------

_FAST_POINTS = [("post_admission_pre_fold", 2, 1),
                ("post_fold_pre_ack", 2, 1),
                ("mid_checkpoint_write", 1, 1),
                ("barrier_close", 1, 2)]


def _crash_and_resume(tmp_path, init, point, hit, snap_every, rounds=3,
                      **kw):
    ck, jd = str(tmp_path / "ck"), str(tmp_path / "j")
    fl = Faultline(crashes=[CrashSpec(point=point, hit=hit, round_idx=1)])
    with pytest.raises(ActorKilled):
        _run_stream(init, rounds, ck=RoundCheckpointer(ck, save_every=1),
                    jr=RoundJournal(jd, snapshot_every=snap_every), fl=fl,
                    **kw)
    fl.respawn()
    jr = RoundJournal(jd, snapshot_every=snap_every)
    server = _run_stream(init, rounds,
                         ck=RoundCheckpointer(ck, save_every=1), jr=jr, **kw)
    return server, jr


class TestCrashResume:
    @pytest.fixture(scope="class")
    def reference(self):
        init = _np_params(3)
        server = _run_stream(init, 3)
        assert server.round_idx == 3
        return init, server.params

    @pytest.fixture(scope="class")
    def sharded_reference(self):
        init = _wide_params(3)
        server = _run_stream(init, 3, sharded=True)
        return init, server.params

    def test_uncrashed_stream_matches_the_jax_package(self, reference):
        init, want = reference
        jserver = _j_run_stream(init, 3)
        got = {k: v.numpy() for k, v in want.items()}
        for k, v in _jax_flat(jserver.params).items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("point,hit,snap_every", _FAST_POINTS)
    def test_killed_then_resumed_global_bit_identical(
            self, tmp_path, reference, point, hit, snap_every):
        init, want = reference
        resumed, _ = _crash_and_resume(tmp_path, init, point, hit,
                                       snap_every)
        assert resumed.round_idx == 3
        assert _bits(resumed.params) == _bits(want)

    @pytest.mark.parametrize("point,hit,snap_every", _FAST_POINTS)
    def test_sharded_spine_resume_bit_identical(
            self, tmp_path, sharded_reference, point, hit, snap_every):
        """The sharded fold state (4 pieces a shard) through the snapshot
        and back, and the resumed round's plain K2 finalize."""
        init, want = sharded_reference
        resumed, jr = _crash_and_resume(tmp_path, init, point, hit,
                                        snap_every, sharded=True)
        assert resumed.round_idx == 3
        assert _bits(resumed.params) == _bits(want)
        if point.startswith("post_"):
            kinds = [r["kind"] for r in jr.read_records()]
            assert kinds[-1] == "round_end"

    def test_publish_point_resumes_next_round(self, tmp_path, reference):
        init, want = reference
        fl = Faultline(crashes=[CrashSpec(point="publish", round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")),
                        jr=RoundJournal(str(tmp_path / "j"),
                                        snapshot_every=1), fl=fl)
        assert RoundJournal(str(tmp_path / "j")).recover() is None
        resumed = _run_stream(
            init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")),
            jr=RoundJournal(str(tmp_path / "j"), snapshot_every=1))
        assert _bits(resumed.params) == _bits(want)

    def test_stale_journal_round_abandoned(self, tmp_path, reference):
        init, want = reference
        fl = Faultline(crashes=[CrashSpec(point="barrier_close",
                                          round_idx=2)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck"),
                                                      save_every=2),
                        jr=RoundJournal(str(tmp_path / "j"),
                                        snapshot_every=1), fl=fl)
        jr2 = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        resumed = _run_stream(
            init, 3, ck=RoundCheckpointer(str(tmp_path / "ck"),
                                          save_every=2), jr=jr2)
        assert resumed.round_idx == 3
        assert _bits(resumed.params) == _bits(want)
        # the abandon record of round 2 was written, then round_start of
        # the re-run round 1 rewrote the file; the final round closed
        assert jr2.read_records()[-1]["kind"] == "round_end"

    def test_crc_mismatch_refuses_resume(self, tmp_path, reference, caplog):
        init, want = reference
        fl = Faultline(crashes=[CrashSpec(point="barrier_close",
                                          round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")),
                        jr=RoundJournal(str(tmp_path / "j"),
                                        snapshot_every=1), fl=fl)
        path = os.path.join(str(tmp_path / "j"), "journal.jsonl")
        lines = open(path).read().splitlines()
        start = json.loads(lines[0])
        start["global_crc"] = (start["global_crc"] + 1) % (2 ** 32)
        lines[0] = json.dumps(start, sort_keys=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        abandoned = []
        jr2 = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        real_abandon = jr2.abandon
        jr2.abandon = lambda r, why: (abandoned.append((r, why)),
                                      real_abandon(r, why))
        resumed = _run_stream(init, 3,
                              ck=RoundCheckpointer(str(tmp_path / "ck")),
                              jr=jr2)
        assert abandoned == [(1, "global crc mismatch")]
        assert resumed.round_idx == 3
        assert _bits(resumed.params) == _bits(want)

    def test_reservoir_stream_round_is_abort_only(self, tmp_path):
        init = _np_params(3)
        fl = Faultline(crashes=[CrashSpec(point="barrier_close",
                                          round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 2, ck=RoundCheckpointer(str(tmp_path / "ck")),
                        jr=RoundJournal(str(tmp_path / "j")), fl=fl,
                        method="coordinate_median", norm_clip=0.0)
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec is not None and not rec.resumable
        assert rec.mode == "stream_coordinate_median"
        assert rec.state is None
        resumed = _run_stream(
            init, 2, ck=RoundCheckpointer(str(tmp_path / "ck")),
            jr=RoundJournal(str(tmp_path / "j")),
            method="coordinate_median", norm_clip=0.0)
        assert resumed.round_idx == 2

    def test_mode_mismatch_abandons(self, tmp_path):
        """A journal written by the replicated fold is never restored into
        the sharded one: the mode tags differ, the round restarts."""
        init = _wide_params(3)
        fl = Faultline(crashes=[CrashSpec(point="post_fold_pre_ack", hit=2,
                                          round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")),
                        jr=RoundJournal(str(tmp_path / "j"),
                                        snapshot_every=1), fl=fl)
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec.mode == "stream_mean"
        jr = RoundJournal(str(tmp_path / "j"), snapshot_every=1)
        spine_server = _run_stream(init, 3, sharded=True,
                                   ck=RoundCheckpointer(str(tmp_path / "ck")),
                                   jr=jr)
        assert spine_server.round_idx == 3
        assert spine_server.shard_wire.journal_mode() == "shard_mean[S=2]"

    def test_journal_requires_fold_state(self, tmp_path):
        with pytest.raises(ValueError, match="streaming-fold"):
            FedAvgServerActor(LocalHub().transport(0),
                              params_from_numpy(_np_params()), 3, 3, 2,
                              journal=RoundJournal(str(tmp_path / "j")))


# ---------------------------------------------------------------------------
# trust persistence across a crash
# ---------------------------------------------------------------------------

class TestTrustPersistence:
    def _nan_train_fn(self, silo):
        if silo != 3:
            return _t_train_fn(silo)

        def fn(params, client_idx, round_idx):
            return {k: np.full_like(np.asarray(v), np.nan)
                    for k, v in params.items()}, 10
        return fn

    def _admission(self):
        from fedml_tpu_torch.core.pytree import nest, to_host
        from fedml_tpu_torch.robust import AdmissionPipeline, TrustTracker
        return AdmissionPipeline(
            to_host(nest(params_from_numpy(_np_params(3)))), kind="params",
            trust=TrustTracker(strikes_to_quarantine=1,
                               quarantine_rounds=4, probation_rounds=2))

    def test_quarantined_silo_stays_jailed_across_crash(self, tmp_path):
        """Silo 3 sends NaNs and is quarantined at round 0 (until round
        4); the server is killed mid-round-2 and resumed: the restored
        tracker keeps the original sentence (probation from round 4)."""
        from fedml_tpu_torch.robust import TrustTracker
        init = _np_params(3)
        adm = self._admission()
        fl = Faultline(crashes=[CrashSpec(point="post_fold_pre_ack", hit=1,
                                          round_idx=2)])
        with pytest.raises(ActorKilled):
            _run_stream(init, 5, ck=RoundCheckpointer(str(tmp_path / "ck")),
                        jr=RoundJournal(str(tmp_path / "j"),
                                        snapshot_every=1), fl=fl,
                        admission=adm,
                        extra_state=(lambda: adm.trust.state_dict(3),
                                     adm.trust.load_state_dict),
                        train_fn=self._nan_train_fn)
        assert adm.trust.state(3, 2) == TrustTracker.QUARANTINED
        adm2 = self._admission()
        resumed = _run_stream(
            init, 5, ck=RoundCheckpointer(str(tmp_path / "ck")),
            jr=RoundJournal(str(tmp_path / "j"), snapshot_every=1),
            admission=adm2,
            extra_state=(lambda: adm2.trust.state_dict(3),
                         adm2.trust.load_state_dict),
            train_fn=self._nan_train_fn)
        assert resumed.round_idx == 5
        events = list(adm2.trust.events)
        assert (4, 3) in [(r, s) for r, s, e in events if e == "probation"]
        assert any(e.startswith("quarantined") and r >= 4
                   for r, s, e in events if s == 3), events


# ---------------------------------------------------------------------------
# one file format across the packages
# ---------------------------------------------------------------------------

def _same_recovery(a, b):
    assert (a.round_idx, a.mode, a.resumable, a.global_crc) == \
        (b.round_idx, b.mode, b.resumable, b.global_crc)
    assert [(s, w) for s, w, _ in a.folded] == [(s, w) for s, w, _ in b.folded]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in a.accepts] \
        == [{k: v for k, v in r.items() if k != "ts"} for r in b.accepts]
    for key in ("count", "weight_total"):
        assert a.state[key] == b.state[key]
    assert np.asarray(a.state["wsum"]).tobytes() == \
        np.asarray(b.state["wsum"]).tobytes()
    assert len(a.state["acc"]) == len(b.state["acc"])
    for x, y in zip(a.state["acc"], b.state["acc"]):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_jax_journal_recovers_in_the_port_and_resumes(tmp_path):
    """The JAX server killed mid-round 0 (unclipped, one fold durable):
    both packages' `recover()` read the same records and fold state, and
    the port's server resumes the round from the JAX snapshot, ending bit
    for bit on the JAX package's uncrashed global."""
    init = _np_params(5)
    jd = str(tmp_path / "j")
    fl = jfl.Faultline(crashes=[jfl.CrashSpec(point="post_fold_pre_ack",
                                              hit=2, round_idx=0)])
    with pytest.raises(jfl.ActorKilled):
        _j_run_stream(init, 2, jr=jjournal.RoundJournal(jd,
                                                        snapshot_every=1),
                      fl=fl, norm_clip=0.0)
    rec_j = jjournal.RoundJournal(jd).recover()
    rec_t = RoundJournal(jd).recover()
    assert [s for s, _, _ in rec_t.folded] == [1, 2]
    _same_recovery(rec_t, rec_j)
    assert rec_t.global_crc == tree_crc(init)
    resumed = _run_stream(init, 2, jr=RoundJournal(jd, snapshot_every=1),
                          norm_clip=0.0)
    want = _j_run_stream(init, 2, norm_clip=0.0)
    assert {k: v.tobytes() for k, v in _jax_flat(want.params).items()} \
        == _bits(resumed.params)


def test_port_journal_recovers_in_the_jax_package(tmp_path):
    init = _np_params(6)
    jd = str(tmp_path / "j")
    fl = Faultline(crashes=[CrashSpec(point="post_admission_pre_fold",
                                      hit=3, round_idx=0)])
    with pytest.raises(ActorKilled):
        _run_stream(init, 2, jr=RoundJournal(jd, snapshot_every=1), fl=fl)
    rec_t = RoundJournal(jd).recover()
    rec_j = jjournal.RoundJournal(jd).recover()
    assert [s for s, _, _ in rec_j.folded] == [1, 2]
    _same_recovery(rec_t, rec_j)
    # the JAX fold accepts the port's state where it resumes
    agg = JStream(init, method="mean", kind="params", norm_clip=1.0)
    agg.reset(init)
    agg.load_state_dict(rec_j.state)
    assert agg.count == 2


# ---------------------------------------------------------------------------
# the CLI gates (tests/test_crash_recovery.py::TestConfigGates' messages)
# ---------------------------------------------------------------------------

class TestConfigGates:
    def test_journal_requires_stream_mode(self):
        from fedml_tpu_torch.experiments.main import main
        with pytest.raises(ValueError, match="streaming-fold"):
            main(["--algo", "cross_silo", "--journal", "true",
                  "--agg_mode", "stack", "--platform", "cpu"])

    def test_journal_live_algos_only(self):
        from fedml_tpu_torch.experiments.main import main
        with pytest.raises(ValueError, match="cross_silo/async_fl"):
            main(["--algo", "fedavg", "--journal", "true",
                  "--platform", "cpu"])

    def test_snapshot_cadence_validated(self):
        from fedml_tpu_torch.experiments.main import main
        with pytest.raises(ValueError, match="journal_snapshot_every"):
            main(["--algo", "cross_silo", "--journal", "true",
                  "--agg_mode", "stream", "--journal_snapshot_every", "0",
                  "--platform", "cpu"])


# ---------------------------------------------------------------------------
# secure rounds journal abort-only (tests/test_crash_recovery.py::
# TestSecaggAbortOnly)
# ---------------------------------------------------------------------------

def _run_secagg(init, rounds, ck=None, jr=None, fl=None, n=4):
    from fedml_tpu_torch.robust import AdmissionPipeline
    from fedml_tpu_torch.secure.protocol import (SecAggClient, SecAggServer,
                                                 masked_template)
    hub = LocalHub(codec_roundtrip=True)
    server = FedAvgServerActor(
        hub.transport(0), params_from_numpy(init), n, n, rounds,
        admission=AdmissionPipeline(masked_template(init), kind="masked"),
        secagg=SecAggServer(threshold=0, clip=64.0, weight_cap=10.0),
        checkpointer=ck, journal=jr, faultline=fl)
    server.register_handlers()
    for i in range(1, n + 1):
        def tf(i=i):
            def fn(params, client_idx, round_idx):
                return {k: np.asarray(v) + 0.1 * i
                        for k, v in params.items()}, 4.0 + i
            return fn
        c = FedAvgClientActor(i, hub.transport(i), tf(),
                              secagg=SecAggClient(i))
        c.register_handlers()
    server.start()
    hub.pump()
    return server


def _j_run_secagg(init, rounds, n=4):
    from fedml_tpu.robust import AdmissionPipeline
    from fedml_tpu.secure.protocol import (SecAggClient, SecAggServer,
                                           masked_template)
    hub = JHub(codec_roundtrip=True)
    server = jcs.FedAvgServerActor(
        hub.transport(0), init, n, n, rounds,
        admission=AdmissionPipeline(masked_template(init), kind="masked"),
        secagg=SecAggServer(threshold=0, clip=64.0, weight_cap=10.0))
    server.register_handlers()
    for i in range(1, n + 1):
        def tf(i=i):
            def fn(params, client_idx, round_idx):
                return jax.tree.map(lambda v: np.asarray(v) + 0.1 * i,
                                    params), 4.0 + i
            return fn
        c = jcs.FedAvgClientActor(i, hub.transport(i), tf(),
                                  secagg=SecAggClient(i))
        c.register_handlers()
    server.start()
    hub.pump()
    return server


def _same_global(port_server, jax_params):
    return all(np.array_equal(port_server.params[k].numpy(),
                              np.asarray(jax_params[k]))
               for k in jax_params)


class TestSecaggAbortOnly:
    def test_mid_unmask_kill_aborts_to_boundary(self, tmp_path):
        """Kill mid-unmask: the journal refuses to resume (mode secagg,
        resumable False), the round restarts from the boundary with the
        global unchanged, and the re-run lands on the clean run's global
        — which is bit-equal to the JAX package's clean run (the ring sum
        is exact and the division the same)."""
        init = {"w": np.zeros(6, np.float32)}
        ref = _run_secagg(init, 2)
        assert ref.round_idx == 2
        assert _same_global(ref, _j_run_secagg(init, 2).params)
        ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
        jr = RoundJournal(str(tmp_path / "j"))
        fl = Faultline(crashes=[CrashSpec(point="mid_unmask",
                                          round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_secagg(init, 2, ck=ck, jr=jr, fl=fl)
        assert fl.kills == 1
        # the boundary checkpoint holds round 0's global: the global the
        # crashed round opened against, unchanged by it
        round0 = _run_secagg(init, 1)
        state = RoundCheckpointer(str(tmp_path / "ck")).restore()
        assert int(state["round_idx"]) == 0
        for k, v in round0.params.items():
            assert np.array_equal(np.asarray(state["params"][k]), v.numpy())
        rec = RoundJournal(str(tmp_path / "j")).recover()
        assert rec is not None and rec.mode == "secagg" \
            and not rec.resumable
        resumed = _run_secagg(
            init, 2,
            ck=RoundCheckpointer(str(tmp_path / "ck"), save_every=1),
            jr=RoundJournal(str(tmp_path / "j")))
        assert resumed.round_idx == 2
        for k in ref.params:
            assert torch_equal(resumed.params[k], ref.params[k])

    @pytest.mark.parametrize("point", ["post_admission_pre_fold",
                                       "post_fold_pre_ack",
                                       "barrier_close", "mid_unmask"])
    def test_secagg_kill_matrix_never_misaggregates(self, tmp_path, point):
        init = {"w": np.zeros(6, np.float32)}
        ref = _run_secagg(init, 2)
        ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
        jr = RoundJournal(str(tmp_path / "j"))
        fl = Faultline(crashes=[CrashSpec(point=point, round_idx=1)])
        with pytest.raises(ActorKilled):
            _run_secagg(init, 2, ck=ck, jr=jr, fl=fl)
        resumed = _run_secagg(
            init, 2,
            ck=RoundCheckpointer(str(tmp_path / "ck"), save_every=1),
            jr=RoundJournal(str(tmp_path / "j")))
        assert resumed.round_idx == 2
        for k in ref.params:
            assert torch_equal(resumed.params[k], ref.params[k])


def torch_equal(a, b):
    return np.array_equal(a.numpy(), b.numpy())
