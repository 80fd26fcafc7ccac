"""The port's heartbeats and `FailureDetector` (``algorithms/cross_silo.py``)
and the checkpointed cross-silo server, against the JAX package:

* the detector's states on an injected clock, step for step with the JAX
  detector on the same clock;
* the quorum shrinking around a dead silo and its rejoin (after
  ``tests/test_recovery.py::test_failure_detector_shrinks_quorum_and_rejoins``),
  the globals bit-equal to the JAX server's on the same walk;
* a checkpointed server killed after round 2 and resumed, and a resumed
  completed run (``tests/test_recovery.py:75``, ``:97``): bit-equal to the
  uninterrupted run and to the JAX package's;
* the silo heartbeat thread: beats while the actor runs, stopped and
  joined by ``finish()``.
"""

import threading
import time

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm.chaos import ChaosPlan as JPlan
from fedml_tpu.comm.chaos import ChaosTransport as JChaos
from fedml_tpu.comm.chaos import LinkChaos as JLink
from fedml_tpu.comm.chaos import Partition as JPartition
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu_torch.algorithms.cross_silo import (FailureDetector,
                                                   FedAvgClientActor,
                                                   FedAvgServerActor,
                                                   MsgType)
from fedml_tpu_torch.comm.chaos import (ChaosPlan, ChaosTransport, LinkChaos,
                                        Partition)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)}}


def _t_add(delta):
    def fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + np.float32(delta)
                for k, v in params.items()}, 10
    return fn


def _j_add(delta):
    def fn(params, client_idx, round_idx):
        return jax.tree.map(lambda v: v + np.float32(delta), params), 10
    return fn


def _bits_equal(flat, jtree):
    want = params_from_numpy(jax.tree.map(np.asarray, jtree))
    return all(flat[k].numpy().tobytes() == want[k].numpy().tobytes()
               for k in want)


def test_detector_states_on_an_injected_clock_match_the_jax_package():
    t = [0.0]
    ours = FailureDetector(suspect_after_s=0.5, dead_after_s=1.0,
                           clock=lambda: t[0])
    theirs = jcs.FailureDetector(suspect_after_s=0.5, dead_after_s=1.0,
                                 clock=lambda: t[0])
    script = [("register", 1), ("register", 2), ("tick", 0.4),
              ("beat", 1), ("tick", 0.3), ("tick", 0.4), ("beat", 1),
              ("tick", 0.2), ("beat", 2), ("tick", 1.5), ("beat", 3)]
    for op, arg in script:
        if op == "tick":
            t[0] += arg
        elif op == "register":
            ours.register(arg)
            theirs.register(arg)
        else:
            assert ours.beat(arg) == theirs.beat(arg)
        assert ours.states() == theirs.states()
        assert ours.dead_silos() == theirs.dead_silos()
    with pytest.raises(ValueError, match="dead_after_s"):
        FailureDetector(suspect_after_s=2.0, dead_after_s=1.0)


def _walk(pkg):
    """The JAX test's detector walk on one package: silo 3 is cut from
    round 1, silo 2 from round 3; the clock is injected."""
    if pkg == "torch":
        hub, det_cls, server_cls, client_cls = (
            LocalHub(), FailureDetector, FedAvgServerActor, FedAvgClientActor)
        chaos, plan, link, part, msg_cls = (ChaosTransport, ChaosPlan,
                                            LinkChaos, Partition, Message)
        init, add = params_from_numpy(_np_params(6)), _t_add
    else:
        hub, det_cls, server_cls, client_cls = (
            JHub(), jcs.FailureDetector, jcs.FedAvgServerActor,
            jcs.FedAvgClientActor)
        chaos, plan, link, part, msg_cls = (JChaos, JPlan, JLink, JPartition,
                                            JMessage)
        init, add = _np_params(6), _j_add
    t = [0.0]
    detector = det_cls(suspect_after_s=0.5, dead_after_s=1.0,
                       clock=lambda: t[0])
    completed = []
    server = server_cls(
        hub.transport(0), init, client_num_in_total=3,
        client_num_per_round=3, num_rounds=5,
        on_round_done=lambda r, p: completed.append(r),
        straggler_policy="drop", round_timeout_s=30.0, min_silo_frac=0.3,
        failure_detector=detector)
    t3 = chaos(hub.transport(3), plan(links={
        (3, 0): link(partition=part(after_round=1))}))
    t2 = chaos(hub.transport(2), plan(links={
        (2, 0): link(partition=part(after_round=3))}))
    trained = {1: [], 2: [], 3: []}

    def spy(silo):
        inner = add(float(silo))

        def fn(params, client_idx, round_idx):
            trained[silo].append(round_idx)
            return inner(params, client_idx, round_idx)
        return fn

    clients = [client_cls(1, hub.transport(1), spy(1)),
               client_cls(2, t2, spy(2)), client_cls(3, t3, spy(3))]
    server.register_handlers()
    for c in clients:
        c.register_handlers()

    def timeout(r):
        hub.route(msg_cls(MsgType.ROUND_TIMEOUT, 0, 0)
                  .add(msg_cls.ARG_ROUND, r))

    steps = []
    server.start()
    hub.pump()
    steps.append((list(completed), sorted(server._received)))
    t[0] = 1.5
    hub.route(msg_cls(MsgType.C2S_HEARTBEAT, 1, 0))
    hub.route(msg_cls(MsgType.C2S_HEARTBEAT, 2, 0))
    timeout(1)
    hub.pump()
    steps.append((list(completed), dict(server.dropped_silos),
                  detector.state(3), server.round_idx))
    t[0] = 2.0
    hub.route(msg_cls(MsgType.C2S_HEARTBEAT, 3, 0))
    hub.pump()
    steps.append((detector.state(3), trained[3][-1]))
    timeout(3)
    hub.pump()
    steps.append((list(completed), server.dropped_silos[3],
                  3 in server._expected))
    timeout(4)
    hub.pump()
    steps.append((list(completed), server.round_idx))
    server.finish()
    return steps, server.params


def test_quorum_shrinks_for_a_dead_silo_and_rejoins_as_in_jax():
    ours, params = _walk("torch")
    theirs, jparams = _walk("jax")
    assert ours == theirs
    assert ours[0] == ([0], [1, 2])
    completed, dropped, state3, round_idx = ours[1]
    assert (completed, dropped[1], dropped[2], state3, round_idx) == \
        ([0, 1, 2], [3], [3], "dead", 3)
    assert ours[2] == ("alive", 3)          # the rejoin sync reached it
    assert ours[3] == ([0, 1, 2, 3], [2, 3], True)
    assert ours[4] == ([0, 1, 2, 3, 4], 5)
    assert _bits_equal(params, jparams)


class _Crash(Exception):
    """Raised out of the round-done hook: a process killed between
    rounds, after its checkpoint."""


def _run(init, rounds, ck=None, crash_after=None):
    hub = LocalHub()
    completed = []

    def on_done(r, p):
        completed.append(r)
        if crash_after is not None and r >= crash_after:
            raise _Crash()

    server = FedAvgServerActor(
        hub.transport(0), params_from_numpy(init), client_num_in_total=3,
        client_num_per_round=3, num_rounds=rounds, on_round_done=on_done,
        checkpointer=ck)
    clients = [FedAvgClientActor(i, hub.transport(i), _t_add(float(i)))
               for i in (1, 2, 3)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    try:
        server.start()
        hub.pump()
    except _Crash:
        server._timer.cancel(join=True)
        return None, completed
    return server, completed


def _j_run(init, rounds):
    hub = JHub()
    server = jcs.FedAvgServerActor(hub.transport(0), init, 3, 3, rounds)
    clients = [jcs.FedAvgClientActor(i, hub.transport(i), _j_add(float(i)))
               for i in (1, 2, 3)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    server.start()
    hub.pump()
    return server


def test_checkpointed_server_crash_and_resume_completes(tmp_path):
    init = _np_params(3)
    straight, comp = _run(init, 5)
    assert comp == [0, 1, 2, 3, 4]
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
    _, comp1 = _run(init, 5, ck=ck, crash_after=2)
    assert comp1 == [0, 1, 2] and ck.latest_round() == 2
    resumed, comp2 = _run(init, 5,
                          ck=RoundCheckpointer(str(tmp_path / "ck")))
    assert comp2 == [3, 4], "resume must continue, not restart"
    assert resumed.round_idx == 5
    assert all(resumed.params[k].numpy().tobytes()
               == straight.params[k].numpy().tobytes()
               for k in straight.params)
    assert _bits_equal(resumed.params, _j_run(init, 5).params)
    # the ack the resumed server broadcast: every silo was accepted
    assert list(resumed._last_accepted) == [1, 2, 3]


def test_resume_of_a_completed_run_just_finishes(tmp_path):
    init = _np_params(4)
    done, comp = _run(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")))
    assert comp == [0, 1, 2]
    again, comp2 = _run(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")))
    assert comp2 == [] and again.round_idx == 3
    assert all(again.params[k].numpy().tobytes()
               == done.params[k].numpy().tobytes() for k in done.params)


def test_schema_drift_restores_untemplated(tmp_path):
    """A checkpoint saved without ``extra`` resumes under a server that
    has an ``extra_state``: restored untemplated, the missing entry warns
    and the run completes."""
    init = _np_params(2)
    _run(init, 3, ck=RoundCheckpointer(str(tmp_path / "ck")), crash_after=1)
    got = []
    hub = LocalHub()
    server = FedAvgServerActor(
        hub.transport(0), params_from_numpy(init), 3, 3, 3,
        checkpointer=RoundCheckpointer(str(tmp_path / "ck")),
        extra_state=(lambda: {"x": np.zeros(2, np.int64)}, got.append))
    clients = [FedAvgClientActor(i, hub.transport(i), _t_add(float(i)))
               for i in (1, 2, 3)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    server.start()
    hub.pump()
    assert server.round_idx == 3 and got == []


def test_silo_heartbeat_thread_beats_and_is_joined_by_finish():
    hub = LocalHub()
    beats = []

    class Sink:
        def receive_message(self, msg_type, msg):
            beats.append((msg_type, msg.sender_id))

    server_end = hub.transport(0)
    server_end.add_observer(Sink())
    silo = FedAvgClientActor(1, hub.transport(1), _t_add(1.0),
                             heartbeat_interval_s=0.01)
    th = threading.Thread(target=silo.run, name="node-1", daemon=True)
    th.start()
    deadline = time.monotonic() + 5
    while len(beats) < 3 and time.monotonic() < deadline:
        hub.pump()
        time.sleep(0.01)
    silo.finish()
    th.join(timeout=5)
    assert not th.is_alive()
    assert silo._hb_thread is None
    assert len(beats) >= 3
    assert {m for m, _ in beats} == {MsgType.C2S_HEARTBEAT}
