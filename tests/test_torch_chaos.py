"""The port's seeded chaos (``comm/chaos.py``) against the JAX package:

* the same `ChaosPlan` seed makes the same fault decisions in both
  packages over the same message sequence: equal delivered sequences
  (corrupted payloads byte for byte) and equal fault counts;
* partitions (round windows and wall-clock windows) and immune types,
  message by message against the JAX package's `Partition`;
* the drop-policy federation behind chaotic links (drops, delays,
  duplicates, reorders, a wall-clock partition, death partitions) closes
  every round, and its global equals the replay of the server's own drop
  log (after ``tests/test_chaos.py:93-161``), ``rtol=1e-5`` as there;
* the runner's threaded drive under ``--chaos_*`` with heartbeats.
"""

import threading

import numpy as np
import pytest

from fedml_tpu.comm import chaos as jchaos
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.comm.transport import Transport as JTransport
from fedml_tpu_torch.algorithms.cross_silo import (FailureDetector,
                                                   FedAvgClientActor,
                                                   FedAvgServerActor,
                                                   MsgType)
from fedml_tpu_torch.comm.chaos import (ChaosPlan, ChaosTransport, LinkChaos,
                                        Partition)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
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


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.got = []

        def send_message(self, msg):
            tree = msg.get(Message.ARG_MODEL_PARAMS)
            self.got.append((msg.type, msg.sender_id, msg.receiver_id,
                             msg.get("v"),
                             None if tree is None else
                             {k: np.asarray(a).tobytes()
                              for k, a in sorted(tree.items())}))

        def run(self):
            pass

        def stop(self):
            pass
    return Recorder()


def _messages(cls, n=300):
    rng = np.random.RandomState(11)
    out = []
    for i in range(n):
        src, dst = (0, 1 + i % 3) if i % 2 else (1 + i % 3, 0)
        msg = cls(MsgType.C2S_MODEL if src else MsgType.S2C_SYNC, src, dst)
        msg.add("v", i)
        msg.add(Message.ARG_ROUND, i // 30)
        if i % 3:
            msg.add(Message.ARG_MODEL_PARAMS,
                    {"w": rng.randn(4, 5).astype(np.float32),
                     "n": np.arange(6, dtype=np.int32)})
        out.append(msg)
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_same_seed_same_decisions_as_the_jax_package(seed):
    """Drop, duplicate, reorder and corrupt (delays and the reorder flush
    timer are wall-clock: the delay probability is 0 and the flush bound
    long, so the held messages leave on the next send or at stop)."""
    link = dict(drop_prob=0.15, dup_prob=0.1, reorder_prob=0.1,
                corrupt_prob=0.2, max_delay_s=30.0)
    ours_in, theirs_in = _recorder(Transport), _recorder(JTransport)
    ours = ChaosTransport(ours_in, ChaosPlan(
        seed=seed, default=LinkChaos(**link),
        immune_types=(MsgType.S2C_FINISH,)))
    theirs = jchaos.ChaosTransport(theirs_in, jchaos.ChaosPlan(
        seed=seed, default=jchaos.LinkChaos(**link),
        immune_types=(MsgType.S2C_FINISH,)))
    for a, b in zip(_messages(Message), _messages(JMessage)):
        ours.send_message(a)
        theirs.send_message(b)
    ours.send_message(Message(MsgType.S2C_FINISH, 0, 1).add("v", -1))
    theirs.send_message(JMessage(MsgType.S2C_FINISH, 0, 1).add("v", -1))
    reference_timers = list(theirs._timers)
    ours.stop()
    theirs.stop()
    for t in reference_timers:   # the JAX package's stop only cancels
        t.join(timeout=1)
    assert ours.faults == theirs.faults
    assert ours_in.got == theirs_in.got
    assert all(ours.faults[k] > 0 for k in ("drop", "dup", "reorder",
                                            "corrupt"))
    assert any(m[0] == MsgType.S2C_FINISH for m in ours_in.got)  # immune


def test_partitions_and_immunity_match_the_jax_package():
    ours = Partition(after_round=2, until_round=4, window_s=(0.5, 1.0))
    theirs = jchaos.Partition(after_round=2, until_round=4,
                              window_s=(0.5, 1.0))
    for r in (None, 0, 1, 2, 3, 4, 9):
        for t in (0.0, 0.49, 0.5, 0.99, 1.0):
            a = Message(MsgType.C2S_MODEL, 1, 0)
            b = JMessage(MsgType.C2S_MODEL, 1, 0)
            if r is not None:
                a.add(Message.ARG_ROUND, r)
                b.add(Message.ARG_ROUND, r)
            assert ours.cuts(a, t) == theirs.cuts(b, t)
    assert Partition(after_round=2).cuts(
        Message(3, 1, 0).add(Message.ARG_ROUND, 7), 0.0)
    # a cut link delivers its immune types and nothing else
    rec = _recorder(Transport)
    chaos = ChaosTransport(rec, ChaosPlan(
        default=LinkChaos(partition=Partition(after_round=0)),
        immune_types=(MsgType.S2C_FINISH,)))
    chaos.send_message(Message(MsgType.C2S_MODEL, 1, 0)
                       .add(Message.ARG_ROUND, 0).add("v", 1))
    chaos.send_message(Message(MsgType.S2C_FINISH, 0, 1)
                       .add(Message.ARG_ROUND, 0).add("v", 2))
    chaos.stop()
    chaos.stop()   # idempotent
    assert [m[3] for m in rec.got] == [2]
    assert chaos.faults["partition"] == 1


def test_corruption_copies_the_frame_and_never_touches_the_original():
    from fedml_tpu_torch.comm.chaos import _corrupt_payload
    from fedml_tpu.comm.chaos import _corrupt_payload as j_corrupt
    tree = {"a": np.arange(8, dtype=np.float32),
            "b": np.arange(4, dtype=np.float32)}
    for u in [(0.1, 0.2, 0.5), (0.9, 0.7, 0.1), (0.5, 0.3, 0.99)]:
        keep = {k: v.copy() for k, v in tree.items()}
        out = _corrupt_payload(
            Message(3, 1, 0).add(Message.ARG_MODEL_PARAMS, tree), *u)
        ref = j_corrupt(
            JMessage(3, 1, 0).add(Message.ARG_MODEL_PARAMS, tree), *u)
        for k in tree:
            assert tree[k].tobytes() == keep[k].tobytes()
            assert out.get(Message.ARG_MODEL_PARAMS)[k].tobytes() == \
                ref.get(Message.ARG_MODEL_PARAMS)[k].tobytes()
        assert any(out.get(Message.ARG_MODEL_PARAMS)[k].tobytes()
                   != tree[k].tobytes() for k in tree)


# ---------------------------------------------------------------------------
# the drop-policy federation under chaos (after tests/test_chaos.py)
# ---------------------------------------------------------------------------

def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)}}


def _add_train_fn(delta):
    def fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + np.float32(delta)
                for k, v in params.items()}, 10
    return fn


def _run_federation(server, actors, timeout_s=30.0):
    threads = [threading.Thread(target=a.run, daemon=True,
                                name=f"node-{a.node_id}") for a in actors]
    for th in threads:
        th.start()
    server.register_handlers()
    server.start()
    done = threading.Event()

    def _serve():
        server.transport.run()
        done.set()

    st = threading.Thread(target=_serve, daemon=True, name="node-0")
    st.start()
    ok = done.wait(timeout_s)
    if not ok:
        server.finish()
    for a in actors:
        a.finish()
    for th in threads + [st]:
        th.join(timeout=5)
    assert ok, "server wedged: FINISH never reached"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_drop_policy_matches_the_drop_log_replay(seed):
    """4 silos behind chaotic links (silo 1 immortal, as in the JAX
    test): every round closes under the drop policy, nothing aborts, and
    the global ends at init + the sum of each round's survivor mean."""
    rng = np.random.RandomState(1000 + seed)
    n_silos, n_rounds = 4, 4
    hub = LocalHub()
    init = _np_params(seed)
    deaths = {}
    for silo in rng.choice(np.arange(2, n_silos + 1), size=2, replace=False):
        if rng.rand() < 0.7:
            deaths[int(silo)] = int(rng.randint(0, n_rounds))
    windows = {2: (0.18, 0.45)}
    completed = []
    down = LinkChaos(drop_prob=0.08, delay_prob=0.2, max_delay_s=0.05,
                     dup_prob=0.08)
    server = FedAvgServerActor(
        ChaosTransport(hub.transport(0), ChaosPlan(
            seed=seed * 31 + 7, links={(0, s): down
                                       for s in range(2, n_silos + 1)},
            immune_types=(MsgType.S2C_FINISH,))),
        params_from_numpy(init), client_num_in_total=n_silos,
        client_num_per_round=n_silos, num_rounds=n_rounds,
        on_round_done=lambda r, p: completed.append(r),
        straggler_policy="drop", round_timeout_s=0.25, min_silo_frac=0.2,
        failure_detector=FailureDetector(suspect_after_s=0.3,
                                         dead_after_s=0.6))
    transports = {1: hub.transport(1)}
    for i in range(2, n_silos + 1):
        part = (Partition(after_round=deaths.get(i), window_s=windows.get(i))
                if i in deaths or i in windows else None)
        transports[i] = ChaosTransport(hub.transport(i), ChaosPlan(
            seed=seed * 977 + i,
            links={(i, 0): LinkChaos(drop_prob=0.12, delay_prob=0.3,
                                     max_delay_s=0.07, dup_prob=0.1,
                                     reorder_prob=0.1, partition=part)},
            immune_types=(MsgType.S2C_FINISH,)))
    actors = [FedAvgClientActor(i, transports[i], _add_train_fn(float(i)),
                                heartbeat_interval_s=0.04)
              for i in range(1, n_silos + 1)]
    _run_federation(server, actors)
    assert not server.aborted
    assert server.round_idx == n_rounds
    assert completed == list(range(n_rounds))
    assert sum(sum(t.faults.values()) for t in transports.values()
               if isinstance(t, ChaosTransport)) > 0
    expected = np.asarray(init["dense"]["kernel"], np.float64)
    for r in range(n_rounds):
        dropped = set(server.dropped_silos.get(r, []))
        survivors = [i for i in range(1, n_silos + 1) if i not in dropped]
        assert survivors
        expected = expected + np.mean([float(i) for i in survivors])
    for silo, death in deaths.items():
        for r in range(death, n_rounds):
            assert silo in server.dropped_silos.get(r, [])
    np.testing.assert_allclose(
        server.params["dense/kernel"].numpy().astype(np.float64), expected,
        rtol=1e-5)


def test_runner_threaded_drive_under_chaos(tmp_path):
    """``--chaos_*`` takes the threaded drive (heartbeats on): every round
    closes, faults were injected, the global is finite, and no actor or
    heartbeat thread survives the run."""
    from fedml_tpu_torch.experiments import main as t_main
    from fedml_tpu_torch.experiments.config import config_from_argv
    cfg = config_from_argv([
        "--algo", "cross_silo", "--model", "lr", "--dataset", "mnist",
        "--client_num_in_total", "8", "--client_num_per_round", "4",
        "--batch_size", "4", "--comm_round", "3", "--platform", "cpu",
        "--agg_mode", "stream", "--norm_clip", "5.0",
        "--chaos_drop", "0.1", "--chaos_dup", "0.1", "--chaos_reorder",
        "0.1", "--chaos_delay", "0.1", "--chaos_corrupt", "0.05",
        "--straggler_policy", "drop", "--round_timeout_s", "0.5",
        "--min_silo_frac", "0.25", "--heartbeat_s", "0.05",
        "--dead_after_s", "5", "--log_stdout", "false"])
    t_main.check_config(cfg)
    data = t_main.load_experiment_data(cfg)

    class Sink:
        def log(self, *a, **k):
            pass

    fed = t_main.CrossSiloFederation(cfg, data, Sink())
    assert fed.drive == "threaded"
    # silo 1 immortal: a round always has a report to close on
    fed.chaos_plan.links[(0, 1)] = LinkChaos()
    fed.chaos_plan.links[(1, 0)] = LinkChaos()
    out = fed.run()
    assert out["params_finite"] and fed.server.round_idx == 3
    assert not fed.server.aborted
    faults = sum(sum(s.transport.faults.values()) for s in fed.silos)
    assert faults + sum(fed.server.transport.faults.values()) > 0
    assert fed.detector is not None
