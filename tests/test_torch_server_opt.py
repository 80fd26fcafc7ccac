"""The port's server-optimizer seam (``server_opt/optimizer.py``) and the
live actor's ``server_opt=`` against the JAX package — the port twin of
``tests/test_server_opt.py`` (the adaptive controller is not ported).

Tolerances: ``plain`` is bit-equal (the finalized tree itself, on the
replicated and the sharded wire); ``momentum``, ``adam`` and ``fedac``
are within ``1e-6`` relative of the JAX seam over a fixed pseudo-gradient
sequence and over live unclipped federations (whose folds are bit-equal
across the packages); the state round trip and the kill → resume are bit
for bit; every foreign snapshot is refused with the named
``ServerOptMismatchError``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.server_opt import ServerOptimizer as JServerOptimizer
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.core.pytree import tree_keys
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.experiments.main import check_config, main
from fedml_tpu_torch.robust.faultline import ActorKilled, CrashSpec, Faultline
from fedml_tpu_torch.server_opt import (SERVER_OPT_NAMES,
                                        ServerOptConfigError,
                                        ServerOptimizer,
                                        ServerOptMismatchError)
from fedml_tpu_torch.shard_spine import build_shard_spine
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy
from fedml_tpu_torch.utils.journal import RoundJournal

KW = dict(lr=0.3, momentum=0.9, fedac_gamma=0.2, fedac_alpha=2.0,
          fedac_beta=3.0)


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and isinstance(t, threading.Timer)]
    assert not leaked, leaked


def _np_params(seed=3, shape=(4, 3)):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(*shape).astype(np.float32),
                      "bias": rng.randn(shape[-1]).astype(np.float32)}}


def _deltas(template, steps, seed=7):
    rng = np.random.RandomState(seed)
    return [jax.tree.map(
        lambda v: rng.randn(*np.shape(v)).astype(np.float32) * 0.1,
        template) for _ in range(steps)]


def _finalized(w, delta_np):
    """The finalized tree whose pseudo-gradient is ``delta_np``."""
    d = params_from_numpy(delta_np)
    return {k: w[k] - d[k] for k in d}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _close_to_jax(port_flat, jax_tree, rtol=1e-6):
    for a, b in zip(jax.tree.leaves(params_to_numpy(port_flat)),
                    jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=1e-7)


class TestSeamUnit:
    def test_plain_apply_returns_finalized_itself(self):
        init = params_from_numpy(_np_params())
        fin = params_from_numpy(_np_params(seed=4))
        assert ServerOptimizer("plain", init).apply(init, fin) is fin

    @pytest.mark.parametrize("name", SERVER_OPT_NAMES)
    def test_apply_matches_the_jax_seam(self, name):
        init = _np_params()
        j = JServerOptimizer(name, init, **KW)
        t = ServerOptimizer(name, params_from_numpy(init), **KW)
        assert t.fp == j.fp       # the same hyperparameter fingerprint
        jw, tw = init, params_from_numpy(init)
        for d in _deltas(init, 3):
            fin = jax.tree.map(lambda w, x: np.asarray(w) - x, jw, d)
            jw = j.apply(jw, fin, 0)
            tw = t.apply(tw, params_from_numpy(
                jax.tree.map(np.asarray, fin)), 0)
            _close_to_jax(tw, jw)

    def test_fedac_default_knobs_collapse_to_plain_sgd(self):
        """At (alpha=1, beta=1, gamma=lr) the server fedac step is the
        plain SGD step — the parity hook with algorithms/fedac.py."""
        init = params_from_numpy(_np_params())
        fedac = ServerOptimizer("fedac", init, lr=0.3)
        w_f = w_p = init
        for d in _deltas(_np_params(), 3):
            d = params_from_numpy(d)
            w_f = fedac.apply(w_f, {k: w_f[k] - d[k] for k in d})
            w_p = {k: w_p[k] - 0.3 * d[k] for k in d}
            for k in w_f:
                torch.testing.assert_close(w_f[k], w_p[k], rtol=1e-6,
                                           atol=1e-6)

    def test_fedac_mu_derives_the_coupling_and_refuses_bad_ones(self):
        init = params_from_numpy(_np_params())
        jopt = JServerOptimizer("fedac", _np_params(), lr=0.1,
                                fedac_mu=0.5, local_steps=10)
        topt = ServerOptimizer("fedac", init, lr=0.1, fedac_mu=0.5,
                               local_steps=10)
        assert topt.coupling == jopt.coupling
        with pytest.raises(ServerOptConfigError, match="alpha >= 1"):
            ServerOptimizer("fedac", init, fedac_alpha=0.5)
        with pytest.raises(ServerOptConfigError, match="unknown"):
            ServerOptimizer("nesterov", init)


class TestStateRoundtrip:
    @pytest.mark.parametrize("name", ["momentum", "adam", "fedac"])
    def test_roundtrip_bit_exact_and_same_next_step(self, name):
        init = params_from_numpy(_np_params())
        opt = ServerOptimizer(name, init, **KW)
        w = init
        for d in _deltas(_np_params(), 2):
            w = opt.apply(w, _finalized(w, d))
        snap = opt.state_dict()
        opt2 = ServerOptimizer(name, init, **KW)
        opt2.load_state_dict(snap)
        fin = _finalized(w, _deltas(_np_params(), 1, seed=11)[0])
        assert _equal(opt.apply(w, fin), opt2.apply(w, fin))
        a, b = opt.state_dict(), opt2.state_dict()
        assert jax.tree.structure(a) == jax.tree.structure(b)
        assert all(np.array_equal(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    def test_cross_optimizer_and_hyperparameter_snapshots_refused(self):
        init = params_from_numpy(_np_params())
        snap = ServerOptimizer("momentum", init).state_dict()
        with pytest.raises(ServerOptMismatchError, match="momentum"):
            ServerOptimizer("adam", init).load_state_dict(snap)
        snap = ServerOptimizer("adam", init, lr=0.1).state_dict()
        with pytest.raises(ServerOptMismatchError, match="fingerprint"):
            ServerOptimizer("adam", init, lr=0.2).load_state_dict(snap)

    def test_sharded_roundtrip_and_layout_refusals(self):
        init = params_from_numpy(
            {"w": np.random.RandomState(0).randn(16, 16).astype(np.float32)})
        spine = build_shard_spine(init, num_shards=2, min_split_elems=64)
        opt = ServerOptimizer("adam", init, lr=0.1, plan=spine.plan)
        w = init
        for d in _deltas({"w": np.zeros((16, 16), np.float32)}, 2):
            w = opt.apply(w, _finalized(w, d))
        snap = opt.state_dict()
        assert "shard_fp" in snap
        opt2 = ServerOptimizer("adam", init, lr=0.1, plan=spine.plan)
        opt2.load_state_dict(snap)
        assert _equal(opt.state["mu"], opt2.state["mu"])
        with pytest.raises(ServerOptMismatchError, match="replicated"):
            ServerOptimizer("adam", init, lr=0.1).load_state_dict(snap)
        rsnap = ServerOptimizer("adam", init, lr=0.1).state_dict()
        with pytest.raises(ServerOptMismatchError, match="no shard-plan"):
            ServerOptimizer("adam", init, lr=0.1,
                            plan=spine.plan).load_state_dict(rsnap)


# ---------------------------------------------------------------------------
# the live actor's seam
# ---------------------------------------------------------------------------

def _t_train_fn(silo):
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


def _run_stream(init_np, rounds, n=3, server_opt=None, ck=None, jr=None,
                fl=None, spine=None, extra_state=None, norm_clip=0.0):
    init = params_from_numpy(init_np)
    hub = LocalHub(codec_roundtrip=True)
    agg = spine.agg if spine is not None else StreamingAggregator(
        init, method="mean", kind="params", norm_clip=norm_clip, seed=0)
    server = FedAvgServerActor(
        hub.transport(0), init, n, n, rounds, checkpointer=ck,
        stream_agg=agg, shard_wire=spine, journal=jr, faultline=fl,
        server_opt=server_opt, extra_state=extra_state)
    silos = [FedAvgClientActor(i, hub.transport(i), _t_train_fn(i))
             for i in range(1, n + 1)]
    for a in [server] + silos:
        a.register_handlers()
    server.start()
    hub.pump()
    return server


def _j_run_stream(init, rounds, n=3, server_opt=None):
    hub = JHub(codec_roundtrip=True)
    server = jcs.FedAvgServerActor(
        hub.transport(0), init, n, n, rounds,
        stream_agg=JStream(init, method="mean", kind="params", seed=0),
        server_opt=server_opt)
    silos = [jcs.FedAvgClientActor(i, hub.transport(i), _j_train_fn(i))
             for i in range(1, n + 1)]
    for a in [server] + silos:
        a.register_handlers()
    server.start()
    hub.pump()
    return server


class TestLive:
    def test_plain_bit_identical_on_replicated_and_sharded_wire(self):
        init = _np_params()
        ref = _run_stream(init, 3)
        got = _run_stream(init, 3, server_opt=ServerOptimizer(
            "plain", params_from_numpy(init)))
        assert ref.round_idx == got.round_idx == 3
        assert _equal(ref.params, got.params)
        wide = {"w": np.random.RandomState(0).randn(16, 16)
                .astype(np.float32)}

        def spine():
            return build_shard_spine(params_from_numpy(wide), num_shards=2,
                                     min_split_elems=64)
        ref = _run_stream(wide, 3, spine=spine())
        got = _run_stream(wide, 3, spine=spine(), server_opt=ServerOptimizer(
            "plain", params_from_numpy(wide)))
        assert _equal(ref.params, got.params)

    @pytest.mark.parametrize("name", ["momentum", "adam", "fedac"])
    def test_live_federation_matches_the_jax_seam(self, name):
        init = _np_params()
        j = _j_run_stream(init, 3, server_opt=JServerOptimizer(
            name, init, **KW))
        t = _run_stream(init, 3, server_opt=ServerOptimizer(
            name, params_from_numpy(init), **KW))
        _close_to_jax(t.params, j.params)
        assert t._journal_mode() == f"stream_mean+srvopt={name}"

    @pytest.mark.parametrize("name", ["momentum", "adam", "fedac"])
    def test_kill_at_checkpoint_write_resumes_bit_identical(self, tmp_path,
                                                            name):
        """Kill mid-checkpoint-write in round 1 of 3 with live optimizer
        state: the resumed run equals the uncrashed one, params and every
        optimizer slot, bit for bit."""
        init = _np_params()
        opt_ref = ServerOptimizer(name, params_from_numpy(init), **KW)
        ref = _run_stream(init, 3, server_opt=opt_ref, norm_clip=1.0)

        def run(opt, fl=None):
            return _run_stream(
                init, 3, server_opt=opt, norm_clip=1.0, fl=fl,
                ck=RoundCheckpointer(str(tmp_path / "ck"), save_every=1),
                jr=RoundJournal(str(tmp_path / "j"), snapshot_every=1),
                extra_state=(lambda: {"srv_opt": opt.state_dict()},
                             lambda t: opt.load_state_dict(t["srv_opt"])))
        with pytest.raises(ActorKilled):
            run(ServerOptimizer(name, params_from_numpy(init), **KW),
                Faultline(crashes=[CrashSpec(point="mid_checkpoint_write",
                                             hit=1, round_idx=1)]))
        opt2 = ServerOptimizer(name, params_from_numpy(init), **KW)
        resumed = run(opt2)
        assert resumed.round_idx == 3
        assert _equal(resumed.params, ref.params)
        a, b = opt2.state_dict(), opt_ref.state_dict()
        assert all(np.array_equal(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    def test_cli_resume_under_another_optimizer_is_refused(self, tmp_path):
        base = ["--algo", "cross_silo", "--model", "lr", "--dataset",
                "mnist", "--client_num_in_total", "4",
                "--client_num_per_round", "2", "--batch_size", "4",
                "--agg_mode", "stream", "--platform", "cpu",
                "--log_stdout", "false", "--checkpoint_dir",
                str(tmp_path / "ck"), "--checkpoint_every", "1",
                "--server_lr", "0.1"]
        out = main(base + ["--server_opt", "adam", "--comm_round", "2"])
        assert out["params_finite"]
        with pytest.raises(ServerOptMismatchError, match="adam"):
            main(base + ["--server_opt", "momentum", "--comm_round", "3"])


class TestConfigGates:
    _BASE = ["--algo", "cross_silo", "--agg_mode", "stream", "--platform",
             "cpu"]

    @pytest.mark.parametrize("flags,match", [
        (["--server_opt", "lamb"], "unknown --server_opt"),
        (["--server_opt", "adam", "--algo", "fedavg"], "cross_silo only"),
        (["--server_opt", "adam", "--robust_agg", "krum"],
         "order-statistic"),
        (["--server_opt", "adam", "--secagg", "pairwise"],
         "mutually exclusive"),
    ])
    def test_bad_combo_fails_loudly(self, flags, match):
        with pytest.raises(ServerOptConfigError, match=match):
            check_config(config_from_argv(self._BASE + flags))

    def test_adaptive_still_refused_naming_item_9(self):
        # the controller is ported: JAX's gate (--adaptive needs --health)
        with pytest.raises(ServerOptConfigError, match="requires --health"):
            check_config(config_from_argv(self._BASE + ["--adaptive",
                                                        "true"]))
        check_config(config_from_argv(self._BASE + ["--adaptive", "true",
                                                    "--health", "true"]))
