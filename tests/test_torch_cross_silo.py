"""The port's live cross-silo federation (``algorithms/cross_silo.py`` over
``comm/``, the streaming fold and the sharded spine) against the JAX
package.

Live federations run on one in-process hub per package, every frame
through the wire codec, with the deterministic numpy silo trainer of
``tests/test_shard_spine.py`` (the same updates on both sides).
Tolerances:

* unclipped stream and sharded (S = 2) federations, straggler drops and
  the stack path: bit for bit against the JAX package;
* clipped federations: ``atol=1e-5`` after 3 rounds (the clip scale's sum
  of squares runs in another order in XLA, a last-bit difference per
  round);
* the ``cross_silo`` runner on a small femnist twin (CNN, S = 2, K2 on,
  clip 5, sigma 0.025, 2 rounds): ``atol=1e-4`` against JAX's
  ``run_cross_silo`` from the same init — the defended slice's limit
  (conv sums in another order, the clip scale, a few ulps of the noise's
  log/cos).
"""

import importlib
import threading
import time

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as j_cross_silo
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.experiments.config import ExperimentConfig as JConfig
from fedml_tpu.robust.defense import make_defended_aggregate as j_defended
from fedml_tpu.shard_spine import build_shard_spine as j_build_spine
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor,
                                                   MsgType)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import CODEC_COUNTS, Message
from fedml_tpu_torch.core import fused_agg, prng
from fedml_tpu_torch.core.pytree import tree_keys
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.robust import AdmissionPipeline
from fedml_tpu_torch.robust.defense import make_defended_aggregate
from fedml_tpu_torch.shard_spine import build_shard_spine
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

# the module (the package's ``main`` attribute is the function)
j_main = importlib.import_module("fedml_tpu.experiments.main")


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    """No straggler timer, and no actor thread, outlives its test."""
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
            "step": np.int32(5)}


def _j_train_fn(silo):
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        return jax.tree.map(
            lambda v: (np.asarray(v)
                       + rng.randn(*np.shape(v)).astype(np.float32) * 0.1
                       ).astype(np.asarray(v).dtype)
            if np.asarray(v).dtype.kind == "f" else np.asarray(v),
            params), 10 + silo
    return fn


def _t_train_fn(silo):
    """`_j_train_fn` over the port's flat dicts, leaves in JAX's order."""
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        out = {}
        for k in tree_keys(params):
            v = np.asarray(params[k])
            out[k] = ((v + rng.randn(*v.shape).astype(np.float32) * 0.1
                       ).astype(v.dtype) if v.dtype.kind == "f" else v)
        return out, 10 + silo
    return fn


def _bits_equal(port_flat, jax_tree):
    a = jax.tree.leaves(params_to_numpy(port_flat))
    b = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def _close(port_flat, jax_tree, atol):
    for x, y in zip(jax.tree.leaves(params_to_numpy(port_flat)),
                    jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=atol)


def _drive(hub, server, silos, deaf=()):
    """Pump one federation; rounds waiting only on ``deaf`` silos are
    closed by a ROUND_TIMEOUT sent by hand (deterministic, no wall
    clock)."""
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    for _ in range(server.num_rounds if deaf else 0):  # one per round
        if server.round_idx >= server.num_rounds or server.aborted:
            break
        server.send(MsgType.ROUND_TIMEOUT, 0,
                    **{Message.ARG_ROUND: server.round_idx})
        hub.pump()
    server.finish()
    return server


class _Deaf:
    """Mixin: a silo that never answers a sync."""

    def register_handlers(self):
        self.register_handler(MsgType.S2C_FINISH, lambda m: self.finish())


def _t_run(rounds, S=0, n=3, clip=0.0, fused="off", mode="stream",
           deaf=(), rogue=None, train=_t_train_fn, **server_kw):
    hub = LocalHub(codec_roundtrip=True)
    init = params_from_numpy(_params())
    spine = stream = None
    if S:
        spine = build_shard_spine(init, num_shards=S, norm_clip=clip,
                                  fused=fused, min_split_elems=64)
        stream = spine.agg
    elif mode == "stream":
        stream = StreamingAggregator(init, method="mean", norm_clip=clip)
    server = FedAvgServerActor(hub.transport(0), init, n, n, rounds,
                               stream_agg=server_kw.pop("stream_agg", stream),
                               shard_wire=spine, **server_kw)
    silos = []
    for i in range(1, n + 1):
        cls = FedAvgClientActor
        if i in deaf:
            cls = type("DeafSilo", (_Deaf, FedAvgClientActor), {})
        elif rogue is not None and i == 2:
            cls = rogue
        silos.append(cls(i, hub.transport(i), train(i)))
    return _drive(hub, server, silos, deaf), spine


def _j_run(rounds, S=0, n=3, clip=0.0, fused="off", mode="stream",
           deaf=(), **server_kw):
    hub = JHub(codec_roundtrip=True)
    init = _params()
    kw = {}
    if S:
        spine = j_build_spine(init, num_shards=S, norm_clip=clip,
                              fused=fused, min_split_elems=64, mesh=None)
        kw = dict(stream_agg=spine.agg, shard_wire=spine)
    elif mode == "stream":
        kw = dict(stream_agg=JStream(init, method="mean", norm_clip=clip))
    server = j_cross_silo.FedAvgServerActor(hub.transport(0), init, n, n,
                                            rounds, **kw, **server_kw)
    silos = []
    for i in range(1, n + 1):
        cls = j_cross_silo.FedAvgClientActor
        if i in deaf:
            cls = type("DeafSilo", (_Deaf, cls), {})
        silos.append(cls(i, hub.transport(i), _j_train_fn(i)))
    return _drive(hub, server, silos, deaf)


# ---------------------------------------------------------------------------
# live federations against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,clip,fused,atol", [
    (0, 0.0, "off", 0.0), (2, 0.0, "off", 0.0), (2, 0.0, "on", 0.0),
    (0, 2.0, "off", 1e-5), (1, 2.0, "on", 1e-5), (4, 2.0, "on", 1e-5)])
def test_live_federation_matches_jax(S, clip, fused, atol):
    got, _ = _t_run(3, S=S, clip=clip, fused=fused)
    want = _j_run(3, S=S, clip=clip, fused=fused)
    assert got.round_idx == want.round_idx == 3
    if atol:
        _close(got.params, want.params, atol)
    else:
        assert _bits_equal(got.params, want.params)
    assert not _bits_equal(got.params, _params())   # the rounds moved it


def test_sharded_s1_bit_identical_to_replicated():
    plain, _ = _t_run(3, clip=2.0)
    sharded, _ = _t_run(3, S=1, clip=2.0)
    assert _bits_equal(plain.params, params_to_numpy(sharded.params))


def test_stack_matches_jax_stack_and_stream():
    """Undefended stack mode: the weighted mean over the device buffer
    staged at arrival, bit for bit JAX's `tree_weighted_mean`; the stream
    fold agrees with it to float tolerance (another order of operations:
    ``sum(x * w) / sum(w)`` against ``sum(x * (w / sum(w)))``)."""
    stack, _ = _t_run(3, mode="stack")
    assert stack._staged_seen == 3 * 3 and stack._staging is None
    assert _bits_equal(stack.params, _j_run(3, mode="stack").params)
    stream, _ = _t_run(3, mode="stream")
    _close(stack.params, params_to_numpy(stream.params), atol=1e-6)


_RULE = dict(trim_frac=0.2, byz_f=1, krum_m=2)


@pytest.mark.parametrize("mode,method,clip,atol", [
    ("stack", "mean", 2.0, 1e-5), ("stack", "trimmed_mean", 2.0, 1e-5),
    ("stack", "krum", 0.0, 1e-6), ("stack", "geometric_median", 0.0, 1e-5),
    ("stream", "coordinate_median", 0.0, 1e-6),
    ("stream", "multi_krum", 2.0, 1e-5),
    ("stream", "trimmed_mean", 0.0, 1e-6)])
def test_robust_federation_matches_jax(mode, method, clip, atol):
    """Five silos, 3 rounds, the defended aggregate over the stack (slots
    of the global at weight 0) or a rule over the stream's reservoir (K =
    4 < 5 uploads, so Algorithm R draws), against the JAX package."""
    if mode == "stack":
        t_kw = dict(aggregate_fn=make_defended_aggregate(
            method, norm_clip=clip, **_RULE))
        j_kw = dict(aggregate_fn=j_defended(method, norm_clip=clip,
                                            **_RULE))
    else:
        t_kw = dict(stream_agg=StreamingAggregator(
            params_from_numpy(_params()), method=method, norm_clip=clip,
            reservoir_k=4, **_RULE))
        j_kw = dict(stream_agg=JStream(_params(), method=method,
                                       norm_clip=clip, reservoir_k=4,
                                       **_RULE))
    got, _ = _t_run(3, n=5, mode=None, **t_kw)
    want = _j_run(3, n=5, mode=None, **j_kw)
    assert got.round_idx == want.round_idx == 3
    _close(got.params, want.params, atol)
    assert not _bits_equal(got.params, _params())


def test_stack_mean_equals_stream_mean_bit_for_bit():
    """The defended mean over the staged stack (clip, noise) equals the
    streaming fold of the same uploads, bit for bit, round after round —
    including a round where a silo's slot holds the global at weight 0."""
    kw = dict(norm_clip=2.0, noise_std=0.01, seed=5)
    stack, _ = _t_run(3, n=4, mode=None, deaf=(3,), straggler_policy="drop",
                      round_timeout_s=3600,
                      aggregate_fn=make_defended_aggregate("mean", **kw))
    stream, _ = _t_run(3, n=4, mode=None, deaf=(3,),
                       straggler_policy="drop", round_timeout_s=3600,
                       stream_agg=StreamingAggregator(
                           params_from_numpy(_params()), **kw))
    assert stack.dropped_silos == stream.dropped_silos == {0: [3], 1: [3],
                                                           2: [3]}
    assert _bits_equal(stack.params, params_to_numpy(stream.params))


def test_broadcast_encodes_once_per_shard():
    S, n, rounds = 2, 3, 2
    before = dict(CODEC_COUNTS)
    _t_run(rounds, S=S, n=n)
    encodes = CODEC_COUNTS["payload_encodes"] - before["payload_encodes"]
    assert encodes == rounds * (S + n * S)   # S broadcasts + n*S slices


@pytest.mark.parametrize("S", [0, 2])
def test_straggler_drop_matches_jax(S):
    kw = dict(straggler_policy="drop", round_timeout_s=3600,
              min_silo_frac=0.5)
    got, _ = _t_run(3, S=S, n=4, deaf=(4,), **kw)
    want = _j_run(3, S=S, n=4, deaf=(4,), **kw)
    assert got.round_idx == want.round_idx == 3
    assert got.dropped_silos == want.dropped_silos == {0: [4], 1: [4],
                                                       2: [4]}
    assert _bits_equal(got.params, want.params)


def test_straggler_below_quorum_keeps_waiting():
    got, _ = _t_run(1, n=4, deaf=(2, 3, 4), straggler_policy="drop",
                    round_timeout_s=3600, min_silo_frac=0.5)
    assert got.round_idx == 0 and not got.dropped_silos


def test_straggler_abort_on_a_real_timer():
    """The straggler timer fires on its own thread and only enqueues a
    self-message; the next pump runs the abort: FINISH to every silo,
    the timer joined, the global untouched."""
    hub = LocalHub(codec_roundtrip=True)
    init = params_from_numpy(_params())
    server = FedAvgServerActor(
        hub.transport(0), init, 3, 3, 2,
        stream_agg=StreamingAggregator(init, method="mean"),
        straggler_policy="abort", round_timeout_s=0.05)
    deaf = type("DeafSilo", (_Deaf, FedAvgClientActor), {})
    silos = [FedAvgClientActor(1, hub.transport(1), _t_train_fn(1)),
             deaf(2, hub.transport(2), _t_train_fn(2)),
             FedAvgClientActor(3, hub.transport(3), _t_train_fn(3))]
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    assert server._timer.pending
    deadline = time.monotonic() + 10
    while not server.aborted and time.monotonic() < deadline:
        time.sleep(0.02)
        hub.pump()
    assert server.aborted and server.round_idx == 0
    assert server.params is init


def test_stale_and_foreign_uploads_are_discarded():
    hub = LocalHub(codec_roundtrip=True)
    init = params_from_numpy(_params())
    stream = StreamingAggregator(init, method="mean")
    server = FedAvgServerActor(hub.transport(0), init, 2, 2, 1,
                               stream_agg=stream)
    for i in (1, 2):
        hub.transport(i)
    server.register_handlers()
    server.start()                       # round 0: silos 1 and 2

    def upload(sender, round_idx):
        msg = Message(MsgType.C2S_MODEL, sender, 0)
        msg.add(Message.ARG_MODEL_PARAMS, _params(1))
        msg.add(Message.ARG_NUM_SAMPLES, 10)
        msg.add(Message.ARG_ROUND, round_idx)
        server._on_model(Message.from_bytes(msg.to_bytes()))

    upload(7, 0)                         # not in the round's cohort
    upload(1, 5)                         # another round's upload
    assert stream.count == 0 and not server._received
    upload(1, 0)
    upload(1, 0)                         # a duplicate delivery
    assert stream.count == 1 and list(server._received) == [1]
    server.finish()


def test_rogue_whole_model_upload_rejected_at_weight0():
    class Rogue(FedAvgClientActor):
        def _on_shard_sync(self, msg):
            if msg.get(Message.ARG_SHARD) != 0:
                return
            self.send(MsgType.C2S_MODEL, self.server_id,
                      **{Message.ARG_MODEL_PARAMS: _params(),
                         Message.ARG_NUM_SAMPLES: 10,
                         Message.ARG_ROUND: msg.get(Message.ARG_ROUND)})

    server, spine = _t_run(2, S=2, rogue=Rogue)
    assert server.round_idx == 2             # the barrier closed over it
    assert spine.admission.rejected["fingerprint"] >= 2
    assert list(server._last_accepted) == [1, 3]
    assert not _bits_equal(server.params, _params())


def test_poisoned_slice_rejects_the_silo_and_the_round_completes():
    def nan_train(silo):
        if silo != 2:
            return _t_train_fn(silo)
        return lambda p, c, r: ({k: np.full_like(np.asarray(v), np.nan)
                                 if np.asarray(v).dtype.kind == "f"
                                 else np.asarray(v) for k, v in p.items()},
                                10)

    server, spine = _t_run(2, S=2, train=nan_train)
    assert server.round_idx == 2
    assert spine.admission.rejected["nonfinite"] >= 2
    assert all(np.isfinite(v).all() for v in
               jax.tree.leaves(params_to_numpy(server.params)))


def test_admission_rejects_a_poisoned_plain_upload():
    init = params_from_numpy(_params())
    from fedml_tpu_torch.core.pytree import nest, to_host
    adm = AdmissionPipeline(to_host(nest(init)))

    def nan_train(silo):
        if silo != 3:
            return _t_train_fn(silo)
        return lambda p, c, r: ({k: np.full_like(np.asarray(v), np.inf)
                                 if np.asarray(v).dtype.kind == "f"
                                 else np.asarray(v) for k, v in p.items()},
                                10)

    server, _ = _t_run(2, admission=adm, train=nan_train)
    assert server.round_idx == 2 and adm.rejected["nonfinite"] == 2
    assert list(server._last_accepted) == [1, 2]


# ---------------------------------------------------------------------------
# refusals and gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", [
    "secagg", "ingest", "health", "perf", "server_opt", "controller",
    "degrade", "decode_upload", "publish"])
def test_unported_actor_options_are_refused_by_name(option):
    init = params_from_numpy(_params())
    with pytest.raises(NotImplementedError, match=option):
        FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                          **{option: object()})


def test_actor_level_gates():
    init = params_from_numpy(_params())
    with pytest.raises(ValueError, match="exclusive"):
        FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                          stream_agg=StreamingAggregator(init),
                          aggregate_fn=make_defended_aggregate())
    spine = build_shard_spine(init, num_shards=2, min_split_elems=64)
    with pytest.raises(ValueError, match="sharded stream_agg"):
        FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                          shard_wire=spine)
    with pytest.raises(ValueError, match="straggler_policy"):
        FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                          straggler_policy="sometimes")


_CS = ["--algo", "cross_silo", "--agg_mode", "stream", "--model_shards",
       "2", "--comm_round", "1", "--client_num_in_total", "4",
       "--client_num_per_round", "2", "--platform", "cpu"]


@pytest.mark.parametrize("flags,exc,match", [
    (["--algo", "fedavg"], ValueError, "cross_silo only"),
    (["--agg_mode", "stack"], ValueError, "agg_mode stream"),
    (["--admission", "off"], ValueError, "admission"),
    (["--model_shards", "-1"], ValueError, "must be >= 0"),
    (["--model_shards", "0", "--fused_finalize", "on"], ValueError,
     "model_shards"),
    (["--fused_finalize", "maybe"], ValueError, "auto\\|on\\|off"),
    (["--agg_mode", "sideways", "--model_shards", "0"], ValueError,
     "agg_mode"),
    (["--admission", "maybe"], ValueError, "auto\\|on\\|off"),
    (["--robust_agg", "krum"], ValueError, "model_shards with --robust_agg"),
    (["--silo_backend", "grpc"], ValueError, "local hub only"),
    (["--silo_backend", "mqtt"], ValueError, "unknown silo_backend"),
    (["--model_shards", "0", "--robust_agg", "krum", "--stream_reservoir",
      "0"], ValueError, "stream_reservoir"),
    (["--model_shards", "0", "--robust_agg", "median"], ValueError,
     "robust_agg must be one of"),
    (["--secagg", "pairwise"], NotImplementedError, "secure/protocol.py"),
    (["--edge_aggregators", "2"], NotImplementedError, "hierarchical"),
    (["--wire_compression", "topk"], NotImplementedError, "compress"),
    (["--error_feedback", "true"], NotImplementedError, "compress"),
    (["--chaos_drop", "0.1"], ValueError, "wedge"),
    (["--chaos_dup", "0.1", "--silo_backend", "grpc"], ValueError,
     "local hub only"),
    (["--algo", "fedavg", "--chaos_dup", "0.1"], ValueError,
     "cross_silo only"),
    (["--serve_port", "8080"], NotImplementedError, "serve"),
    (["--ingest_pipeline", "true"], NotImplementedError, "ingest"),
    (["--journal", "true", "--agg_mode", "stack", "--model_shards", "0"],
     ValueError, "streaming-fold"),
    (["--health", "true"], NotImplementedError, "health"),
    (["--server_opt", "adam"], NotImplementedError, "server_opt"),
    (["--adversary", "2:gauss:0.1"], NotImplementedError, "adversary"),
    (["--journal_snapshot_every", "0"], ValueError,
     "journal_snapshot_every"),
])
def test_config_gates_and_named_refusals(flags, exc, match):
    with pytest.raises(exc, match=match):
        t_main.main(_CS + flags)


def test_gates_agree_with_the_jax_package():
    """The gates the two packages share fail on the same configs."""
    for flags in (["--agg_mode", "stack"], ["--admission", "off"],
                  ["--model_shards", "0", "--fused_finalize", "on"],
                  ["--fused_finalize", "maybe"]):
        cfg = config_from_argv(_CS + flags)
        jcfg = JConfig(algo="cross_silo", agg_mode=cfg.agg_mode,
                       model_shards=cfg.model_shards,
                       fused_finalize=cfg.fused_finalize,
                       admission=cfg.admission, comm_round=1,
                       client_num_in_total=4, client_num_per_round=2,
                       log_stdout=False, platform="cpu")
        with pytest.raises(ValueError):
            t_main.check_config(cfg)
        with pytest.raises(ValueError):
            j_main.main(jcfg)


# ---------------------------------------------------------------------------
# the runner and the CLI
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.rows = []

    def log(self, row, step=None):
        self.rows.append(row)


def test_silo_key_follows_the_jax_chain():
    seed = 7
    rng = jax.random.split(jax.random.key(seed))[0]
    for r in range(3):
        rng, round_key = jax.random.split(rng)
        for silo in (1, 4):
            want = np.asarray(jax.random.key_data(
                jax.random.fold_in(round_key, silo - 1)))
            assert prng.key_data(t_main.silo_key(seed, r, silo)).tolist() \
                == want.tolist()


def test_runner_matches_jax_run_cross_silo(monkeypatch):
    """12 femnist-twin clients, 3 silos per round, the CNN, S = 2 with K2
    on, clip 5, sigma 0.025, 2 rounds, from the JAX runner's own init."""
    args = dict(algo="cross_silo", model="cnn_fedavg", dataset="femnist",
                client_num_in_total=12, client_num_per_round=3,
                batch_size=20, lr=0.1, epochs=1, agg_mode="stream",
                model_shards=2, fused_finalize="on", norm_clip=5.0,
                agg_noise_std=0.025, comm_round=2,
                frequency_of_the_test=1000, log_stdout=False)
    jcfg = JConfig(**args, platform="cpu")
    jdata = j_main.load_experiment_data(jcfg)
    jinit, _ = j_main._silo_training_setup(jcfg, jdata,
                                           j_main._make_workload(jcfg, jdata))
    servers = []

    class Recording(j_cross_silo.FedAvgServerActor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(j_cross_silo, "FedAvgServerActor", Recording)
    want_stats = j_main.run_cross_silo(jcfg, jdata, None, _Sink())
    want = jax.tree.map(np.asarray, servers[0].params)

    tcfg = t_main.ExperimentConfig(**args, platform="cpu")
    t_main.check_config(tcfg)
    fused_agg.reset_launch_counts()
    fed = t_main.CrossSiloFederation(
        tcfg, t_main.load_experiment_data(tcfg), _Sink(),
        init_params=params_from_numpy(jax.tree.map(np.asarray, jinit)))
    got_stats, server = fed.run(), fed.server
    assert server.round_idx == 2 and got_stats["params_finite"]
    assert fused_agg.launch_counts["shard_finalize"] == 0   # CPU: plain
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want),
                                jax.tree.leaves(jinit)))
    assert moved > 1e-3
    _close(server.params, want, atol=1e-4)
    for k in ("test_acc", "train_loss"):
        assert got_stats[k] == pytest.approx(want_stats[k], abs=1e-3)


@pytest.mark.parametrize("flags", [
    dict(agg_mode="stack", robust_agg="trimmed_mean", norm_clip=5.0),
    dict(agg_mode="stream", robust_agg="coordinate_median",
         stream_reservoir=2)])
def test_robust_runner_matches_jax_run_cross_silo(monkeypatch, flags):
    """The runner's ``--robust_agg`` wiring in both modes: 12 femnist-twin
    clients, 3 silos, the CNN, 2 rounds, from the JAX runner's init
    (1e-4, the CNN slice's limit)."""
    args = dict(algo="cross_silo", model="cnn_fedavg", dataset="femnist",
                client_num_in_total=12, client_num_per_round=3,
                batch_size=20, lr=0.1, epochs=1, comm_round=2,
                frequency_of_the_test=1000, log_stdout=False, **flags)
    jcfg = JConfig(**args, platform="cpu")
    jdata = j_main.load_experiment_data(jcfg)
    jinit, _ = j_main._silo_training_setup(jcfg, jdata,
                                           j_main._make_workload(jcfg, jdata))
    servers = []

    class Recording(j_cross_silo.FedAvgServerActor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(j_cross_silo, "FedAvgServerActor", Recording)
    j_main.run_cross_silo(jcfg, jdata, None, _Sink())
    want = jax.tree.map(np.asarray, servers[0].params)
    tcfg = t_main.ExperimentConfig(**args, platform="cpu")
    t_main.check_config(tcfg)
    fed = t_main.CrossSiloFederation(
        tcfg, t_main.load_experiment_data(tcfg), _Sink(),
        init_params=params_from_numpy(jax.tree.map(np.asarray, jinit)))
    stats = fed.run()
    assert fed.server.round_idx == 2 and stats["params_finite"]
    assert (fed.server.aggregate_fn is not None) == (flags["agg_mode"]
                                                     == "stack")
    assert fed.server.admission is not None
    _close(fed.server.params, want, atol=1e-4)


def test_cli_runs_on_cpu_and_refuses_without_it(tmp_path):
    args = ["--algo", "cross_silo", "--silo_backend", "local", "--model",
            "cnn_fedavg", "--dataset", "femnist", "--client_num_in_total",
            "8", "--client_num_per_round", "2", "--batch_size", "20",
            "--agg_mode", "stream", "--model_shards", "2",
            "--fused_finalize", "on", "--norm_clip", "5.0",
            "--agg_noise_std", "0.025", "--comm_round", "2",
            "--run_dir", str(tmp_path), "--log_stdout", "false"]
    out = t_main.main(args + ["--platform", "cpu"])
    assert out["params_finite"] is True and out["rounds_per_s"] > 0
    assert out["round"] == 1 and 0.0 <= out["test_acc"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="platform cpu"):
        t_main.main(args)
