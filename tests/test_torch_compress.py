"""The port's wire compression (``fedml_tpu_torch/comm/compress.py``) and
its live wiring against the JAX package.

Compression is host numpy in both packages.  Held BYTE-EQUAL:

* the topk and int8 payloads of the LR, CNN, ResNet-56 and LSTM parameter
  trees, the structural token (``str(jax treedef)`` in the JAX package,
  rendered by the port without JAX) included, and the upload frames that
  carry them;
* decompression, ``wire_bytes`` and the error-feedback state (residuals,
  parked entries, ``state_dict``) under one ack sequence;
* a compressed federation with error feedback on each package's hub
  (exact sums, so bit for bit), and mixed federations over one MQTT
  broker — a JAX server decoding port silos' frames and a port server
  decoding JAX silos' frames (1e-6: the broker's arrival order decides
  the order of the fold's f32 sums).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.algorithms.async_fl import delta_encoder as j_delta
from fedml_tpu.comm import compress as jc
from fedml_tpu.comm import mqtt_transport as jmt
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu_torch.algorithms.async_fl import delta_encoder as t_delta
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm import compress as tc
from fedml_tpu_torch.comm import mqtt_transport as mt
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.core.pytree import flatten_nested, nest, to_host
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.experiments.models import (create_workload,
                                                sample_shape_of)
from fedml_tpu_torch.robust import AdmissionPipeline
from fedml_tpu_torch.utils.jax_params import params_from_numpy

JOIN_S = 30


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


_TREES = {}


def _model_tree(model, dataset):
    """The model's parameter tree in the wire layout (nested numpy)."""
    if (model, dataset) not in _TREES:
        data = load_data(dataset, batch_size=4, num_clients=4, seed=0)
        wl = create_workload(model, dataset, data.class_num,
                             sample_shape_of(data))
        params = wl.init(torch.Generator().manual_seed(0), "cpu")
        _TREES[(model, dataset)] = to_host(nest(params))
    return _TREES[(model, dataset)]


def _delta_like(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda v: (rng.randn(*np.shape(v)) * 0.01)
                        .astype(np.asarray(v).dtype), tree)


MODELS = [("lr", "mnist"), ("cnn_fedavg", "femnist"),
          ("resnet56", "cifar10"), ("rnn", "shakespeare")]


@pytest.mark.parametrize("model,dataset", MODELS)
def test_treedef_token_equals_the_jax_treedef(model, dataset):
    tree = _model_tree(model, dataset)
    assert tc.treedef_token(tree) == str(jax.tree.structure(tree))
    assert [id(x) for x in tc.tree_leaves(tree)] == \
        [id(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("scheme", ["topk", "int8"])
@pytest.mark.parametrize("model,dataset", MODELS)
def test_payloads_and_frames_are_byte_equal(model, dataset, scheme):
    delta = _delta_like(_model_tree(model, dataset), 1)
    want = jc.compress_update(delta, scheme, topk_frac=0.05)
    got = tc.compress_update(delta, scheme, topk_frac=0.05)
    assert got["treedef"] == want["treedef"]
    jl, tl = jax.tree.leaves(want), tc.tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the upload frames that carry them
    jmsg = JMessage(3, 4, 0).add("model_params", want).add("num_samples", 7)
    tmsg = Message(3, 4, 0).add("model_params", got).add("num_samples", 7)
    assert tmsg.to_bytes() == jmsg.to_bytes()
    assert tc.wire_bytes(got) == jc.wire_bytes(want)
    # each package decodes the other's frame to the same tree
    like = _model_tree(model, dataset)
    from_port = jc.decompress_update(
        JMessage.from_bytes(tmsg.to_bytes()).get("model_params"), like)
    from_jax = tc.decompress_update(
        Message.from_bytes(jmsg.to_bytes()).get("model_params"), like)
    for a, b in zip(jax.tree.leaves(from_port), tc.tree_leaves(from_jax)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_mismatched_skeleton_and_nonfinite_fail_loudly():
    delta = _delta_like(_model_tree("lr", "mnist"), 2)
    payload = tc.compress_update(delta, "topk")
    with pytest.raises(ValueError, match="skeleton"):
        tc.decompress_update(payload, {"other": np.zeros(3, np.float32)})
    bad = jax.tree.map(lambda v: np.full_like(v, np.nan), delta)
    for scheme in ("topk", "int8"):
        with pytest.raises(ValueError) as got:
            tc.compress_update(bad, scheme)
        with pytest.raises(ValueError) as want:
            jc.compress_update(bad, scheme)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        tc.compress_update(delta, "zip")


def test_error_feedback_state_matches_the_jax_package():
    like = _model_tree("cnn_fedavg", "femnist")
    jef, tef = jc.ErrorFeedback(), tc.ErrorFeedback()
    acks = [None, [1, 2], [2], [1], None]
    for r, acked in enumerate(acks):
        for silo in (1, 2):
            d = _delta_like(like, 10 * r + silo)
            jd_ = jef.apply(silo, d)
            td_ = tef.apply(silo, d)
            jp = jc.compress_update(jd_, "topk", 0.1)
            tp = tc.compress_update(td_, "topk", 0.1)
            jef.record(silo, jd_, jc.decompress_update(jp, jd_))
            tef.record(silo, td_, tc.decompress_update(tp, td_))
            for a, b in zip(jax.tree.leaves(jp), tc.tree_leaves(tp)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for silo in (1, 2):
            jef.resolve(silo, acked)
            tef.resolve(silo, acked)
    js = jef.state_dict((1, 2, 3), like)
    ts = tef.state_dict((1, 2, 3), like)
    assert [np.asarray(x).tobytes() for x in jax.tree.leaves(js)] == \
        [np.asarray(x).tobytes() for x in tc.tree_leaves(ts)]
    fresh = tc.ErrorFeedback()
    fresh.load_state_dict(js)
    d = _delta_like(like, 99)
    for a, b in zip(jax.tree.leaves(jef.apply(1, d)),
                    tc.tree_leaves(fresh.apply(1, d))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_delta_encoder_matches_the_jax_package():
    new, glob = _delta_like(_model_tree("lr", "mnist"), 3), \
        _model_tree("lr", "mnist")
    for a, b in zip(jax.tree.leaves(j_delta(new, glob)),
                    tc.tree_leaves(t_delta(new, glob))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# live compressed federations
# ---------------------------------------------------------------------------

def _init():
    rng = np.random.RandomState(0)
    return {"dense": {"kernel": rng.randn(8, 6).astype(np.float32),
                      "bias": rng.randn(6).astype(np.float32)}}


def _j_train(silo):
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(100 * silo + int(round_idx))
        return jax.tree.map(lambda v: np.asarray(v) + rng.randn(*v.shape)
                            .astype(np.float32) * 0.1, params), 4 + silo
    return fn


def _t_train(silo):
    def fn(params, client_idx, round_idx):
        new, n = _j_train(silo)(nest(params), client_idx, round_idx)
        return flatten_nested(new), n
    return fn


def _codecs(mod, scheme, ef):
    """(encode factory, on_accepted factory, decode) over ``mod``'s
    compress module: the CLI's codec, the JAX runner's wiring."""
    feedback = mod.ErrorFeedback()
    delta_encoder = j_delta if mod is jc else t_delta

    def make_encode(silo):
        def encode(new, glob):
            d = delta_encoder(new, glob)
            if ef:
                d = feedback.apply(silo, d)
            p = mod.compress_update(d, scheme, 0.25)
            if ef:
                feedback.record(silo, d, mod.decompress_update(p, d))
            return p
        return encode

    def make_ack(silo):
        return (lambda acked: feedback.resolve(silo, acked)) if ef else None

    def decode(payload, glob):
        host = (jax.tree.map(np.asarray, glob) if mod is jc else glob)
        d = mod.decompress_update(payload, host)
        return (jax.tree.map(np.add, host, d) if mod is jc
                else tc.tree_map(np.add, host, d))
    return make_encode, make_ack, decode


N, ROUNDS = 3, 3


def _jax_federation(scheme, ef, transport_of=None):
    hub = JHub(codec_roundtrip=True)
    transport_of = transport_of or hub.transport
    enc, ack, dec = _codecs(jc, scheme, ef)
    server = jcs.FedAvgServerActor(
        transport_of(0), _init(), N, N, ROUNDS, decode_upload=dec,
        stream_agg=JStream(_init(), method="mean", kind="params"))
    silos = [jcs.FedAvgClientActor(i, transport_of(i), _j_train(i),
                                   encode_upload=enc(i), on_accepted=ack(i))
             for i in range(1, N + 1)]
    return hub, server, silos


@pytest.mark.parametrize("scheme,ef", [("topk", True), ("int8", False),
                                       ("topk", False)])
def test_compressed_federation_is_bit_equal_to_the_jax_package(scheme, ef):
    jhub, jserver, jsilos = _jax_federation(scheme, ef)
    for a in [jserver] + jsilos:
        a.register_handlers()
    jserver.start()
    jhub.pump()
    want = flatten_nested(jax.tree.map(np.asarray, jserver.params))

    hub = LocalHub(codec_roundtrip=True)
    enc, ack, dec = _codecs(tc, scheme, ef)
    init = params_from_numpy(_init())
    server = FedAvgServerActor(
        hub.transport(0), init, N, N, ROUNDS, decode_upload=dec,
        stream_agg=StreamingAggregator(init, method="mean", kind="params"))
    silos = [FedAvgClientActor(i, hub.transport(i), _t_train(i),
                               encode_upload=enc(i), on_accepted=ack(i))
             for i in range(1, N + 1)]
    for a in [server] + silos:
        a.register_handlers()
    server.start()
    hub.pump()
    assert server.round_idx == jserver.round_idx == ROUNDS
    assert {k: v.numpy().tobytes() for k, v in server.params.items()} == \
        {k: v.tobytes() for k, v in want.items()}


def _drive(server, silos, transports):
    threads = [threading.Thread(target=s.run, daemon=True,
                                name=f"node-{s.node_id}") for s in silos]
    for th in threads:
        th.start()
    server.register_handlers()
    server.start()
    st = threading.Thread(target=server.transport.run, daemon=True,
                          name="node-0")
    st.start()
    st.join(timeout=JOIN_S)
    finished = not st.is_alive()
    for th in threads:
        th.join(timeout=2)
    for t in transports:
        t.stop()
    for th in threads + [st]:
        th.join(timeout=5)
    assert finished, "the server never reached FINISH"


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_compressed_frames_cross_packages_over_one_broker(server_pkg):
    """Mixed federations over one broker: the other package's silos send
    topk frames with error feedback; the global equals the all-JAX one
    bit for bit."""
    jhub, jserver, jsilos = _jax_federation("topk", True)
    for a in [jserver] + jsilos:
        a.register_handlers()
    jserver.start()
    jhub.pump()
    want = flatten_nested(jax.tree.map(np.asarray, jserver.params))
    jenc, jack, jdec = _codecs(jc, "topk", True)
    tenc, tack, tdec = _codecs(tc, "topk", True)
    with MqttBroker() as broker:
        ts = {}
        for i in range(N + 1):
            jax_node = (i == 0) == (server_pkg == "jax")
            ts[i] = (jmt if jax_node else mt).MqttTransport(
                i, "127.0.0.1", broker.port)
        if server_pkg == "jax":
            server = jcs.FedAvgServerActor(
                ts[0], _init(), N, N, ROUNDS, decode_upload=jdec,
                stream_agg=JStream(_init(), method="mean", kind="params"))
            silos = [FedAvgClientActor(i, ts[i], _t_train(i),
                                       encode_upload=tenc(i),
                                       on_accepted=tack(i))
                     for i in range(1, N + 1)]
        else:
            init = params_from_numpy(_init())
            server = FedAvgServerActor(
                ts[0], init, N, N, ROUNDS, decode_upload=tdec,
                stream_agg=StreamingAggregator(init, method="mean",
                                               kind="params"))
            silos = [jcs.FedAvgClientActor(i, ts[i], _j_train(i),
                                           encode_upload=jenc(i),
                                           on_accepted=jack(i))
                     for i in range(1, N + 1)]
        _drive(server, silos, ts.values())
    assert server.round_idx == ROUNDS
    got = (flatten_nested(jax.tree.map(np.asarray, server.params))
           if server_pkg == "jax"
           else {k: v.numpy() for k, v in server.params.items()})
    # the broker delivers uploads in arrival order, which the threads
    # decide: the fold's f32 sums may round in another order (the
    # decoded frames themselves are byte-equal above)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("direction", ["plain_to_decoder",
                                       "compressed_to_plain"])
def test_handshake_mismatch_raises_or_rejects(direction):
    """Without admission a misconfigured fleet fails loudly; with it the
    mismatch is rejected as fingerprint damage."""
    enc, _, dec = _codecs(tc, "topk", False)
    for with_admission in (False, True):
        hub = LocalHub(codec_roundtrip=True)
        init = params_from_numpy(_init())
        adm = (AdmissionPipeline(_init(), kind="params")
               if with_admission else None)
        server = FedAvgServerActor(
            hub.transport(0), init, 2, 2, 1, admission=adm,
            decode_upload=dec if direction == "plain_to_decoder" else None,
            stream_agg=StreamingAggregator(init, method="mean",
                                           kind="params"))
        silos = [FedAvgClientActor(
            i, hub.transport(i), _t_train(i),
            encode_upload=(enc(i) if direction == "compressed_to_plain"
                           else None)) for i in (1, 2)]
        for a in [server] + silos:
            a.register_handlers()
        if not with_admission:
            with pytest.raises(ValueError, match="compress"):
                server.start()
                hub.pump()
            server.finish()
            continue
        server.start()
        hub.pump()
        assert server.round_idx == 1
        assert adm.rejected["fingerprint"] == 2


def test_cli_compression_reports_bytes_and_checkpoints_the_residuals(
        tmp_path):
    from fedml_tpu_torch.experiments import main as t_main
    from fedml_tpu_torch.experiments.config import ExperimentConfig

    class Sink:
        def log(self, row, step=None):
            pass

    def cfg(rounds, scheme="topk"):
        return ExperimentConfig(
            algo="cross_silo", model="lr", dataset="mnist",
            client_num_in_total=8, client_num_per_round=3, batch_size=4,
            comm_round=rounds, wire_compression=scheme,
            error_feedback=scheme == "topk", topk_frac=0.1,
            checkpoint_dir=str(tmp_path / scheme), checkpoint_every=1,
            frequency_of_the_test=1, platform="cpu", log_stdout=False)
    data = t_main.load_experiment_data(cfg(1))
    fed = t_main.CrossSiloFederation(cfg(2), data, Sink())
    out = fed.run()
    raw = sum(v.numel() * 4 for v in fed.server.params.values())
    assert out["params_finite"] and out["upload_bytes"] > 0
    assert fed.wire_stats["bytes"] < 0.3 * fed.wire_stats["raw_bytes"]
    assert fed.wire_stats["raw_bytes"] == 2 * 3 * raw
    # the EF residuals rode the checkpoint: a resumed run restores them
    fed2 = t_main.CrossSiloFederation(cfg(3), data, Sink())
    fed2.run()
    assert fed2.codec.ef._residual, "EF residuals were not restored"
