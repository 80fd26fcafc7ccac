"""The port's wire layer (``fedml_tpu_torch/comm``) against the JAX
package's.

* frames: the port's ``Message`` and encode-once fan-out frames are
  byte-equal to ``fedml_tpu.comm.message``'s for the same payload, and each
  package decodes the other's frames (twin of ``tests/test_wire.py``'s
  golden-frame pins);
* torn frames raise ``ValueError`` from every decode entry;
* the hub choreography: the port's server and silos over the in-process
  hub, with and without the codec roundtrip, give the JAX package's
  globals bit for bit (twin of ``tests/test_comm.py``'s choreography), and
  the threaded drive mode delivers.
"""

import json
import struct
import threading

import numpy as np
import pytest

from fedml_tpu.algorithms.cross_silo import FedAvgClientActor as JClient
from fedml_tpu.algorithms.cross_silo import FedAvgServerActor as JServer
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.comm.message import SharedPayload as JShared
from fedml_tpu.comm.message import build_fanout as j_build_fanout
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import (CODEC_COUNTS, Message,
                                          SharedPayload, build_fanout)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

_HDR = struct.Struct("<I")


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def _edge_tree(seed=0):
    """0-d, non-contiguous, strided, bool, int8, empty, f16 and nested
    list/tuple leaves beside ordinary dense layers."""
    rng = np.random.RandomState(seed)
    return {
        "dense": {"kernel": rng.randn(16, 8).astype(np.float32),
                  "bias": rng.randn(8).astype(np.float32)},
        "zero_d": np.float32(3.25),
        "noncontig": rng.randn(6, 6).T,
        "strided": np.arange(20)[::2],
        "flags": np.array([True, False, True]),
        "quantized": {"codes": rng.randint(-128, 128, (32,)).astype(np.int8),
                      "scale": np.float64(0.017)},
        "empty": np.zeros((0, 4), np.float32),
        "half": rng.randn(5).astype(np.float16),
        "mixed": [np.int64(9), ("tag", np.ones((2, 2)))],
    }


def _assert_tree_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


def _msg(cls, tree, seed=0):
    return (cls(3, 1, 0)
            .add(cls.ARG_MODEL_PARAMS, tree)
            .add(cls.ARG_NUM_SAMPLES, 12)
            .add(cls.ARG_ROUND, 4)
            .add("stats", {"acc": 0.5, "loss": 1.25, "seed": seed}))


@pytest.mark.parametrize("seed", range(4))
def test_frames_byte_equal_and_cross_decode(seed):
    tree = _edge_tree(seed)
    ours, theirs = _msg(Message, tree, seed), _msg(JMessage, tree, seed)
    frame = ours.to_bytes()
    assert frame == theirs.to_bytes()
    for out in (JMessage.from_bytes(frame),
                Message.from_bytes(theirs.to_bytes())):
        _assert_tree_equal(out.get("model_params"), tree)
        assert out.get("num_samples") == 12 and out.get("round_idx") == 4
        assert out.get("stats") == {"acc": 0.5, "loss": 1.25, "seed": seed}


def test_port_params_become_jax_frames():
    """The actor boundary: the port's flat tensors, nested back to numpy,
    encode to the JAX package's frame of the same weights."""
    tree = {"Conv_0": {"bias": np.arange(3, dtype=np.float32),
                       "kernel": np.ones((2, 2, 1, 3), np.float32)},
            "Dense_0": {"bias": np.zeros(4, np.float32),
                        "kernel": np.full((3, 4), 0.5, np.float32)}}
    nested = params_to_numpy(params_from_numpy(tree))
    assert (Message(2, 0, 1).add("model_params", nested).to_bytes()
            == JMessage(2, 0, 1).add("model_params", tree).to_bytes())


def test_fanout_frames_byte_equal_both_ways():
    tree = _edge_tree(2)
    shared = {Message.ARG_MODEL_PARAMS: tree, Message.ARG_ROUND: 7}
    per = {1: {Message.ARG_CLIENT_INDEX: 4}, 2: {Message.ARG_CLIENT_INDEX: 5}}
    before = CODEC_COUNTS["payload_encodes"]
    ours = build_fanout(1, 0, [1, 2], shared, per)
    assert CODEC_COUNTS["payload_encodes"] == before + 1   # encode once
    theirs = j_build_fanout(1, 0, [1, 2], shared, per)
    for a, b, idx in zip(ours, theirs, (4, 5)):
        assert a.to_bytes() == b.to_bytes()
        for out in (JMessage.from_bytes(a.to_bytes()),
                    Message.from_bytes(b.to_bytes()),
                    Message.from_frame_parts(a.frame_parts())):
            _assert_tree_equal(out.get(Message.ARG_MODEL_PARAMS), tree)
            assert out.get(Message.ARG_CLIENT_INDEX) == idx
            assert out.get(Message.ARG_ROUND) == 7
    payload = {Message.ARG_MODEL_PARAMS: tree}
    a, b = SharedPayload(payload), JShared(payload)
    m, jm = Message(1, 0, 3), JMessage(1, 0, 3)
    for msg in (m, jm):
        msg.params.update(payload)
        msg.add("x", 1)
    assert a.frame_bytes(m) == b.frame_bytes(jm)


def test_decoded_leaves_are_read_only_views():
    out = Message.from_bytes(_msg(Message, _edge_tree()).to_bytes())
    kernel = out.get(Message.ARG_MODEL_PARAMS)["dense"]["kernel"]
    assert not kernel.flags.writeable


class TestTornFrames:
    def test_truncations_raise_value_error(self):
        frame = _msg(Message, _edge_tree()).to_bytes()
        for cut in (0, 2, _HDR.size, len(frame) // 2, len(frame) - 1):
            with pytest.raises(ValueError):
                Message.from_bytes(frame[:cut])

    def test_garbage_and_header_damage_raise_value_error(self):
        frame = bytearray(_msg(Message, _edge_tree()).to_bytes())
        with pytest.raises(ValueError):
            Message.from_bytes(b"\xff" * 64)
        frame[6] ^= 0xFF
        with pytest.raises(ValueError):
            Message.from_bytes(bytes(frame))
        with pytest.raises(ValueError):
            Message.from_bytes(_HDR.pack(2 ** 30) + b"xx")

    @pytest.mark.parametrize("idx,shape", [(7, [2]), (0, [5])])
    def test_bad_buffer_index_and_shape_raise(self, idx, shape):
        hdr = json.dumps({"plain": {}, "arrays": {
            "p": {"spec": {"k": "leaf"},
                  "leaves": [{"dtype": "<f4", "shape": shape,
                              "idx": idx}]}}}).encode()
        frame = _HDR.pack(len(hdr)) + hdr + _HDR.pack(8) + b"\0" * 8
        with pytest.raises(ValueError):
            Message.from_bytes(frame)


# ---------------------------------------------------------------------------
# the hub choreography
# ---------------------------------------------------------------------------

def _params_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)},
            "steps": np.int32(7)}


def _j_train(params, client_idx, round_idx):
    return ({"dense": {k: v + (client_idx + 1)
                       for k, v in params["dense"].items()},
             "steps": params["steps"]}, 10 * (client_idx + 1))


def _t_train(params, client_idx, round_idx):
    return ({k: (v + (client_idx + 1) if k.startswith("dense/") else v)
             for k, v in params.items()}, 10 * (client_idx + 1))


def _choreography(hub, server_cls, client_cls, init, train):
    history = []
    server = server_cls(hub.transport(0), init, 10, 4, 3,
                        on_round_done=lambda r, p: history.append((r, p)))
    clients = [client_cls(i, hub.transport(i), train) for i in range(1, 5)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    server.start()
    hub.pump()
    return history


@pytest.mark.parametrize("codec_roundtrip", [False, True])
def test_cross_silo_choreography_matches_jax(codec_roundtrip):
    """3 rounds, 4 of 10 silos sampled per round, stack mode: every
    round's global equals the JAX package's, bit for bit."""
    got = _choreography(LocalHub(codec_roundtrip=codec_roundtrip),
                        FedAvgServerActor, FedAvgClientActor,
                        params_from_numpy(_params_tree()), _t_train)
    want = _choreography(JHub(codec_roundtrip=codec_roundtrip), JServer,
                         JClient, _params_tree(), _j_train)
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2]
    for (_, g), (_, w) in zip(got, want):
        g = params_to_numpy(g)
        for path in (("dense", "kernel"), ("dense", "bias"), ("steps",)):
            a, b = g, w
            for p in path:
                a, b = a[p], b[p]
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_threaded_local_transport():
    """Threaded drive mode: the client's loop runs in a worker thread."""
    hub = LocalHub()
    t_server, t_client = hub.transport(0), hub.transport(1)
    got = []

    class Echo:
        def receive_message(self, msg_type, msg):
            if msg_type == "ping":
                t_client.send_message(
                    Message("pong", 1, 0).add("v", msg.get("v") + 1))

    class Collect:
        def receive_message(self, msg_type, msg):
            got.append(msg.get("v"))
            t_client.stop()
            t_server.stop()

    t_client.add_observer(Echo())
    t_server.add_observer(Collect())
    worker = threading.Thread(target=t_client.run, name="node-1")
    worker.start()
    t_server.send_message(Message("ping", 0, 1).add("v", 41))
    t_server.run()
    worker.join(timeout=5)
    assert not worker.is_alive() and got == [42]


def test_hub_rejects_unknown_receivers():
    hub = LocalHub(codec_roundtrip=True)
    t0 = hub.transport(0)
    with pytest.raises(KeyError):
        t0.send_message(Message(1, 0, 9).add("v", 1))
