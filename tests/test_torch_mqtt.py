"""The port's MQTT stack (``comm/mqtt_wire.py``, ``mqtt_broker.py``,
``mqtt_client.py``, ``mqtt_transport.py``) over real TCP sockets, against
the JAX package:

* varint and topic matching over ``tests/test_mqtt_broker.py``'s cases;
  the two departures, each named: a filter with ``#`` before its last
  level matches nothing and is refused by the broker (SUBACK 0x80) —
  the JAX package matches it — and SUBACK is matched by packet id;
* broker pub/sub, the transport over the broker, a dead broker waking
  the transport;
* a cross-silo federation over TCP MQTT, its global bit-equal to the
  in-process hub's (the stack mean sums in silo order, whatever the
  arrival order);
* mixed federations over one broker — a port server with JAX and port
  silos, a JAX server with port silos — bit-equal to the all-JAX run.
  The updates are chosen so every partial sum is exact (integer-valued
  params, +silo updates, equal weights of 2), so no arrival order can
  change a bit.
"""

import socket
import struct
import threading

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm import mqtt_transport as jmt
from fedml_tpu.comm import mqtt_wire as jw
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm import mqtt_transport as mt
from fedml_tpu_torch.comm import mqtt_wire as w
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.comm.mqtt_client import MiniMqttClient
from fedml_tpu_torch.utils.jax_params import params_from_numpy

JOIN_S = 30


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-", "mqtt-")))]
    assert not leaked, leaked


@pytest.fixture(autouse=True)
def no_paho(monkeypatch):
    monkeypatch.setattr(mt, "HAVE_MQTT", False)
    monkeypatch.setattr(jmt, "HAVE_MQTT", False)


def test_varint_roundtrip():
    assert w.encode_varint(0) == b"\x00"
    assert w.encode_varint(127) == b"\x7f"
    assert w.encode_varint(128) == b"\x80\x01"
    assert w.encode_varint(16383) == b"\xff\x7f"
    assert w.encode_varint(268435455) == b"\xff\xff\xff\x7f"
    with pytest.raises(ValueError):
        w.encode_varint(268435456)
    for n in (0, 1, 127, 128, 16383, 300_000):
        assert w.encode_varint(n) == jw.encode_varint(n)
    for n in (0, 1, 127, 128, 16383):
        srv, cli = socket.socketpair()
        try:
            srv.sendall(bytes([w.PINGREQ << 4]) + w.encode_varint(n)
                        + b"x" * n)
            ptype, flags, body = w.read_packet(cli)
            assert ptype == w.PINGREQ and body == b"x" * n
        finally:
            srv.close()
            cli.close()


TOPIC_CASES = [("a/b", "a/b", True), ("a/b", "a/c", False),
               ("a/+", "a/b", True), ("a/+", "a/b/c", False),
               ("a/#", "a/b/c", True), ("#", "anything/at/all", True),
               ("a/b/c", "a/b", False)]


@pytest.mark.parametrize("filt,topic,want", TOPIC_CASES)
def test_topic_matching_as_the_jax_package(filt, topic, want):
    assert w.topic_matches(filt, topic) is want
    assert jw.topic_matches(filt, topic) is want


def test_hash_before_the_last_level_matches_nothing_unlike_jax():
    """Departure (MQTT 3.1.1 §4.7.1.2): the JAX package's matcher treats
    'a/#/b' as 'a/#'; the port's matches nothing with it."""
    assert jw.topic_matches("a/#/b", "a/x/y")
    assert not w.topic_matches("a/#/b", "a/x/y")
    assert not w.valid_filter("a/#/b") and not w.valid_filter("a/b#")
    assert w.valid_filter("a/#") and w.valid_filter("#")


def test_broker_pubsub_and_refused_filter():
    with MqttBroker() as broker:
        sub, pub = MiniMqttClient("sub"), MiniMqttClient("pub")
        got, evt = [], threading.Event()

        def on_msg(client, userdata, m):
            got.append((m.topic, bytes(m.payload)))
            evt.set()

        sub.on_message = on_msg
        sub.connect("127.0.0.1", broker.port)
        sub.subscribe("fed/+/up", qos=1)
        with pytest.raises(ValueError, match="0x80"):
            sub.subscribe("fed/#/up")       # departure: refused
        pub.connect("127.0.0.1", broker.port)
        pub.publish("fed/3/up", b"\x00\x01payload", qos=1)
        assert evt.wait(10), "message not routed"
        assert got == [("fed/3/up", b"\x00\x01payload")]
        assert broker.bytes_in > 0 and broker.bytes_out > 0
        sub.disconnect()
        pub.disconnect()


def test_stray_suback_wakes_no_subscriber():
    """Departure: SUBACK is matched by packet id — one carrying another
    id (a late answer to an old SUBSCRIBE) is ignored."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    client = MiniMqttClient("c")

    def fake_broker():
        conn, _ = srv.accept()
        w.read_packet(conn)                          # CONNECT
        conn.sendall(w.make_packet(w.CONNACK, 0, b"\x00\x00"))
        _, _, body = w.read_packet(conn)             # SUBSCRIBE
        (pid,) = struct.unpack_from(">H", body, 0)
        conn.sendall(w.make_packet(w.SUBACK, 0,
                                   struct.pack(">H", pid + 7) + b"\x00"))
        release.wait(10)
        conn.sendall(w.make_packet(w.SUBACK, 0,
                                   struct.pack(">H", pid) + b"\x00"))
        w.read_packet(conn)                          # DISCONNECT
        conn.close()

    release = threading.Event()
    th = threading.Thread(target=fake_broker, daemon=True)
    th.start()
    client.connect("127.0.0.1", port)
    done = threading.Event()
    sub = threading.Thread(target=lambda: (client.subscribe("t"),
                                           done.set()), daemon=True)
    sub.start()
    assert not done.wait(0.5), "a SUBACK of another id woke subscribe()"
    release.set()
    assert done.wait(10)
    client.disconnect()
    srv.close()
    th.join(timeout=5)
    sub.join(timeout=5)


def test_transport_over_real_broker():
    with MqttBroker() as broker:
        a = mt.MqttTransport(0, "127.0.0.1", broker.port)
        b = mt.MqttTransport(1, "127.0.0.1", broker.port)
        assert isinstance(a._client, MiniMqttClient)
        got = []

        class Collect:
            def receive_message(self, msg_type, msg):
                got.append((msg_type, msg))
                b.stop()

        b.add_observer(Collect())
        tree = {"dense": {"kernel": np.arange(12, dtype=np.float32)
                          .reshape(4, 3)}, "steps": np.int32(7)}
        a.send_message(Message(3, 0, 1).add(Message.ARG_MODEL_PARAMS, tree)
                       .add(Message.ARG_NUM_SAMPLES, 55))
        b.run()
        a.stop()
        mtype, msg = got[0]
        assert mtype == 3 and msg.get(Message.ARG_NUM_SAMPLES) == 55
        np.testing.assert_array_equal(
            msg.get(Message.ARG_MODEL_PARAMS)["dense"]["kernel"],
            tree["dense"]["kernel"])


def test_broker_death_wakes_transport():
    broker = MqttBroker()
    t = mt.MqttTransport(0, "127.0.0.1", broker.port)
    try:
        broker.stop()
        with pytest.raises(ConnectionError):
            t.run()
    finally:
        t.stop()


# ---------------------------------------------------------------------------
# federations over the broker
# ---------------------------------------------------------------------------

def _drive(server, silos, transports, finish_s=JOIN_S):
    """Silo actors on threads, the server's loop on one more; fails (never
    hangs) when FINISH does not come.  ``finish_s``: how long the silos
    get to see FINISH after the server's loop ended."""
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
        th.join(timeout=finish_s)
    silos_finished = not any(th.is_alive() for th in threads)
    for t in transports:
        t.stop()
    for th in threads + [st]:
        th.join(timeout=5)
    assert finished, "the server never reached FINISH"
    return silos_finished


def _lr_init(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)},
            "steps": np.int32(7)}


def _train(params, client_idx, round_idx):
    return {k: (np.asarray(v) + np.float32(client_idx + 1)
                if k.startswith("dense") else np.asarray(v))
            for k, v in params.items()}, 10 * (client_idx + 1)


def test_cross_silo_over_tcp_mqtt_equals_the_hub():
    init = params_from_numpy(_lr_init())
    n_total, n, rounds = 10, 4, 3
    hub = LocalHub(codec_roundtrip=True)
    ref = FedAvgServerActor(hub.transport(0), init, n_total, n, rounds)
    ref_silos = [FedAvgClientActor(i, hub.transport(i), _train)
                 for i in range(1, n + 1)]
    for a in [ref] + ref_silos:
        a.register_handlers()
    ref.start()
    hub.pump()
    assert ref.round_idx == rounds
    with MqttBroker() as broker:
        ts = {i: mt.MqttTransport(i, "127.0.0.1", broker.port)
              for i in range(n + 1)}
        history = []
        server = FedAvgServerActor(ts[0], init, n_total, n, rounds,
                                   on_round_done=lambda r, p:
                                   history.append(r))
        silos = [FedAvgClientActor(i, ts[i], _train)
                 for i in range(1, n + 1)]
        assert _drive(server, silos, ts.values())
        per_round = broker.bytes_out / rounds
    assert history == [0, 1, 2]
    assert per_round > 0
    assert all(server.params[k].numpy().tobytes()
               == ref.params[k].numpy().tobytes() for k in ref.params)


def _exact_init():
    return {"dense": {"kernel": np.arange(12, dtype=np.float32)
                      .reshape(4, 3),
                      "bias": np.full(3, -4.0, np.float32)}}


def _t_exact(silo):
    def fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + np.float32(silo)
                for k, v in params.items()}, 2
    return fn


def _j_exact(silo):
    def fn(params, client_idx, round_idx):
        return jax.tree.map(lambda v: np.asarray(v) + np.float32(silo),
                            params), 2
    return fn


N_MIXED, ROUNDS_MIXED = 4, 3


def _all_jax_global():
    hub = JHub(codec_roundtrip=True)
    server = jcs.FedAvgServerActor(hub.transport(0), _exact_init(),
                                   N_MIXED, N_MIXED, ROUNDS_MIXED)
    silos = [jcs.FedAvgClientActor(i, hub.transport(i), _j_exact(i))
             for i in range(1, N_MIXED + 1)]
    for a in [server] + silos:
        a.register_handlers()
    server.start()
    hub.pump()
    return {k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, server.params)).items()}


@pytest.mark.parametrize("server_pkg,jax_silos", [("torch", (1, 2)),
                                                   ("jax", ())])
def test_mixed_federation_over_one_broker(server_pkg, jax_silos):
    want = _all_jax_global()
    with MqttBroker() as broker:
        ts = {}
        for i in range(N_MIXED + 1):
            jax_node = (i == 0 and server_pkg == "jax") or i in jax_silos
            mod = jmt if jax_node else mt
            ts[i] = mod.MqttTransport(i, "127.0.0.1", broker.port)
        if server_pkg == "jax":
            server = jcs.FedAvgServerActor(ts[0], _exact_init(), N_MIXED,
                                           N_MIXED, ROUNDS_MIXED)
        else:
            server = FedAvgServerActor(ts[0],
                                       params_from_numpy(_exact_init()),
                                       N_MIXED, N_MIXED, ROUNDS_MIXED)
        silos = [(jcs.FedAvgClientActor(i, ts[i], _j_exact(i))
                  if i in jax_silos else
                  FedAvgClientActor(i, ts[i], _t_exact(i)))
                 for i in range(1, N_MIXED + 1)]
        # the JAX package's MQTT client closes its socket at once after
        # the FINISH fan-out, which can reset the connection before the
        # broker read it (ROADMAP Queue 3): under a JAX server the silos
        # are stopped after a short wait instead
        silos_finished = _drive(server, silos, ts.values(),
                                finish_s=JOIN_S if server_pkg == "torch"
                                else 2)
    if server_pkg == "torch":
        assert silos_finished
    assert server.round_idx == ROUNDS_MIXED
    got = (params_from_numpy(jax.tree.map(np.asarray, server.params))
           if server_pkg == "jax" else server.params)
    assert {k: v.numpy().tobytes() for k, v in got.items()} == \
        {k: v.tobytes() for k, v in want.items()}
    # the all-JAX global moved by exactly 3 x mean(1..4)
    np.testing.assert_array_equal(
        want["dense/bias"], np.full(3, -4.0 + 3 * 2.5, np.float32))
