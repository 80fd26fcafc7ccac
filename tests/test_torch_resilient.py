"""The port's `ResilientTransport` (``comm/resilient.py``): retry, dead
letters, the send deadline, queue overflow, the stop drain, the
stop-idempotency matrix of every transport flavor, a gRPC receiver
restart and an MQTT reconnect (after ``tests/test_resilient.py``); the
backoff schedule and its seeded jitter equal the JAX package's."""

import socket
import threading
import time

import numpy as np
import pytest

from fedml_tpu.comm.resilient import RetryPolicy as JRetryPolicy
from fedml_tpu_torch.comm.local import LocalHub, LocalTransport
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilient import (ResilientTransport, RetryPolicy,
                                            SendDeadlineExceeded,
                                            SendQueueFull)
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    time.sleep(0.05)
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-", "mqtt-",
                                         "resilient-sender")))]
    assert not leaked, leaked


def free_base_port(n: int) -> int:
    """A port ``p`` with ``p .. p + n - 1`` free on the loopback now, away
    from the fixed ports the JAX package's gRPC tests bind (56210-56311),
    which may run at the same time in another worker."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535 or 56000 <= base + n and base < 57000:
            continue
        try:
            for p in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("", p))
            return base
        except OSError:
            continue
    raise RuntimeError("no free port range")


class _Flaky(Transport):
    """Fails the first ``fail_first`` sends of each message value."""

    def __init__(self, fail_first=0):
        super().__init__()
        self.fail_first = fail_first
        self.attempts = {}
        self.delivered = []
        self.reconnects = 0

    def send_message(self, msg):
        n = self.attempts.get(msg.get("v"), 0)
        self.attempts[msg.get("v")] = n + 1
        if n < self.fail_first:
            raise ConnectionError(f"flaky wire (attempt {n + 1})")
        self.delivered.append(msg.get("v"))

    def reconnect(self):
        self.reconnects += 1

    def run(self):
        pass

    def stop(self):
        pass


def _fast(**kw):
    base = dict(max_attempts=4, base_backoff_s=0.005, max_backoff_s=0.02,
                jitter_frac=0.2, send_deadline_s=5.0)
    base.update(kw)
    return RetryPolicy(**base)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def test_backoff_schedule_and_jitter_match_the_jax_package():
    for kw in (dict(), dict(jitter_frac=0.0), dict(base_backoff_s=0.3,
                                                    backoff_multiplier=3.0,
                                                    max_backoff_s=5.0)):
        ours, theirs = RetryPolicy(**kw), JRetryPolicy(**kw)
        ra, rb = np.random.RandomState(4), np.random.RandomState(4)
        assert [ours.backoff(k, ra) for k in range(8)] == \
            [theirs.backoff(k, rb) for k in range(8)]


def test_retry_recovers_from_transient_failures():
    inner = _Flaky(fail_first=2)
    rt = ResilientTransport(inner, _fast())
    for v in range(3):
        rt.send_message(Message("m", 1, 0).add("v", v))
    assert _wait(lambda: len(inner.delivered) == 3)
    assert inner.delivered == [0, 1, 2]       # FIFO survives retries
    assert rt.retries >= 6 and rt.sent_ok == 3 and rt.dead_letters == 0
    assert inner.reconnects >= 6
    rt.stop()


def test_dead_letter_after_attempts_exhausted_is_counted_by_reason():
    reg = telemetry.enable()
    try:
        inner = _Flaky(fail_first=99)
        letters, fed = [], []
        rt = ResilientTransport(
            inner, _fast(max_attempts=3),
            on_dead_letter=lambda m, e: letters.append((m, e)),
            fault_feed=lambda reason, m: fed.append(reason))
        rt.send_message(Message("m", 1, 0).add("v", 0))
        assert _wait(lambda: rt.dead_letters == 1)
        assert rt.sent_ok == 0 and isinstance(letters[0][1], ConnectionError)
        assert fed == ["send_failed"]
        rt.stop()
        assert "fedml_comm_dead_letter_total" in reg.names()
    finally:
        telemetry.disable()


def test_send_deadline_bounds_total_retry_time():
    inner = _Flaky(fail_first=99)
    letters = []
    rt = ResilientTransport(
        inner, _fast(max_attempts=1000, base_backoff_s=0.05,
                     max_backoff_s=0.05, send_deadline_s=0.2),
        on_dead_letter=lambda m, e: letters.append(e))
    t0 = time.monotonic()
    rt.send_message(Message("m", 1, 0).add("v", 0))
    assert _wait(lambda: letters)
    assert isinstance(letters[0], SendDeadlineExceeded)
    assert time.monotonic() - t0 < 3.0
    rt.stop()


def test_bounded_queue_dead_letters_overflow():
    class _Blocked(Transport):
        def __init__(self):
            super().__init__()
            self.gate = threading.Event()

        def send_message(self, msg):
            self.gate.wait(5)

        def run(self):
            pass

        def stop(self):
            self.gate.set()

    inner = _Blocked()
    letters = []
    rt = ResilientTransport(inner, _fast(), max_in_flight=2,
                            on_dead_letter=lambda m, e: letters.append(e))
    for v in range(8):
        rt.send_message(Message("m", 1, 0).add("v", v))
    assert len(letters) >= 5
    assert all(isinstance(e, SendQueueFull) for e in letters)
    inner.gate.set()
    rt.stop()


def test_stop_drains_queued_messages_one_attempt_each():
    """A FINISH broadcast queued just before stop() still goes out."""
    hub = LocalHub()
    sink = hub.transport(0)
    got = []

    class Collect:
        def receive_message(self, msg_type, msg):
            got.append(msg.get("v"))

    sink.add_observer(Collect())
    rt = ResilientTransport(LocalTransport(hub, 1), _fast())
    for v in range(5):
        rt.send_message(Message("finish", 1, 0).add("v", v))
    rt.stop()
    hub.pump()
    assert got == list(range(5))
    letters = []
    rt.on_dead_letter = lambda m, e: letters.append(e)
    rt.send_message(Message("late", 1, 0))
    assert len(letters) == 1 and "stopped" in str(letters[0])


def test_resilient_passes_observers_and_run_through():
    hub = LocalHub()
    t0, t1 = hub.transport(0), hub.transport(1)
    rt = ResilientTransport(t1, _fast())
    got = []

    class Collect:
        def receive_message(self, msg_type, msg):
            got.append(msg.get("v"))

    rt.add_observer(Collect())
    t0.send_message(Message("m", 0, 1).add("v", 41))
    hub.pump()
    assert got == [41]
    rt.remove_observer(Collect())
    rt.stop()
    rt.stop()


def test_transport_stop_idempotency_matrix():
    """Every transport flavor tolerates double stop and double observer
    removal: local, chaos, resilient, MQTT and gRPC."""
    from fedml_tpu_torch.comm import mqtt_transport as mt
    from fedml_tpu_torch.comm.chaos import ChaosPlan, ChaosTransport
    from fedml_tpu_torch.comm.grpc_transport import GrpcTransport
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker

    class Obs:
        def receive_message(self, msg_type, msg):
            pass

    hub = LocalHub()
    local = hub.transport(0)
    obs = Obs()
    local.add_observer(obs)
    local.remove_observer(obs)
    local.remove_observer(obs)
    flavors = [local, ChaosTransport(hub.transport(1), ChaosPlan()),
               ResilientTransport(LocalTransport(hub, 2), _fast())]
    with MqttBroker() as broker:
        flavors.append(mt.MqttTransport(3, "127.0.0.1", broker.port))
        flavors.append(GrpcTransport(0, {0: "127.0.0.1"},
                                     base_port=free_base_port(1)))
        for t in flavors:
            t.stop()
            t.stop()


def test_grpc_send_survives_receiver_restart():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_transport import GrpcTransport

    base = free_base_port(2)
    table = {0: "127.0.0.1", 1: "127.0.0.1"}
    a = GrpcTransport(0, table, base_port=base, send_timeout_s=0.3)
    rt = ResilientTransport(a, RetryPolicy(
        max_attempts=30, base_backoff_s=0.05, max_backoff_s=0.2,
        send_deadline_s=20.0))
    got = []

    class Collect:
        def receive_message(self, msg_type, msg):
            got.append(msg.get("v"))

    def serve():
        b = GrpcTransport(1, table, base_port=base)
        b.add_observer(Collect())
        th = threading.Thread(target=b.run, daemon=True, name="node-1")
        th.start()
        return b, th

    b, bt = serve()
    try:
        rt.send_message(Message("m", 0, 1).add("v", 1))
        assert _wait(lambda: got == [1])
        b.stop()            # the receiver dies ...
        bt.join(timeout=5)
        rt.send_message(Message("m", 0, 1).add("v", 2))
        time.sleep(0.4)     # ... the send is failing and retrying ...
        b, bt = serve()     # ... and it comes back on the same address
        assert _wait(lambda: len(got) == 2, timeout=15)
        assert got == [1, 2] and rt.retries > 0
    finally:
        rt.stop()
        b.stop()
        bt.join(timeout=5)


def test_mqtt_reconnect_reestablishes_subscription(monkeypatch):
    from fedml_tpu_torch.comm import mqtt_transport as mt
    from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
    monkeypatch.setattr(mt, "HAVE_MQTT", False)
    with MqttBroker() as broker:
        a = mt.MqttTransport(0, "127.0.0.1", broker.port)
        b = mt.MqttTransport(1, "127.0.0.1", broker.port)
        got = []

        class Collect:
            def receive_message(self, msg_type, msg):
                got.append(msg.get("v"))

        b.add_observer(Collect())
        a.send_message(Message("m", 0, 1).add("v", 1))
        a._client._sock.close()      # sever a's socket behind its back
        a.reconnect()
        a.send_message(Message("m", 0, 1).add("v", 2))
        assert _wait(lambda: len(b._inbox.queue) >= 2)
        th = threading.Thread(target=b.run, daemon=True, name="node-1")
        th.start()
        assert _wait(lambda: len(got) == 2)
        b.stop()
        th.join(timeout=5)
        assert got == [1, 2]
        a.stop()
        a.stop()
        b.stop()
