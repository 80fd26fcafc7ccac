"""The port's serving layer (`fedml_tpu_torch.serve`): the twins of the JAX
package's serving tests, and the port's seams.

Bucket padding is invisible, hot swaps never tear a response, deadlines,
full queues and a missing model shed, stop drains, the checkpoint watcher
reads the port's `RoundCheckpointer` (skipping a GC'd, a torn and a
crc-mismatched step), the HTTP surface answers with JAX's status codes,
the CNN's ``/predict`` answer equals JAX's apply on the same params within
1e-5, the cross-silo actor's ``publish`` hook feeds a registry, and
``--serve_port`` serves through the port's CLI on the CPU, behind the JAX
package's flag gates."""

import http.client
import importlib
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu_torch.serve.batcher import MicroBatcher, ShedError
from fedml_tpu_torch.serve.registry import (CheckpointWatcher, ModelRegistry,
                                            module_apply)
from fedml_tpu_torch.serve.server import ServeFrontend

DIM, CLASSES = 6, 4


def _linear_apply(x, p):
    return x.reshape(x.shape[0], -1) @ p["w"] + p["b"]


def _registry(history=8, apply_fn=None):
    return ModelRegistry(apply_fn or (lambda p, x: _linear_apply(x, p)),
                         history=history, device="cpu")


def _params(version: int):
    """Version-fingerprinted params: row 0 of the kernel is the version
    and the bias is onehot(version % CLASSES), so a torn kernel/bias mix
    shows in any response."""
    w = np.zeros((DIM, CLASSES), np.float32)
    w[0, :] = float(version)
    b = np.zeros(CLASSES, np.float32)
    b[version % CLASSES] = 1.0
    return {"w": w, "b": b}


def _consistent(y: np.ndarray, version: int) -> bool:
    return (int(round(float(y.min()))) == version
            and int(np.argmax(y)) == version % CLASSES)


def _probe_x():
    x = np.zeros(DIM, np.float32)
    x[0] = 1.0
    return x


def _stack(buckets=(1, 2, 4, 8), version=0, **kw):
    registry = _registry(history=64)
    registry.publish(_params(version), version)
    return registry, MicroBatcher(registry, buckets=buckets, **kw)


def _slow_registry(sleep_s):
    reg = _registry(apply_fn=lambda p, x: (time.sleep(sleep_s),
                                           _linear_apply(x, p))[1])
    reg.publish(_params(0), 0)
    return reg


# -- the registry ---------------------------------------------------------------

def test_registry_copies_params_onto_its_device():
    """A published snapshot owns tensors on the registry's device: the
    caller's buffers can change afterwards."""
    reg = _registry()
    p = _params(3)
    reg.publish(p, 3)
    p["w"][:] = -1.0
    m = reg.current()
    assert isinstance(m.params["w"], torch.Tensor)
    assert m.params["w"].device == reg.device
    assert _consistent(m.predict(_probe_x()[None])[0], 3)


def test_registry_needs_the_card_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cpu"):
        ModelRegistry(lambda p, x: x)


def test_registry_pin_rollback_and_stale_publish():
    registry = _registry()
    assert registry.current() is None
    registry.publish(_params(0), 0)
    registry.publish(_params(1), 1)
    assert registry.version == 1
    assert registry.rollback() == 0
    assert registry.version == 0 and registry.pinned == 0
    assert registry.publish(_params(2), 2)
    assert registry.version == 0
    registry.unpin()
    assert registry.version == 2 and registry.pinned is None
    registry.pin(1)
    assert registry.version == 1
    assert not registry.publish(_params(1), 1), "stale publish accepted"
    with pytest.raises(KeyError):
        registry.pin(99)


def test_history_eviction_never_drops_pinned_version():
    registry = _registry(history=3)
    for v in range(3):
        registry.publish(_params(v), v)
    registry.rollback()
    for v in range(3, 10):
        registry.publish(_params(v), v)
    assert 1 in registry.versions(), "pinned version evicted"
    assert registry.version == 1
    with pytest.raises(RuntimeError):
        registry.rollback()
    registry.unpin()
    assert registry.version == 9


def test_registry_pin_survives_concurrent_publish_storm():
    registry = _registry(history=3)
    for v in range(3):
        registry.publish(_params(v), v)
    registry.pin(1)
    errors, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            m = registry.current()
            if m is None or m.version != 1:
                errors.append(("lost pin", None if m is None
                               else m.version))
            if 1 not in registry.versions():
                errors.append(("pinned version evicted",))

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for v in range(3, 40):
        registry.publish(_params(v), v)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors[:3]
    assert 1 in registry.versions() and len(registry.versions()) <= 4
    registry.unpin()
    assert registry.version == 39


def test_rollback_on_fully_evicted_history_fails_loudly():
    registry = _registry(history=2)
    for v in range(6):
        registry.publish(_params(v), v)
    registry.rollback()
    assert registry.version == 4
    registry.unpin()
    for v in range(6, 12):
        registry.publish(_params(v), v)
    registry.rollback()
    with pytest.raises(RuntimeError, match="cannot rollback"):
        registry.rollback()
    assert registry.current() is not None


# -- the batcher ------------------------------------------------------------------

def test_bucket_padding_invariance():
    """3 requests padded up to the 8-bucket return EXACTLY an unpadded
    direct apply's rows."""
    registry, batcher = _stack(buckets=(8,), max_delay_s=0.05)
    batcher.start()
    rng = np.random.RandomState(0)
    xs = [rng.randn(DIM).astype(np.float32) for _ in range(3)]
    outs = [f.result(10) for f in [batcher.submit(x) for x in xs]]
    direct = registry.current().predict(np.stack(xs))
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out.y, direct[i], atol=1e-6)
        assert out.version == 0
    batcher.stop()


def test_requests_coalesce_into_one_bucket():
    from fedml_tpu_torch.obs import telemetry
    telemetry.enable()
    try:
        registry, batcher = _stack(max_delay_s=0.02)
        futs = [batcher.submit(_probe_x()) for _ in range(8)]
        batcher.start()
        for f in futs:
            f.result(10)
        stats = batcher._h_occupancy.stats()
        assert stats["max"] == 8.0, f"burst never coalesced: {stats}"
        batcher.stop()
    finally:
        telemetry.disable()


def test_hot_swap_no_torn_reads_and_monotone_versions():
    registry, batcher = _stack(max_delay_s=0.001, queue_depth=512)
    batcher.start()
    assert batcher.warmup(_probe_x()) == 4
    stop = threading.Event()
    errors, seqs = [], []

    def reader():
        seq = []
        while not stop.is_set():
            try:
                r = batcher.predict(_probe_x(), timeout=10)
            except ShedError:
                continue
            if not _consistent(np.asarray(r.y), r.version):
                errors.append((np.asarray(r.y), r.version))
            seq.append(r.version)
        seqs.append(seq)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    for v in range(1, 16):
        time.sleep(0.01)
        registry.publish(_params(v), v)
    time.sleep(0.02)
    stop.set()
    for t in readers:
        t.join(timeout=10)
    batcher.stop()
    assert not errors, f"torn reads: {errors[:3]}"
    for seq in seqs:
        assert seq == sorted(seq), "reader observed a version regression"
    assert max(max(s) for s in seqs if s) == 15


@pytest.mark.parametrize("case", ["deadline", "queue_full", "no_model"])
def test_shedding(case):
    """A request whose deadline expires in the queue is shed, not served
    late; a full queue sheds at submit; an empty registry sheds."""
    if case == "deadline":
        batcher = MicroBatcher(_slow_registry(0.08), buckets=(1,),
                               max_delay_s=0.0).start()
        blocker = batcher.submit(_probe_x())
        doomed = batcher.submit(_probe_x(), deadline_s=0.01)
        with pytest.raises(ShedError, match="deadline"):
            doomed.result(10)
        assert blocker.result(10).version == 0
        assert batcher.submit(_probe_x(), deadline_s=5.0).result(
            10).version == 0
        batcher.stop()
    elif case == "queue_full":
        _, batcher = _stack(queue_depth=2)
        batcher.submit(_probe_x())
        batcher.submit(_probe_x())
        with pytest.raises(ShedError, match="queue_full"):
            batcher.submit(_probe_x())
        batcher.stop(drain=False)
    else:
        batcher = MicroBatcher(_registry(), buckets=(1,)).start()
        with pytest.raises(ShedError, match="no_model"):
            batcher.predict(_probe_x(), timeout=10)
        batcher.stop()


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_sheds_queued_requests(drain):
    registry, batcher = _stack(buckets=(1, 2, 4), max_delay_s=0.001)
    futs = [batcher.submit(_probe_x()) for _ in range(10)]
    if drain:
        batcher.start()
    batcher.stop(drain=drain)
    for f in futs:
        if drain:
            assert _consistent(np.asarray(f.result(0).y), 0)
        else:
            with pytest.raises(ShedError, match="shutdown"):
                f.result(0)
    with pytest.raises(ShedError, match="shutdown"):
        batcher.submit(_probe_x())


def test_malformed_instance_fails_only_its_own_request():
    registry, batcher = _stack(buckets=(4,), max_delay_s=0.01)
    good = [batcher.submit(_probe_x()) for _ in range(2)]
    bad = batcher.submit(np.zeros(3, np.float32))
    batcher.start()
    for f in good:
        assert f.result(10).version == 0
    with pytest.raises(ValueError, match="does not match"):
        bad.result(10)
    bad_first = batcher.submit(np.zeros(3, np.float32))
    good_after = [batcher.submit(_probe_x()) for _ in range(2)]
    with pytest.raises(ValueError, match="does not match"):
        bad_first.result(10)
    for f in good_after:
        assert f.result(10).version == 0
    batcher.stop()


def test_cancelled_future_does_not_kill_worker():
    registry, batcher = _stack(buckets=(4,), max_delay_s=0.01)
    futs = [batcher.submit(_probe_x()) for _ in range(4)]
    assert futs[0].cancel()
    batcher.start()
    for f in futs[1:]:
        assert f.result(10).version == 0
    assert batcher.predict(_probe_x(), timeout=10).version == 0
    batcher.stop()


def test_predict_runs_under_inference_mode():
    seen = []

    def apply_fn(p, x):
        seen.append(torch.is_inference_mode_enabled())
        return _linear_apply(x, p)

    reg = _registry(apply_fn=apply_fn)
    reg.publish(_params(0), 0)
    batcher = MicroBatcher(reg, buckets=(1, 2)).start()
    assert batcher.warmup(_probe_x()) == 2
    batcher.predict(_probe_x(), timeout=10)
    batcher.stop()
    assert seen and all(seen)


# -- the checkpoint watcher --------------------------------------------------------

def _ck_state(i):
    rng = np.random.RandomState(i)
    return {"params": {"w": rng.randn(DIM, CLASSES).astype(np.float32),
                       "b": rng.randn(CLASSES).astype(np.float32)},
            "round_idx": np.asarray(i, np.int64)}


def test_watcher_publishes_rounds_and_tolerates_gc(tmp_path):
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    ck_dir = str(tmp_path / "ck")
    ck = RoundCheckpointer(ck_dir, save_every=1, keep_last_n=2)
    registry = _registry(history=16)
    watcher = CheckpointWatcher(registry, ck_dir, poll_s=0.05)
    assert watcher.poll_once() == 0
    ck.save(0, _ck_state(0))
    ck.save(1, _ck_state(1))
    assert watcher.poll_once() == 2 and registry.version == 1
    ck.save(2, _ck_state(2))
    ck.save(3, _ck_state(3))
    steps = sorted(n for n in os.listdir(ck_dir) if n.isdigit())
    assert steps == ["2", "3"], f"keep_last_n GC kept {steps}"
    os.makedirs(os.path.join(ck_dir, "7"))     # vanished between list and
    assert watcher.poll_once() == 2            # load: skipped, not fatal
    assert registry.version == 3 and watcher._seen == 7
    np.testing.assert_allclose(
        registry.current().params["w"].numpy(), _ck_state(3)["params"]["w"])
    ck.close()


@pytest.mark.parametrize("damage", ["crc", "torn_manifest", "torn_state"])
def test_watcher_skips_damaged_steps(tmp_path, damage):
    """A crc mismatch, a torn manifest or a truncated state file skips
    the step (sticky, no spin) and serving stays on the last good one."""
    from fedml_tpu_torch.utils.checkpoint import (STATE_FILE,
                                                  RoundCheckpointer,
                                                  manifest_path)
    ck_dir = str(tmp_path / "ck")
    ck = RoundCheckpointer(ck_dir, save_every=1)
    ck.save(0, _ck_state(0))
    ck.save(1, _ck_state(1))
    ck.close()
    if damage == "crc":
        m = json.load(open(manifest_path(ck_dir, 1)))
        m["crc"]["params"] += 1
        with open(manifest_path(ck_dir, 1), "w") as f:
            json.dump(m, f)
    elif damage == "torn_manifest":
        with open(manifest_path(ck_dir, 1), "w") as f:
            f.write('{"step": 1, "algo": "crc32", "crc": {"par')
    else:
        path = os.path.join(ck_dir, "1", STATE_FILE)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    reg = _registry()
    w = CheckpointWatcher(reg, ck_dir, poll_s=0.05)
    assert w.poll_once() == 1 and reg.version == 0
    assert w.poll_once() == 0


def test_watcher_crc_equals_the_manifest(tmp_path):
    """The manifest's crc and the loaded params' are one function (the
    JAX package's `tree_crc` order)."""
    from fedml_tpu.utils.journal import tree_crc as j_tree_crc
    from fedml_tpu_torch.utils.checkpoint import (RoundCheckpointer,
                                                  manifest_path)
    ck_dir = str(tmp_path / "ck")
    ck = RoundCheckpointer(ck_dir, save_every=1)
    ck.save(0, _ck_state(0))
    ck.close()
    m = json.load(open(manifest_path(ck_dir, 0)))
    assert m["crc"]["params"] == j_tree_crc(_ck_state(0)["params"])
    reg = _registry()
    assert CheckpointWatcher(reg, ck_dir).poll_once() == 1


# -- the HTTP frontend ---------------------------------------------------------------

def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, json.loads(body) if body.startswith(b"{") else body


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def test_http_frontend_lifecycle():
    registry = _registry()
    batcher = MicroBatcher(registry, buckets=(1, 2, 4), max_delay_s=0.001)
    frontend = ServeFrontend(registry, batcher, port=0).start()
    port = frontend.port
    try:
        status, body = _get(port, "/healthz")
        assert status == 503 and body["status"] == "no_model"
        status, body = _post(port, "/predict", {"x": _probe_x().tolist()})
        assert status == 503 and body["reason"] == "no_model"
        registry.publish(_params(4), 4)
        status, body = _get(port, "/healthz")
        assert status == 200 and body["version"] == 4
        assert _get(port, "/healthz?probe=1")[0] == 200
        status, body = _get(port, "/healthz?deep=1")
        assert status == 200 and body["deep"] == "unconfigured"
        status, body = _post(port, "/predict", {"x": _probe_x().tolist()})
        assert status == 200 and body["version"] == 4
        assert _consistent(np.asarray(body["y"]), 4)
        status, body = _get(port, "/version")
        assert status == 200 and body["version"] == 4
        assert body["history"] == [4] and body["canaries"] == []
        assert _post(port, "/predict", {"wrong_key": 1})[0] == 400
        assert _post(port, "/predict", {"x": _probe_x().tolist(),
                                        "deadline_ms": "fast"})[0] == 400
        assert _post(port, "/predict", {"x": _probe_x().tolist(),
                                        "tier": "bulk"})[0] == 400
        assert _post(port, "/predict", {"x": [1.0, 2.0]})[0] == 400
        assert _get(port, "/nope")[0] == 404
        assert _post(port, "/nope", {"x": [1]})[0] == 404
    finally:
        frontend.stop()
    with pytest.raises(ShedError, match="shutdown"):
        batcher.submit(_probe_x())


def test_http_metrics_endpoint():
    from fedml_tpu_torch.obs import telemetry
    telemetry.enable()
    try:
        registry = _registry()
        registry.publish(_params(1), 1)
        batcher = MicroBatcher(registry, buckets=(1,), max_delay_s=0.001)
        frontend = ServeFrontend(registry, batcher, port=0).start()
        try:
            _post(frontend.port, "/predict", {"x": _probe_x().tolist()})
            conn = http.client.HTTPConnection("127.0.0.1", frontend.port,
                                              timeout=10)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
        finally:
            frontend.stop()
        assert "fedml_serve_requests_total 1" in text
        assert "fedml_serve_model_version_total 1" in text
    finally:
        telemetry.disable()


def test_http_keepalive_two_requests_one_connection():
    registry = _registry()
    registry.publish(_params(2), 2)
    batcher = MicroBatcher(registry, buckets=(1, 2), max_delay_s=0.001)
    frontend = ServeFrontend(registry, batcher, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", frontend.port,
                                          timeout=10)
        conn.connect()
        sock_before = conn.sock
        for _ in range(2):
            conn.request("POST", "/predict",
                         json.dumps({"x": _probe_x().tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.version == 11
            body = resp.read()
            assert int(resp.getheader("Content-Length")) == len(body)
            assert json.loads(body)["version"] == 2
        assert conn.sock is sock_before, "connection was re-dialed"
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200
        assert int(resp.getheader("Content-Length")) == len(resp.read())
        conn.close()
    finally:
        frontend.stop()


def test_http_deadline_propagates_to_429():
    registry = _slow_registry(0.1)
    batcher = MicroBatcher(registry, buckets=(1,), max_delay_s=0.0)
    frontend = ServeFrontend(registry, batcher, port=0).start()
    port = frontend.port
    try:
        blocker = threading.Thread(
            target=_post, args=(port, "/predict",
                                {"x": _probe_x().tolist()}))
        blocker.start()
        time.sleep(0.03)
        status, body = _post(port, "/predict",
                             {"x": _probe_x().tolist(), "deadline_ms": 5})
        blocker.join(timeout=10)
        assert status == 429 and body["reason"] == "deadline"
    finally:
        frontend.stop()


# -- the CNN against JAX --------------------------------------------------------------

def test_cnn_predict_equals_jax_apply():
    """The FEMNIST CNN served over HTTP: every answer within 1e-5 of the
    JAX package's apply on the same params."""
    from fedml_tpu.experiments.models import create_workload as j_workload
    from fedml_tpu_torch.experiments.models import create_workload
    from fedml_tpu_torch.utils.jax_params import params_from_numpy
    jwl = j_workload("cnn_fedavg", "femnist", 62, (28, 28, 1))
    rng = np.random.RandomState(0)
    x = rng.rand(5, 28, 28, 1).astype(np.float32)
    jp = jwl.init(jax.random.key(1), {"x": x[:1]})
    want = np.asarray(jwl.apply(jp, x))
    twl = create_workload("cnn_fedavg", "femnist", 62, (28, 28, 1))
    registry = ModelRegistry(module_apply(twl.model), device="cpu")
    registry.publish(params_from_numpy(jax.tree.map(np.asarray, jp)), 1)
    batcher = MicroBatcher(registry, buckets=(1, 2, 4, 8),
                           max_delay_s=0.005)
    frontend = ServeFrontend(registry, batcher, port=0).start()
    try:
        assert batcher.warmup(x[0]) == 4
        got = [_post(frontend.port, "/predict", {"x": row.tolist()})
               for row in x]
    finally:
        frontend.stop()
    assert all(s == 200 and b["version"] == 1 for s, b in got)
    y = np.asarray([b["y"] for _, b in got], np.float32)
    assert np.abs(y - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# -- the seams: the actor's hook, the CLI ---------------------------------------------

def test_serve_while_train_publish_hook():
    """The cross-silo actor's publish hook feeds a registry every round:
    versions advance and the last global serves."""
    from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                       FedAvgServerActor)
    from fedml_tpu_torch.comm.local import LocalHub
    from fedml_tpu_torch.utils.jax_params import params_from_numpy
    init = params_from_numpy({"dense": {"kernel": np.zeros((4, 3),
                                                           np.float32)}})

    def train_fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + 1.0 for k, v in params.items()}, 10

    registry = ModelRegistry(lambda p, x: x, history=8, device="cpu")
    hub = LocalHub()
    server = FedAvgServerActor(hub.transport(0), init, 2, 2, 3,
                               publish=registry.publish)
    clients = [FedAvgClientActor(i, hub.transport(i), train_fn)
               for i in (1, 2)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    server.start()
    hub.pump()
    server.finish()
    assert registry.versions() == [0, 1, 2] and registry.version == 2
    np.testing.assert_allclose(
        registry.current().params["dense"]["kernel"].numpy(),
        np.full((4, 3), 3.0))


def test_publish_hook_fires_on_resume(tmp_path):
    """A server resumed from its checkpoint publishes the restored global
    once, as the JAX actor does."""
    from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                       FedAvgServerActor)
    from fedml_tpu_torch.comm.local import LocalHub
    from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
    from fedml_tpu_torch.utils.jax_params import params_from_numpy
    init = params_from_numpy({"dense": {"kernel": np.zeros((2, 2),
                                                           np.float32)}})

    def train_fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + 1.0 for k, v in params.items()}, 10

    seen = []
    for rounds in (2, 3):
        hub = LocalHub()
        ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
        server = FedAvgServerActor(
            hub.transport(0), init, 2, 2, rounds, checkpointer=ck,
            publish=lambda p, v: seen.append(
                (v, float(p["dense"]["kernel"][0, 0]))))
        clients = [FedAvgClientActor(i, hub.transport(i), train_fn)
                   for i in (1, 2)]
        server.register_handlers()
        for c in clients:
            c.register_handlers()
        server.start()
        hub.pump()
        server.finish()
        ck.close()
    assert seen == [(0, 1.0), (1, 2.0), (1, 2.0), (2, 3.0)]


_CS = ["--algo", "cross_silo", "--silo_backend", "local", "--model", "lr",
       "--dataset", "mnist", "--client_num_in_total", "8",
       "--client_num_per_round", "2", "--batch_size", "4",
       "--platform", "cpu", "--log_stdout", "false"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_while_training(tmp_path):
    """``--serve_port`` through the port's CLI on the CPU: the frontend
    answers /predict during the run with the published version, the
    gated path writes its release journal, and the run drains it."""
    t_main = importlib.import_module("fedml_tpu_torch.experiments.main")
    answers = []
    real = t_main.ServeWhileTrain.publish

    def publish(self, params, version):
        real(self, params, version)
        answers.append(_post(self.port, "/predict",
                             {"x": self._sample_x.tolist(),
                              "deadline_ms": 10000}))

    t_main.ServeWhileTrain.publish = publish
    try:
        out = t_main.main(_CS + [
            "--comm_round", "2", "--serve_port", str(_free_port()),
            "--release_gate", "true", "--release_shadow_every", "1",
            "--run_dir", str(tmp_path)])
    finally:
        t_main.ServeWhileTrain.publish = real
    assert out["params_finite"]
    assert [s for s, _ in answers] == [200, 200]
    assert answers[0][1]["version"] == 0
    lines = [json.loads(line) for line in
             open(tmp_path / "release.jsonl").read().splitlines()]
    assert [v["version"] for v in lines] == [0, 1]
    assert lines[0]["decision"] == "promote"


def test_serve_block_on_port_zero_binds_an_ephemeral_port():
    """Built in code with port 0 (the CLI serves only for > 0), the
    block binds a free port and answers 503 before its first publish."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (ServeWhileTrain,
                                                  _make_workload,
                                                  load_experiment_data)
    from fedml_tpu_torch.parallel.cohort import cohort_eval
    from fedml_tpu_torch.trainer.local_sgd import make_evaluator
    cfg = config_from_argv(_CS)
    data = load_experiment_data(cfg)
    evaluator = cohort_eval(make_evaluator(_make_workload(cfg, data)))
    serving = ServeWhileTrain(cfg, data, "cpu", evaluator)
    try:
        assert serving.port > 0
        assert _get(serving.port, "/healthz")[0] == 503
    finally:
        serving.stop()


def test_release_scorer_equals_jax():
    """The gate's held-out score of a published (nested numpy) global is
    the JAX package's ``_release_eval_fn`` score on the same params and
    test split."""
    from fedml_tpu.experiments.models import create_workload as j_workload
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (ServeWhileTrain,
                                                  _make_workload,
                                                  load_experiment_data)
    from fedml_tpu_torch.parallel.cohort import cohort_eval
    from fedml_tpu_torch.trainer.local_sgd import make_evaluator
    cfg = config_from_argv(_CS)
    data = load_experiment_data(cfg)
    x0 = np.asarray(data.train["x"][0, 0, :1])
    jwl = j_workload("lr", "mnist", data.class_num, x0.shape[1:])
    host = jax.tree.map(np.asarray,
                        jwl.init(jax.random.key(3), {"x": x0}))
    want = j_main._release_eval_fn(jwl, data)(host)
    score = ServeWhileTrain._scorer(
        cohort_eval(make_evaluator(_make_workload(cfg, data))), data, "cpu")
    assert 0.0 < want < 1.0
    assert score(host) == pytest.approx(want, abs=1e-7)


j_main = importlib.import_module("fedml_tpu.experiments.main")


@pytest.mark.parametrize("flags, match", [
    (["--algo", "fedavg", "--serve_port", "8351"], "serve_port"),
    (["--serve_workers", "2"], "serve_port"),
    (["--serve_port", "8351", "--serve_workers", "0"], "serve_workers"),
    (["--serve_port", "8351", "--serve_best_effort_headroom", "1.5"],
     "best_effort_headroom"),
    (["--release_gate", "true"], "--release_gate"),
    (["--release_gate", "true", "--serve_port", "18099",
      "--release_shadow_every", "0"], "release_shadow"),
])
def test_serve_flag_gates_match_jax(flags, match):
    """Each gate fails on the port's CLI as on the JAX package's."""
    from fedml_tpu_torch.experiments.main import main
    argv = ["--algo", "cross_silo", "--platform", "cpu"] + flags
    with pytest.raises(ValueError, match=match):
        main(argv)
    with pytest.raises(ValueError, match=match):
        j_main.main([a for a in argv if a not in ("--platform", "cpu")])
