"""The port's multi-worker serving pool (`fedml_tpu_torch.serve.pool`) and
tiered admission: the twins of the JAX package's pool tests.

N accept loops over one registry in both socket modes, no torn or
unpublished answer under concurrent publish, worker-labeled telemetry on
one scrape, best-effort shedding at the soft watermark and on the SAME
SLO verdict as deep-healthz, the worst worker's queue read by the
objective, shed accounting by reason and tier, and the gate's TTL."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.obs.perf import SloEvaluator
from fedml_tpu_torch.serve.batcher import (MicroBatcher, ShedError, TierGate,
                                           best_effort_cap)
from fedml_tpu_torch.serve.pool import ServeWorkerPool
from fedml_tpu_torch.serve.registry import ModelRegistry

DIM, CLASSES = 6, 4


def _registry(history=64):
    return ModelRegistry(
        lambda p, x: x.reshape(x.shape[0], -1) @ p["w"] + p["b"],
        history=history, device="cpu")


def _params(version: int):
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


def _pool(workers=2, version=0, **kw):
    registry = _registry()
    registry.publish(_params(version), version)
    kw.setdefault("max_delay_s", 0.001)
    return registry, ServeWorkerPool(registry, workers=workers, **kw)


def _post(port, payload, conn=None):
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/predict", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    if own:
        conn.close()
    return resp.status, body


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


@pytest.mark.parametrize("reuseport", [True, False])
def test_pool_serves_on_one_port_both_socket_modes(reuseport):
    registry, pool = _pool(workers=3, reuseport=reuseport)
    pool.start()
    try:
        workers_seen = set()
        for _ in range(12):
            status, body = _get(pool.port, "/healthz")
            assert status == 200 and body["workers"] == 3
            assert len(body["queue_depths"]) == 3
            workers_seen.add(body["worker"])
            status, body = _post(pool.port, {"x": _probe_x().tolist()})
            assert status == 200 and body["version"] == 0
            assert _consistent(np.asarray(body["y"]), 0)
        assert workers_seen <= {0, 1, 2}
        assert pool.warmup(_probe_x()) == 3 * 6
    finally:
        pool.stop()


@pytest.mark.parametrize("kw, match", [
    (dict(workers=0), "workers"),
    (dict(batcher_factory=lambda i: None, queue_depth=8), "factory"),
    (dict(batcher_factory=lambda i: None, slo=object()), "slo"),
])
def test_pool_rejects_invalid_workers_and_factory_kwargs(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeWorkerPool(_registry(), **kw)


def test_pool_hot_swap_never_torn_and_versions_published_only():
    registry, pool = _pool(workers=3, queue_depth=512)
    pool.start()
    published = {0}
    errors = []
    stop = threading.Event()

    def reader():
        conn = http.client.HTTPConnection("127.0.0.1", pool.port,
                                          timeout=10)
        last = -1
        while not stop.is_set():
            try:
                status, body = _post(pool.port,
                                     {"x": _probe_x().tolist()}, conn)
            except Exception:  # noqa: BLE001 — re-dial and go on
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", pool.port,
                                                  timeout=10)
                continue
            if status != 200:
                continue
            v, y = body["version"], np.asarray(body["y"])
            if v not in published:
                errors.append(("unpublished version", v))
            if not _consistent(y, v):
                errors.append(("torn", v, y.tolist()))
            if v < last:
                errors.append(("version regression", last, v))
            last = v
        conn.close()

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    for v in range(1, 16):
        published.add(v)
        registry.publish(_params(v), v)
        time.sleep(0.01)
    time.sleep(0.05)
    stop.set()
    for t in readers:
        t.join(timeout=30)
    pool.stop()
    assert not errors, errors[:5]


def test_pool_workers_labeled_on_one_metrics_scrape():
    telemetry.enable()
    server = None
    try:
        registry, pool = _pool(workers=2)
        pool.start()
        for _ in range(8):
            _post(pool.port, {"x": _probe_x().tolist()})
        snap = telemetry.get_registry().snapshot()
        assert snap["gauges"].get("fedml_serve_workers_value") == 2.0
        assert [k for k in snap["gauges"]
                if k.startswith("fedml_serve_queue_utilization_ratio")]
        server = telemetry.start_http_server(0, host="127.0.0.1")
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=10)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        seen = {w for w in ("0", "1")
                if f'fedml_serve_requests_total{{worker="{w}"}}' in text}
        assert seen == {"0", "1"}, seen
        pool.stop()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        telemetry.disable()


def test_best_effort_sheds_at_soft_watermark_interactive_keeps_reserve():
    registry = _registry()
    registry.publish(_params(0), 0)
    batcher = MicroBatcher(registry, queue_depth=4,
                           best_effort_headroom=0.5)
    batcher.submit(_probe_x())
    batcher.submit(_probe_x())
    with pytest.raises(ShedError, match="queue_full"):
        batcher.submit(_probe_x(), tier="best_effort")
    batcher.submit(_probe_x())
    batcher.submit(_probe_x())
    with pytest.raises(ShedError, match="queue_full"):
        batcher.submit(_probe_x())
    with pytest.raises(ValueError, match="unknown tier"):
        batcher.submit(_probe_x(), tier="bulk")
    batcher.stop(drain=False)


def test_tier_gate_and_deep_healthz_read_the_same_verdict():
    telemetry.enable()
    try:
        reg = telemetry.get_registry()
        slo = SloEvaluator(registry=reg)
        registry, pool = _pool(workers=2, queue_depth=4, slo=slo)
        pool.start()
        gate = pool.batchers[0].tier_gate
        assert isinstance(gate, TierGate)
        assert gate is pool.batchers[1].tier_gate   # ONE shared gate
        assert gate.degraded() is False
        reg.gauge("fedml_serve_queue_utilization_ratio",
                  worker="0").set(1.0)
        gate._checked_at = -1e30
        assert gate.degraded() is True
        with pytest.raises(ShedError, match="slo_degraded"):
            pool.batchers[1].submit(_probe_x(), tier="best_effort")
        status, body = _get(pool.port, "/healthz?deep=1")
        assert status == 503 and body["status"] == "slo_breach"
        assert not body["slo"]["serve_queue_utilization_ratio"]["ok"]
        assert pool.batchers[1].submit(_probe_x()) is not None
        pool.stop()
    finally:
        telemetry.disable()


def test_shed_reason_accounting_under_saturation():
    telemetry.enable()
    try:
        registry = _registry()
        registry.publish(_params(0), 0)
        batcher = MicroBatcher(registry, queue_depth=3,
                               best_effort_headroom=1 / 3, worker="7")
        sheds, admitted = {"queue_full": 0}, 0
        for i in range(10):
            try:
                batcher.submit(_probe_x(), tier=("best_effort" if i % 2
                                                 else "interactive"))
                admitted += 1
            except ShedError as e:
                sheds[e.reason] += 1
        assert admitted == 3 and sheds["queue_full"] == 7
        counters = telemetry.get_registry().snapshot()["counters"]
        total = sum(v for k, v in counters.items()
                    if k.startswith("fedml_serve_shed_total")
                    and 'reason="queue_full"' in k and 'worker="7"' in k)
        assert total == 7
        be = sum(v for k, v in counters.items()
                 if k.startswith("fedml_serve_shed_total")
                 and 'tier="best_effort"' in k and 'worker="7"' in k)
        assert be >= 4
        batcher.stop(drain=False)
    finally:
        telemetry.disable()


def test_unbounded_queue_has_no_best_effort_watermark():
    assert best_effort_cap(0, 0.5) is None
    assert best_effort_cap(8, 0.5) == 4
    with pytest.raises(ValueError, match="headroom"):
        best_effort_cap(8, 1.5)
    registry = _registry()
    registry.publish(_params(0), 0)
    batcher = MicroBatcher(registry, queue_depth=0)
    batcher.submit(_probe_x())
    batcher.submit(_probe_x(), tier="best_effort")
    batcher.stop(drain=False)


def test_tier_gate_ttl_caches_the_evaluator():
    calls = []

    class _Slo:
        def evaluate(self, count_breaches=True):
            calls.append(count_breaches)
            return {"x": {"ok": True}}

    gate = TierGate(_Slo(), ttl_s=60.0)
    for _ in range(50):
        assert gate.degraded() is False
    assert calls == [False], "one evaluation, breaches not counted"


def test_tier_gate_survives_a_broken_evaluator():
    class _Broken:
        def evaluate(self, count_breaches=True):
            raise RuntimeError("boom")

    assert TierGate(_Broken()).degraded() is False
