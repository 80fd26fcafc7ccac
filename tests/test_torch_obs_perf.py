"""The port's perf flight recorder (``obs/perf.py``), critical-path
observatory (``obs/critical_path.py``), recompile sentry and SLO
evaluator against the JAX package.

* A 2-round live cross-silo federation (3 silos, stream mode, admission
  on, health on, the codec hub) ledgers ``perf.jsonl`` lines with JAX's
  keys and phase names in both packages; their wire bytes, quorum and
  global CRC are equal (exact — the frames and the unclipped stream
  globals are byte-equal), and timing fields are not compared.
* JAX's own validators (``trend.validate_ledger``,
  ``critical_path.validate_record``) accept the port's lines, and the
  port's validators agree with JAX's on good and damaged rows.
* ``RecompileSentry(strict=True)`` raises after a `GraphedRounds`
  re-capture, naming the argument whose shape changed.
* The SLO evaluator gives JAX's verdicts on the same registry events
  (exact); the metric names of the port obey JAX's ``NAME_RE`` and cover
  JAX's canonical list for every module the port has.
"""

import importlib
import json
import pathlib
import sys

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as j_cross_silo
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.core.stream_agg import StreamingAggregator as JStream
from fedml_tpu.obs import critical_path as j_cpath
from fedml_tpu.obs import health as j_health
from fedml_tpu.obs import perf as j_perf
from fedml_tpu.obs import telemetry as j_tel
from fedml_tpu.obs import trend as j_trend
from fedml_tpu.robust import AdmissionPipeline as JAdmission
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.core.pytree import nest, to_host, tree_keys
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.obs import (DeviceRecorder, HealthAccumulator,
                                 PerfRecorder, RecompileError,
                                 critical_path, perf, telemetry, trend)
from fedml_tpu_torch.parallel.cohort import GraphedRounds
from fedml_tpu_torch.robust import AdmissionPipeline
from fedml_tpu_torch.utils import journal
from fedml_tpu_torch.utils.jax_params import params_from_numpy

ROUNDS, SILOS = 2, 3


def _params():
    rng = np.random.RandomState(3)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)}}


def _update(silo, round_idx, v):
    rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
    return (np.asarray(v) + rng.randn(*np.shape(v)).astype(np.float32)
            * 0.1).astype(np.float32)


@pytest.fixture
def registries():
    reg_t, reg_j = telemetry.enable(), j_tel.enable()
    yield reg_t, reg_j
    telemetry.disable()
    j_tel.disable()


def _j_run(tmp):
    rec = j_perf.PerfRecorder(str(tmp / "j" / "perf.jsonl"))
    health = j_health.HealthAccumulator(
        kind="params", ledger_path=str(tmp / "j" / "health.jsonl"))
    hub = JHub(codec_roundtrip=True)
    init = _params()
    server = j_cross_silo.FedAvgServerActor(
        hub.transport(0), init, SILOS, SILOS, ROUNDS,
        stream_agg=JStream(init, method="mean"),
        admission=JAdmission(init, kind="params"), perf=rec, health=health)
    silos = [j_cross_silo.FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r, i=i: (jax.tree.map(lambda v: _update(i, r, v), p),
                              10 + i))
        for i in range(1, SILOS + 1)]
    _drive(hub, server, silos)
    rec.close()
    return server


def _t_run(tmp, device=None):
    rec = PerfRecorder(str(tmp / "t" / "perf.jsonl"), device=device)
    health = HealthAccumulator(
        kind="params", ledger_path=str(tmp / "t" / "health.jsonl"))
    hub = LocalHub(codec_roundtrip=True)
    init = params_from_numpy(_params())
    server = FedAvgServerActor(
        hub.transport(0), init, SILOS, SILOS, ROUNDS,
        stream_agg=StreamingAggregator(init, method="mean"),
        admission=AdmissionPipeline(to_host(nest(init)), kind="params"),
        perf=rec, health=health)
    silos = [FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r, i=i: ({k: _update(i, r, p[k])
                               for k in tree_keys(p)}, 10 + i))
        for i in range(1, SILOS + 1)]
    _drive(hub, server, silos)
    rec.close()
    return server


def _drive(hub, server, silos):
    server.register_handlers()
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    server.finish()


def _rows(path):
    return trend.load_ledger(str(path))


def test_perf_ledger_matches_jax(tmp_path, registries):
    _j_run(tmp_path)
    _t_run(tmp_path)
    want, got = _rows(tmp_path / "j/perf.jsonl"), _rows(tmp_path /
                                                         "t/perf.jsonl")
    assert len(got) == len(want) == ROUNDS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert set(g["phases"]) == set(w["phases"])
        assert set(g["phases"]) <= set(perf.PHASES)
        for key in ("round", "quorum", "dropped", "global_crc", "wire",
                    "recompiles", "node"):
            assert g[key] == w[key], key
        assert g["wire"]["bytes_in"] > 0 and g["wire"]["bytes_out"] > 0
        assert set(g["critical_path"]) == set(w["critical_path"])
        assert g["critical_path"]["uploads"] == \
            w["critical_path"]["uploads"] == SILOS
    # JAX's validators accept the port's ledger, and the port's agree
    assert j_trend.validate_ledger(got) == [] == trend.validate_ledger(got)
    for row in got:
        assert j_cpath.validate_record(row["critical_path"]) == [] == \
            critical_path.validate_record(row["critical_path"])
    health = _rows(tmp_path / "t/health.jsonl")
    assert j_trend.validate_health_ledger(health) == [] == \
        trend.validate_health_ledger(health)


@pytest.mark.parametrize("damage", ["missing_wire", "mfu", "binding",
                                    "coverage", "health_alarm"])
def test_validators_agree_with_jax_on_damage(damage):
    row = {"round": 0, "phases": {}, "recompiles": 0,
           "wire": {"bytes_in": 0, "bytes_out": 0},
           "critical_path": {"binding": "fold", "attribution": {"fold": 1.0},
                             "coverage": 1.0, "round_s": 1.0},
           "device": {"memory": None, "compiles": [], "mfu": 0.5}}
    health = {"round": 0, "uploads": 1, "accepted": 1, "rejected": 0,
              "norm": {"count": 1, "mean": 1.0, "std": 0.0, "min": 1.0,
                       "max": 1.0}, "alignment": {}, "silos": {},
              "alarms": {"a": {"ok": True, "threshold": 1.0}}}
    if damage == "missing_wire":
        del row["wire"]
    elif damage == "mfu":
        row["device"]["mfu"] = 1.5
    elif damage == "binding":
        row["critical_path"]["binding"] = "gpu"
    elif damage == "coverage":
        row["critical_path"]["coverage"] = 0.5
    else:
        health["alarms"]["a"] = {"value": 2.0}
    assert trend.validate_ledger([row]) == j_trend.validate_ledger([row])
    assert trend.validate_health_ledger([health]) == \
        j_trend.validate_health_ledger([health])
    assert trend.validate_ledger([row]) or \
        trend.validate_health_ledger([health])


def test_strict_sentry_names_the_shape_after_a_recapture(tmp_path):
    """A `GraphedRounds` whose round call re-captures for a new cohort
    shape after round 0: the strict sentry raises, naming the argument."""
    graph = GraphedRounds.__new__(GraphedRounds)   # no card: no capture
    graph.captures = 0
    shapes = set()

    def run(stacked):
        if stacked.shape not in shapes:   # a new shape: a new graph
            shapes.add(stacked.shape)
            graph.captures += 1
        return stacked

    run._cache_size = graph._cache_size
    rec = PerfRecorder(str(tmp_path / "perf.jsonl"), strict_recompiles=True,
                       device=DeviceRecorder())
    fn = rec.instrument_jit("graphed_rounds", run)
    try:
        for r, n in enumerate((4, 4)):
            rec.round_start(r)
            fn(np.zeros((n, 3), np.float32))
            line = rec.round_end(r)
            assert line["recompiles"] == 0
            assert [c["fn"] for c in line["device"]["compiles"]] == (
                ["graphed_rounds"] if r == 0 else [])
        rec.round_start(2)
        fn(np.zeros((5, 3), np.float32))
        with pytest.raises(RecompileError,
                           match=r"float32\[4,3\] -> float32\[5,3\]"):
            rec.round_end(2)
    finally:
        rec.close()
    assert graph.captures == 2


def test_ledger_disk_fault_disables_the_ledger_only(tmp_path):
    def hook(channel, path, data):
        if channel == "perf_ledger":
            raise OSError(28, "No space left on device")

    journal.install_disk_faults(hook)
    try:
        rec = PerfRecorder(str(tmp_path / "perf.jsonl"))
        for r in range(2):
            rec.round_start(r)
            assert rec.round_end(r)["round"] == r   # the rounds go on
        rec.close()
    finally:
        journal.clear_disk_faults()
    assert not (tmp_path / "perf.jsonl").exists()
    # one ledger, one run: a leftover file rotates to .prev
    (tmp_path / "perf.jsonl").write_text("old\n")
    PerfRecorder(str(tmp_path / "perf.jsonl")).close()
    assert (tmp_path / "perf.jsonl.prev").read_text() == "old\n"


def test_slo_evaluator_matches_jax(registries):
    reg_t, reg_j = registries
    for reg in registries:
        h = reg.histogram("fedml_round_duration_seconds")
        for v in (0.2, 0.4, 3.0, 80.0):
            h.observe(v)
        reg.counter("fedml_comm_recv_total").inc(100)
        reg.counter("fedml_wire_torn_frames_total").inc(3)
        reg.counter("fedml_robust_quarantine_events_total").inc(1)
        reg.gauge("fedml_health_norm_cv_ratio").set(1.7)
    spec = "round_duration_p95_seconds=10,health_norm_cv_ratio=2.0"
    assert perf.parse_slo_spec(spec) == j_perf.parse_slo_spec(spec)
    got = perf.SloEvaluator(reg_t, perf.parse_slo_spec(spec)).evaluate()
    want = j_perf.SloEvaluator(reg_j,
                               j_perf.parse_slo_spec(spec)).evaluate()
    assert got == want
    assert not got["round_duration_p95_seconds"]["ok"]
    with pytest.raises(ValueError, match="unknown SLO"):
        perf.parse_slo_spec("round_p95=1")
    assert perf.DEFAULT_SLOS == j_perf.DEFAULT_SLOS
    assert perf.PHASES == j_perf.PHASES
    stats = {"count": 4, "buckets": {"0.5": 2, "5": 1, "+Inf": 1},
             "max": 80.0}
    for q in (0.25, 0.5, 0.75, 0.95):
        assert perf.histogram_quantile(stats, q) == \
            j_perf.histogram_quantile(stats, q)


def _metric_names(pkg: pathlib.Path, rx):
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        src = path.read_text()
        for r in rx:
            for m in r.finditer(src):
                if m.group(1) != "name":
                    out.setdefault(m.group(1), set()).add(
                        str(path.relative_to(pkg)))
    return out


def test_metric_names_obey_jax_regex_and_cover_its_list():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    naming = importlib.import_module("test_metric_naming")
    root = pathlib.Path(__file__).resolve().parent.parent
    rx = (naming._REG_CALL, naming._LINK_CALL)
    port = _metric_names(root / "fedml_tpu_torch", rx)
    ref = _metric_names(root / "fedml_tpu", rx)
    assert port
    bad = sorted(n for n in port if not naming.NAME_RE.match(n))
    assert not bad, bad
    # every canonical name JAX registers in a module the port has
    want = {n for n in naming.EXPECTED
            if any((root / "fedml_tpu_torch" / f).exists()
                   for f in ref.get(n, ()))}
    assert want - set(port) == set()
    assert {"fedml_perf_mfu_ratio", "fedml_dev_compiles_total",
            "fedml_health_rounds_total", "fedml_adapt_decisions_total",
            "fedml_ingest_queue_depth_value"} <= set(port)
