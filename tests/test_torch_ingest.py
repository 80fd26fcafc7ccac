"""The port's pipelined ingest (``fedml_tpu_torch/comm/ingest.py``) and
its seams.

* The arena: a frame staged from its raw header and from its decoded
  tree screens the same; a frame whose header differs from the template,
  or whose buffer is torn, is structural damage; the device screen's
  ``sum((flat − ref)²)`` in f32 is within 1e-6 (relative) of the host f64
  screen and of the JAX package's arena; every staged leaf starts 16-byte
  aligned; one copy per staged upload.
* The ``pre=`` seams: `AdmissionPipeline.admit` and
  `ShardAdmission.offer` give the host screen's verdicts.
* The pipeline: overflow dead-letters as a network fault through the
  fault feed (never a strike), a dead worker fails ``drain``.
* Parity: the pipelined global is BIT-IDENTICAL to the inline one on the
  replicated and sharded cross-silo paths (the CLI's runner, the LR twin,
  clip and noise on), on async_fl and on the cross-device waves (with a
  poisoned wave rejected).
* The gates refuse what the JAX package's refuse, with its messages.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.comm.ingest import IngestArena as JArena
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu_torch.comm.ingest import (OVERFLOW_REASON, ArenaScreen,
                                         IngestArena, IngestPipeline)
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.pytree import nest, to_host
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import ExperimentConfig
from fedml_tpu_torch.robust import AdmissionPipeline
from fedml_tpu_torch.robust.admission import _leaves, update_sumsq
from fedml_tpu_torch.robust.degrade import ReliabilityTracker
from fedml_tpu_torch.shard_spine import build_shard_spine
from fedml_tpu_torch.utils.jax_params import params_from_numpy


@pytest.fixture(autouse=True)
def no_worker_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith("ingest-fold"))]
    assert not leaked, leaked


def _tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": (rng.randn(3, 3, 1, 5) * scale)
                     .astype(np.float32),
                     "bias": (rng.randn(5) * scale).astype(np.float32)},
            "dense": {"kernel": (rng.randn(7, 3) * scale).astype(np.float32),
                      "bias": (rng.randn(3) * scale).astype(np.float32)}}


def _frame(tree, mod=Message):
    return mod.from_bytes(mod(3, 1, 0).add("model_params", tree)
                          .add("num_samples", 5).to_bytes())


def test_arena_screens_a_frame_as_its_tree_and_the_host():
    ref, up = _tree(0), _tree(1)
    arena = IngestArena(ref)
    arena.round_start(ref)
    a = arena.stage_message(_frame(up), "model_params")
    b = arena.stage_tree(up)
    assert a.structural_ok and b.structural_ok and a.finite and b.finite
    assert a.sumsq == b.sumsq
    host = update_sumsq(up, [np.asarray(x, np.float64)
                             for x in _leaves(ref)])
    assert a.sumsq == pytest.approx(host, rel=1e-6)
    assert a.norm == pytest.approx(np.sqrt(host), rel=1e-6)
    assert arena.copies == 2
    # the staged tree holds the frame's values, each leaf 16-byte aligned
    base = None
    for (k, v), want in zip(sorted(_flat(a.tree).items()),
                            sorted(_flat(up).items())):
        assert isinstance(v, torch.Tensor)
        assert v.numpy().tobytes() == want[1].tobytes()
        base = v.data_ptr() if base is None else base
        assert (v.data_ptr() - base) % 16 == 0
    # no reference: the delta norm of the payload itself
    arena.round_start(None)
    d = arena.stage_tree(up)
    assert d.sumsq == pytest.approx(
        sum(float((x.astype(np.float64) ** 2).sum()) for x in _leaves(up)),
        rel=1e-6)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("seed", range(3))
def test_arena_screen_matches_the_jax_arena(seed):
    ref, up = _tree(seed), _tree(seed + 10, scale=2.0)
    up["dense"]["bias"][1] = np.nan if seed == 2 else up["dense"]["bias"][1]
    j, t = JArena(ref), IngestArena(ref)
    j.round_start(ref)
    t.round_start(ref)
    js = j.stage_message(_frame(up, JMessage), "model_params")
    ts = t.stage_message(_frame(up), "model_params")
    assert ts.structural_ok == js.structural_ok is True
    assert ts.finite == js.finite == (seed != 2)
    if seed != 2:
        assert ts.sumsq == pytest.approx(js.sumsq, rel=1e-6)


@pytest.mark.parametrize("damage", ["shape", "key", "dtype", "torn",
                                    "garbage"])
def test_structural_damage_is_caught_without_a_tree_walk(damage):
    ref = _tree(0)
    arena = IngestArena(ref)
    arena.round_start(ref)
    up = _tree(1)
    if damage == "shape":
        up["dense"]["bias"] = np.zeros(4, np.float32)
    elif damage == "key":
        up["dense"]["b"] = up["dense"].pop("bias")
    elif damage == "dtype":
        up["dense"]["bias"] = up["dense"]["bias"].astype(np.float64)
    if damage == "garbage":
        assert not arena.stage_tree(object()).structural_ok
        return
    msg = _frame(up)
    if damage == "torn":
        descr, spec, buffers = msg.raw_payload("model_params")
        buffers[descr[0]["idx"]] = memoryview(b"\0" * 8)
    screen = arena.stage_message(msg, "model_params")
    assert screen.structural_ok is False
    if damage != "torn":
        assert arena.stage_tree(up).structural_ok is False
    assert arena.copies == 0


def test_unsupported_templates_and_object_messages_fall_back(tmp_path):
    ints = {"step": np.int32(3), "w": np.zeros(3, np.float32)}
    arena = IngestArena(ints)
    assert not arena.supported and arena.stage_tree(ints) is None
    fp = IngestArena(_tree(0))
    obj = Message(3, 1, 0).add("model_params", _tree(1))   # never encoded
    assert fp.stage_message(obj, "model_params") is None
    # the arena's perf seam is ported: its screen joins the recorder's
    # compile ledger as <name>_screen, its staging unchanged
    from fedml_tpu_torch.obs import DeviceRecorder, PerfRecorder
    perf = PerfRecorder(str(tmp_path / "perf.jsonl"),
                        device=DeviceRecorder())
    try:
        timed = IngestArena(_tree(0), perf=perf, name="ingest")
        perf.round_start(0)
        screen = timed.stage_tree(_tree(1))
        line = perf.round_end(0)
    finally:
        perf.close()
    assert screen.structural_ok and timed.copies == 1
    assert [c["fn"] for c in line["device"]["compiles"]] == \
        ["ingest_screen"]


@pytest.mark.parametrize("case", ["clean", "nonfinite", "fingerprint"])
def test_admission_pre_seam_gives_the_host_verdicts(case):
    ref = _tree(0)
    up = _tree(1)
    if case == "nonfinite":
        up["conv"]["bias"][0] = np.inf
    if case == "fingerprint":
        up["conv"]["bias"] = np.zeros(6, np.float32)
    arena = IngestArena(ref)
    arena.round_start(ref)
    pre = arena.stage_message(_frame(up), "model_params")
    host = AdmissionPipeline(ref, kind="params").admit(1, up, 5, ref, 0)
    dev = AdmissionPipeline(ref, kind="params").admit(
        1, pre.tree if pre.structural_ok else up, 5, ref, 0, pre=pre)
    assert (dev.ok, dev.reason) == (host.ok, host.reason)
    if host.ok:
        assert dev.norm == pytest.approx(host.norm, rel=1e-6)


def test_shard_offer_pre_seam_gives_the_host_verdicts():
    init = params_from_numpy(_tree(0))
    host_init = to_host(nest(init))
    outs = []
    for with_pre in (False, True):
        spine = build_shard_spine(init, num_shards=2, fused="off")
        spine.round_start(host_init)
        up = to_host(nest(params_from_numpy(_tree(1))))
        slices = spine.broadcast_slices(up)
        arenas = [IngestArena(sl) for sl in
                  spine.broadcast_slices(host_init)]
        for a, ref in zip(arenas, spine.broadcast_slices(host_init)):
            a.round_start(ref)
        for s, sl in enumerate(slices):
            pre = arenas[s].stage_tree(sl) if with_pre else None
            status, info = spine.admission.offer(
                1, s, 2, pre.tree if pre else sl, 5, 0, pre=pre)
        outs.append((status, info))
    (s0, i0), (s1, i1) = outs
    assert s0 == s1 == "accept"
    assert i1["norm"] == pytest.approx(i0["norm"], rel=1e-6)
    # the banked slices are the staged device views
    assert all(isinstance(v, torch.Tensor)
               for sl in i1["slices"] for v in _flat(sl).values())


def test_overflow_dead_letters_as_a_network_fault():
    fed = []
    tracker = ReliabilityTracker(2)
    pipe = IngestPipeline(num_shards=1, depth=1,
                          fault_feed=lambda r, d: (
                              fed.append((r, d)),
                              tracker.note_dead_letter(r)))
    try:
        gate = threading.Event()
        pipe.submit(0, gate.wait)        # the worker holds this one
        while pipe._queues[0].qsize():   # until the worker took it
            pass
        assert pipe.submit(0, lambda: None)
        assert pipe.submit(0, lambda: None, detail="silo 2") is False
        assert fed == [(OVERFLOW_REASON, "silo 2")]
        assert pipe.overflows == 1
        assert tracker._fault_counts["network"] == 1
        gate.set()
        assert pipe.drain() == 2
    finally:
        pipe.stop()


def test_a_dead_worker_fails_the_drain_and_stop_is_idempotent():
    pipe = IngestPipeline(num_shards=2, depth=4)
    try:
        def boom():
            raise KeyError("fold")
        pipe.submit_wait(1, boom)
        with pytest.raises(RuntimeError, match="worker died"):
            pipe.drain()
        with pytest.raises(ValueError, match="outside"):
            pipe.submit(2, lambda: None)
    finally:
        pipe.stop()
        pipe.stop()
    with pytest.raises(ValueError, match="ingest_queue_depth"):
        IngestPipeline(depth=0)


# ---------------------------------------------------------------------------
# pipelined == inline, bit for bit
# ---------------------------------------------------------------------------

class _Sink:
    def log(self, row, step=None):
        pass


_BASE = dict(model="lr", dataset="mnist", client_num_in_total=12,
             client_num_per_round=4, batch_size=4, comm_round=3,
             frequency_of_the_test=100, platform="cpu", log_stdout=False)


def _run(runner, **kw):
    cfg = ExperimentConfig(**{**_BASE, **kw})
    t_main.check_config(cfg)
    data = t_main.load_experiment_data(cfg)
    fed = runner(cfg, data, _Sink())
    out = fed.run()
    return {k: v.numpy().tobytes() for k, v in fed.server.params.items()}, \
        out, fed


@pytest.mark.parametrize("flags", [
    dict(algo="cross_silo", agg_mode="stream", norm_clip=5.0,
         agg_noise_std=0.025),
    dict(algo="cross_silo", agg_mode="stream", model_shards=2,
         fused_finalize="on", norm_clip=5.0, agg_noise_std=0.025),
    dict(algo="cross_silo", agg_mode="stream", norm_clip=5.0,
         server_opt="adam", server_lr=0.01),
])
def test_pipelined_cross_silo_is_bit_identical_to_inline(flags):
    inline, _, _ = _run(t_main.CrossSiloFederation, **flags)
    piped, out, fed = _run(t_main.CrossSiloFederation, ingest_pipeline=True,
                           **flags)
    assert out["params_finite"] and fed.server.round_idx == 3
    assert piped == inline
    arenas = [fed.ingest.arena_for(s) for s in range(fed.ingest.num_shards)]
    # one staged copy per upload per shard
    assert [a.copies for a in arenas] == [3 * 4] * len(arenas)


def test_pipelined_async_is_bit_identical_to_inline():
    flags = dict(algo="async_fl", agg_mode="stream", norm_clip=5.0,
                 async_goal=2, comm_round=4)
    inline, _, _ = _run(t_main.AsyncFederation, **flags)
    piped, out, fed = _run(t_main.AsyncFederation, ingest_pipeline=True,
                           **flags)
    assert fed.server.version == 4 and out["params_finite"]
    assert piped == inline


def test_pipelined_waves_are_bit_identical_and_reject_the_poison():
    flags = dict(algo="cross_device", wave_size=2, comm_round=3,
                 wave_adversary="1:0:nan_bomb")

    def run(**kw):
        cfg = ExperimentConfig(**{**_BASE, **flags, **kw})
        t_main.check_config(cfg)
        algo = t_main.cross_device_algo(
            cfg, t_main.load_experiment_data(cfg))
        params = algo.run()
        return {k: v.numpy().tobytes() for k, v in params.items()}, algo
    inline, a0 = run()
    piped, a1 = run(ingest_pipeline=True)
    assert piped == inline
    assert a1.admission.rejected["nonfinite"] == 1 == \
        a0.admission.rejected["nonfinite"]
    assert not a1.ingest._threads[0].is_alive()


@pytest.mark.parametrize("flags", [
    ["--algo", "fedavg"],
    ["--algo", "cross_silo", "--wire_compression", "topk"],
    ["--algo", "cross_silo", "--silo_backend", "grpc"],
    ["--algo", "cross_silo", "--edge_aggregators", "2", "--agg_mode",
     "stream"],
    ["--algo", "cross_silo", "--chaos_dup", "0.1"],
    ["--algo", "cross_silo", "--agg_mode", "stack"],
])
def test_ingest_gates_refuse_as_the_jax_package(flags):
    import importlib
    from fedml_tpu_torch.experiments.config import config_from_argv
    # the module (the package's ``main`` attribute is the function)
    j_main = importlib.import_module("fedml_tpu.experiments.main")
    argv = ["--ingest_pipeline", "true", "--platform", "cpu"] + flags
    with pytest.raises(ValueError) as want:
        j_main.main(argv)
    assert "ingest_pipeline" in str(want.value)
    with pytest.raises(ValueError) as got:
        t_main.check_ingest(config_from_argv(argv))
    assert str(got.value) == str(want.value)
