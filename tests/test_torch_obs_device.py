"""The port's device & compile observatory (``obs/device.py``), its
redesign of the JAX package's for the card, on the CPU.

* The ledger's ``device`` section has the keys of JAX's; on CPU tensors
  its memory is ``null`` (the JAX package's live-arrays sum has no
  honest PyTorch twin), never a fabricated 0.
* The compile ledger records the first sight of a signature (no probe),
  or a call that grew the callable's ``_cache_size`` probe, and nothing
  on a repeat; signatures tokenise like JAX's.
* FlopCounterMode's count for one CNN train step (the FEMNIST CNN, 3
  steps of 20) equals the analytic conv and dense count exactly:
  forward, weight gradients and the input gradients of every layer but
  the first.
* A K2 call's FLOPs (the sharded spine's fused finalize) come from the
  kernel work table, and ``chip_smoke.py`` reads its bounds from the same
  table (identity).
* The stacked defended mean's FLOPs come from the same table (a clipped
  fold a slot and the finalize); K2's count is the f32 part of its
  bounds' work.
* The peak table: the H100's dense bf16 spec-sheet peak; ``mfu`` <= 1;
  the memory and the peak are the recorder's one card's.
"""

import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.obs import device as j_device
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.obs import DeviceRecorder, PerfRecorder, device
from fedml_tpu_torch.robust.defense import make_defended_aggregate
from fedml_tpu_torch.shard_spine import build_shard_spine
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import make_client_optimizer


def test_section_keys_equal_jax_and_cpu_memory_is_null():
    want_rec = j_device.DeviceRecorder(cost_analysis=False)
    jf = want_rec.instrument("f", jax.jit(lambda x: x * 2.0))
    want_rec.round_start()
    jf(jnp.ones(3))
    want = want_rec.round_snapshot(0.5)
    rec = DeviceRecorder(device="cpu")
    f = rec.instrument("f", lambda x: x * 2.0)
    rec.round_start()
    f(torch.ones(3))
    got = rec.round_snapshot(0.5)
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["memory"] is None
    assert [c["fn"] for c in got["compiles"]] == ["f"]
    assert set(got["compiles"][0]) >= {"fn", "wall_s", "signature"}
    assert device.device_memory_snapshot("cpu") is None
    assert device.device_memory_snapshot(None) is None


def test_compiles_on_first_sight_of_a_signature_only():
    rec = DeviceRecorder()
    f = rec.instrument("f", lambda x, n: x + n)
    rows = []
    for shape in ((4,), (4,), (5,)):
        rec.round_start()
        f(torch.zeros(shape), 3)
        rows.append(rec.round_snapshot(1.0)["compiles"])
    assert [len(r) for r in rows] == [1, 0, 1]
    assert rows[0][0]["signature"] == "float32[4],int[]"
    assert device.format_signature(device.call_signature(
        (torch.zeros(2, 3, dtype=torch.int32), 1.5))) == \
        j_device.format_signature(j_device.call_signature(
            (np.zeros((2, 3), np.int32), 1.5)))
    prev = device.call_signature((torch.zeros(4),))
    cur = device.call_signature((torch.zeros(5),))
    assert device.signature_diff(prev, cur) == \
        j_device.signature_diff(j_device.call_signature((jnp.zeros(4),)),
                                j_device.call_signature((jnp.zeros(5),)))


def _cnn_step_flops(steps, batch, classes):
    f = [2 * batch * 28 * 28 * 32 * 1 * 25,     # Conv_0, SAME
         2 * batch * 14 * 14 * 64 * 32 * 25,    # Conv_1, SAME
         2 * batch * 3136 * 512,                # Dense_0
         2 * batch * 512 * classes]             # Dense_1
    # forward + weight gradients + input gradients (none for Conv_0)
    return steps * (3 * sum(f) - f[0])


def test_flop_counter_counts_a_cnn_train_step_exactly():
    wl = create_workload("cnn_fedavg", "femnist", 62, (28, 28))
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    local = make_local_trainer(wl, make_client_optimizer("sgd", 0.1, 0.0),
                               1)
    rec = DeviceRecorder()
    train = rec.instrument("train_fn", local)
    data = {"x": torch.randn(3, 20, 28, 28),
            "y": torch.randint(0, 62, (3, 20)), "mask": torch.ones(3, 20)}
    for _ in range(2):
        rec.round_start()
        train(params, data)
        sec = rec.round_snapshot(1.0)
        assert sec["flops"] == _cnn_step_flops(3, 20, 62)
        assert sec["flops_complete"] is True
        assert 0 < sec["mfu"] <= 1.0


def test_k2_flops_come_from_the_work_table(tmp_path):
    rng = np.random.RandomState(0)
    init = {"Dense_0/kernel": torch.from_numpy(
                rng.randn(64, 32).astype(np.float32)),
            "Dense_0/bias": torch.zeros(32)}
    rec = PerfRecorder(str(tmp_path / "perf.jsonl"),
                       device=DeviceRecorder())
    try:
        spine = build_shard_spine(init, num_shards=2, fused="on",
                                  noise_std=0.025, min_split_elems=64,
                                  sentry=rec.sentry, device_obs=rec.device)
        agg = spine.agg
        rec.round_start(0)
        agg.reset(init)
        agg.fold({k: v + 1.0 for k, v in init.items()}, 3.0)
        agg.finalize(0)
        line = rec.round_end(0)
    finally:
        rec.close()
    fin = {c["fn"]: c for c in line["device"]["compiles"]
           if c["fn"].startswith("fused_finalize")}
    assert sorted(fin) == ["fused_finalize[s0]", "fused_finalize[s1]"]
    for s in range(2):
        d = spine.plan.slice_numel(s)
        assert fin[f"fused_finalize[s{s}]"]["flops"] == \
            device.kernel_flops("shard_finalize", d=d, sigma=0.025) == \
            device.shard_finalize_bounds(d, 0.025)[1]["fp32"]
    assert line["device"]["flops_complete"] is True
    assert line["jit_cache_sizes"] == {"shard_spine[mean]": 0}


def test_chip_smoke_reads_the_same_work_table():
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    chip = importlib.import_module("chip_smoke")
    for name in ("robust_agg_work", "clip_norm_work", "secagg_mask_work",
                 "shard_finalize_bounds"):
        assert getattr(chip, name) is getattr(device, name)
    b, h, t, d = 2, 4, 256, 32
    work = device.flash_work(b, h, t, d)
    bounds = chip.flash_bounds(b, h, t, d, 1.98e9)
    for name, (nbytes, ops, _) in work.items():
        assert bounds[name]["bytes_ms"] == pytest.approx(
            nbytes / chip.HBM_BYTES_PER_S * 1e3)
        assert bounds[name]["tf32_ms"] == pytest.approx(
            ops / chip.TF32_OPS_PER_S * 1e3)
        assert device.kernel_flops(name, b=b, h=h, t=t, d=d) == ops
    assert device.kernel_flops("robust_agg", n=10, sizes=[100, 28],
                               sigma=0.025) == 10 * 128 * 35
    assert device.kernel_flops("clip_norm", n=10, sizes=[100]) == 3000


def test_defended_mean_flops_come_from_the_work_table(tmp_path):
    """The stacked defended mean (clip, fold, finalize with noise) under
    the recorder: ledgered as ``defended_aggregate[mean]``, its FLOPs a
    clipped fold a slot and the finalize from the table, a compile on
    the first round only."""
    rec = PerfRecorder(str(tmp_path / "perf.jsonl"), strict_recompiles=True,
                       device=DeviceRecorder())
    agg = make_defended_aggregate("mean", norm_clip=5.0, noise_std=0.025,
                                  seed=3, sentry=rec.sentry,
                                  device=rec.device)
    g = {"a/kernel": torch.ones(6, 4), "a/bias": torch.zeros(4)}
    stacked = {k: torch.stack([v + i for i in range(3)])
               for k, v in g.items()}
    w = torch.tensor([1.0, 2.0, 0.0])
    want = (3 * device.kernel_flops("stream_fold", d=28, clip=True)
            + device.kernel_flops("stream_finalize", d=28, sigma=0.025))
    try:
        for r in range(2):
            rec.round_start(r)
            agg(g, stacked, w, r)
            dev = rec.round_end(r)["device"]
            assert dev["flops"] == want and dev["flops_complete"] is True
            assert [c["fn"] for c in dev["compiles"]] == \
                (["defended_aggregate[mean]"] if r == 0 else [])
    finally:
        rec.close()


def test_the_section_reads_the_recorders_one_card(monkeypatch):
    """On a host with several visible cards the recorder takes the
    memory, and the peak, of its own card only (every port run trains on
    one): the other cards are never queried."""
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    asked = []

    def stats(idx):
        asked.append(idx)
        return {"allocated_bytes.all.current": 1 << 20,
                "allocated_bytes.all.peak": 2 << 20}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda idx: (0, 80 << 30))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda idx=None: "NVIDIA H100 80GB HBM3")
    for dev, idx in (("cuda:1", 1), ("cuda", 2)):
        asked.clear()
        rec = DeviceRecorder(device=dev)
        f = rec.instrument("f", lambda x: x, flops=lambda x: 1e9)
        rec.round_start()
        f(torch.ones(2))
        sec = rec.round_snapshot(1.0)
        assert set(asked) == {idx}
        assert [e["id"] for e in sec["memory"]] == [idx]
        assert sec["memory"][0]["bytes_in_use"] == 1 << 20
        assert sec["peak_tflops"] == 989.4
        assert "local devices" not in sec["peak_source"]
        assert sec["mfu"] == pytest.approx(1e9 / 989.4e12)


def test_peak_table_and_overrides(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert device.peak_tflops_for_device("NVIDIA H100 80GB HBM3") == 989.4
    assert "spec figure" in device.peak_source_for_device(
        "NVIDIA H100 80GB HBM3")
    assert device.peak_tflops_for_device("cpu") == device.DEFAULT_PEAK_TFLOPS
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "100")
    assert device.peak_tflops_for_device("NVIDIA H100 80GB HBM3") == 100.0
    assert device.peak_source_for_device(None) == \
        "BENCH_PEAK_TFLOPS env override"
    rec = DeviceRecorder(peak_tflops=1e-9)   # a silly peak: mfu reported
    f = rec.instrument("f", lambda x: x, flops=lambda x: 1e6)
    rec.round_start()
    f(torch.ones(2))
    sec = rec.round_snapshot(1.0)
    assert sec["flops"] == 1e6 and sec["peak_source"] == \
        "explicit peak_tflops argument"


def test_a_vmapped_wave_counts_its_clients_flops():
    """Under ``vmap`` a wave's convolutions become grouped convolutions
    (the clients are the groups); the weight gradient is counted per
    group, so a wave of 2 clients counts exactly 2 clients' FLOPs (the
    count ``client_axis="scan"`` gives), and a depthwise convolution's
    gradient as many FLOPs as its groups do."""
    from fedml_tpu_torch.core import prng
    from fedml_tpu_torch.parallel.cohort import train_cohort
    wl = create_workload("cnn_fedavg", "femnist", 62, (28, 28))
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    local = make_local_trainer(wl, make_client_optimizer("sgd", 0.1, 0.0),
                               1)
    w = 2
    data = {"x": torch.randn(w, 1, 20, 28, 28),
            "y": torch.randint(0, 62, (w, 1, 20)),
            "mask": torch.ones(w, 1, 20),
            "num_samples": torch.full((w,), 20.0)}
    words = prng.key_words_int32(prng.key(0))
    for axis in ("vmap", "scan"):
        rec = DeviceRecorder()
        wave = rec.instrument("wave_train", train_cohort)
        rec.round_start()
        wave(local, params, data, words, index_offset=0, client_axis=axis)
        assert rec.round_snapshot(1.0)["flops"] == \
            w * _cnn_step_flops(1, 20, 62)
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    k = torch.randn(8, 1, 3, 3, requires_grad=True)
    with device._flop_counter() as fc:
        torch.nn.functional.conv2d(x, k, groups=8).sum().backward()
    # forward, input and weight gradients: 2 * B * 4*4 * 8 * 9 each
    assert fc.get_total_flops() == 3 * 2 * 2 * 16 * 8 * 9
