"""The pure helpers of ``chip_smoke.py`` that decide what its K4 rows say
and whether its K4 checks pass: the three-term bound, the parsers of the
compiler's report and of the SASS, the kernels' shared memory, and the
NaN check.  They run here on text, numbers and the plain versions on the
CPU; the card runs the rest."""

import math

import pytest
import torch

import chip_smoke as cs
from fedml_tpu_torch.models import flash_attention as fa

MAX_SM_HZ = 1.98e9             # the H100 SXM's maximum SM clock

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi32EEEvPKfS2_S2_PfS3_S3_if' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi32EEEvPKfS2_S2_PfS3_S3_if
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compile time = 161.394 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi32EEEvPKfS2_S2_S2_S2_S2_S2_Pfif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi32EEEvPKfS2_S2_S2_S2_S2_S2_Pfif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 16384 bytes smem
"""

SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi16EEEvPKfS2_S2_PfS3_S3_if
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*49e0*/                   HMMA.1688.F32.TF32 R172, R104, R168, RZ ;
        /*49f0*/                   HMMA.1688.F32.TF32 R172, R100, R164, R172 ;
        /*4a00*/                   HGMMA.64x64x8.F32.TF32 R24, gdesc[UR4], R24 ;
\t\tFunction : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi16EEEvPKfS2_S2_S2_S2_S2_S2_Pfif
        /*0910*/                   FFMA R2, R0, R3, -1 ;
        /*0920*/                   MOV R4, 0x0 ;
"""


def test_flash_bounds_three_terms_at_the_vmapped_shape():
    """[8, 2048, 8, 32]: K4f's TF32 term 34.7 us, its exps (one per
    visible pair) 32.1 us at 1.98 GHz, its bytes 20.3 us; dK/dV and dQ
    twice and 1.5 times the TF32 term; the f32 SIMT bound stays beside."""
    b = cs.flash_bounds(8, 8, 2048, 32, MAX_SM_HZ)
    fwd, dkv, dq = b["flash_fwd"], b["flash_bwd_dkv"], b["flash_bwd_dq"]
    pairs = 64 * 2048 * 2049 / 2
    assert fwd["tf32_ms"] == pytest.approx(4 * 32 * pairs / 495e12 * 1e3)
    assert fwd["tf32_ms"] == pytest.approx(0.0347, abs=1e-4)
    assert fwd["exp_ms"] == pytest.approx(pairs / (16 * 132 * 1.98e9) * 1e3)
    assert fwd["exp_ms"] == pytest.approx(0.0321, abs=1e-4)
    assert fwd["bytes_ms"] == pytest.approx(0.0203, abs=1e-4)
    assert dkv["tf32_ms"] == pytest.approx(2 * fwd["tf32_ms"])
    assert dq["tf32_ms"] == pytest.approx(1.5 * fwd["tf32_ms"])
    for row in b.values():
        assert row["bound_term"] == "tf32"
        assert row["bound_by"] == "operations"
        assert row["bound_ms"] == max(row["tf32_ms"], row["exp_ms"],
                                      row["bytes_ms"])
        assert row["f32_simt_bound_ms"] == pytest.approx(
            row["tf32_ms"] * 495 / 67)


@pytest.mark.parametrize("t, term", [(128, "bytes"), (2048, "tf32")])
def test_flash_bounds_name_the_winning_term(t, term):
    """Short sequences are bound by their bytes; a slow SM clock makes
    the exps the bound."""
    b = cs.flash_bounds(2, 8, t, 32, MAX_SM_HZ)
    assert b["flash_fwd"]["bound_term"] == term
    assert b["flash_fwd"]["bound_by"] == ("bytes" if term == "bytes"
                                          else "operations")
    slow = cs.flash_bounds(2, 8, 2048, 32, 1e9)["flash_fwd"]
    assert slow["bound_term"] == "exp"
    assert slow["bound_by"] == "operations"
    assert math.isclose(slow["bound_ms"], slow["exp_ms"])


def test_ptxas_report_reads_each_entry_function():
    rep = cs.ptxas_report(PTXAS_LOG)
    fwd = [v for k, v in rep.items() if "flash_fwd_kernelILi32E" in k]
    dq = [v for k, v in rep.items() if "flash_bwd_dq_kernelILi32E" in k]
    assert fwd == [dict(spill_stores=8, spill_loads=4, registers=127)]
    assert dq == [dict(spill_stores=0, spill_loads=0, registers=166,
                       smem_static=16384)]


def test_tensor_core_counts_reads_hmma_and_hgmma():
    counts = cs.tensor_core_counts(SASS)
    assert sorted(counts.values()) == [0, 3]
    [fwd] = [n for k, n in counts.items() if "flash_fwd_kernel" in k]
    assert fwd == 3


@pytest.mark.parametrize("kernel, d, smem", [
    ("flash_fwd", 32, 36864), ("flash_fwd", 64, 69632),
    ("flash_bwd_dkv", 16, 22016), ("flash_bwd_dkv", 32, 38400),
    ("flash_bwd_dkv", 64, 71168), ("flash_bwd_dq", 16, 20480),
    ("flash_bwd_dq", 32, 36864), ("flash_bwd_dq", 64, 69632)])
def test_flash_smem_bytes(kernel, d, smem):
    """Two buffers of 64-row tiles padded to d + 4 floats (K4f's and
    K4dq's K and V; K4dkv's Q and dO, and m, l and di); over 48 KB at
    d = 64, where the launch must allow it."""
    assert cs.flash_smem_bytes(kernel, d) == smem


def test_flash_shapes_cover_every_head_size():
    """The kernel phase holds each kernel to its plain version at every
    head size the wrapper takes on the card, and the kernels line reads
    the vmapped d = 32 shape."""
    assert {d for _, _, _, d in cs.FLASH_SHAPES.values()} \
        == set(fa.KERNEL_HEAD_DIMS)
    assert cs.FLASH_SHAPES["vmap"] == (8, 2048, 8, 32)
    for b, t, h, d in cs.FLASH_SHAPES.values():
        fa.check_seq_len(t)


def test_shard_finalize_cases_cover_every_tail():
    """K2's phase covers the path's shards, every size mod 4, a size with
    no whole float4 and a view off a 16-byte boundary (offset 1 float)."""
    shards = {"s0": 422_238, "s1": 422_944}
    cases = cs.shard_finalize_cases(shards)
    names = [n for n, _, _ in cases]
    assert len(set(names)) == len(names)
    assert [(n, d) for n, d, off in cases if n in shards] \
        == list(shards.items())
    aligned = [d for _, d, off in cases if not off]
    assert {d % 4 for d in aligned} == {0, 1, 2, 3}
    assert min(aligned) < 4
    assert [off for _, _, off in cases if off] == [1]


@pytest.fixture(scope="module")
def nan_chain():
    """The NaN check's inputs through the plain versions on the CPU."""
    return cs.flash_chain(*cs.flash_nan_inputs("cpu"), fa.flash_fwd_plain,
                          fa.flash_bwd_dkv_plain, fa.flash_bwd_dq_plain)


def test_flash_nan_check_passes_the_plain_versions(nan_chain):
    """The plain versions put NaN in every row a NaN input reaches through
    a visible pair (and, through their dense products, more), and agree
    with themselves elsewhere."""
    must = cs.flash_nan_rows(nan_chain["o"].shape[:3])
    for name, out in nan_chain.items():
        nan_rows = out.isnan().any(-1)
        assert not (must[name] & ~nan_rows).any(), name
        assert must[name].any(), name
    assert cs.flash_nan_problems(nan_chain, nan_chain) == []


@pytest.mark.parametrize("name", ["o", "dk", "dv", "dq"])
def test_flash_nan_check_catches_a_dropped_nan(nan_chain, name):
    """An output that turns a NaN into a finite number (as a TF32 rounding
    that carried a NaN's payload into its exponent did) fails."""
    got = dict(nan_chain, **{name: torch.nan_to_num(nan_chain[name])})
    [problem] = cs.flash_nan_problems(got, nan_chain)
    assert problem.startswith(f"{name}: ") and "not NaN" in problem


@pytest.mark.parametrize("name, tol", [("o", cs.FLASH_O_TOL),
                                       ("dk", cs.FLASH_GRAD_TOL)])
def test_flash_nan_check_holds_finite_rows_to_the_limits(nan_chain, name,
                                                         tol):
    """Off the NaN rows the chip limits hold: an error of 2x the limit on
    one finite element fails, half the limit passes."""
    ref = nan_chain[name]
    finite = ~ref.isnan().any(-1)
    limit = tol * float(ref[finite].abs().max())
    b, h, r = [int(i[0]) for i in finite.nonzero(as_tuple=True)]
    for scale, fails in ((2.0, True), (0.5, False)):
        out = ref.clone()
        out[b, h, r, 0] += scale * limit
        problems = cs.flash_nan_problems(dict(nan_chain, **{name: out}),
                                         nan_chain)
        assert bool(problems) == fails, (scale, problems)


def test_k2_ab_refuses_without_a_card(monkeypatch):
    """The K2 A/B timer measures on the card only: without one it exits
    non-zero before building anything."""
    from fedml_tpu_torch.utils import k2_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a GPU"):
        k2_ab.main(["a.cu", "b.cu"])


CNN_D = 1_690_046              # the FEMNIST CNN's parameters


def test_k1_bound_counts_each_kind_of_operation():
    """K1 at sigma = 0.025 over the CNN, N = 10: bytes 81.1 MB (24.2 us);
    per (client, element) 20 integer operations (16.7 T/s at 64 lanes per
    SM a clock, 1.98 GHz: 21.2 us), 35 f32 (at 128 lanes: 17.7 us) and 5
    special-function (at 16 lanes: 20.2 us); bytes bind.  At a 1.2 GHz SM
    clock the integer term binds instead.  At sigma = 0 only 5 f32
    operations a pair remain."""
    pairs = 10 * CNN_D
    nbytes, ops = cs.robust_agg_work(10, [CNN_D], 0.025)
    assert nbytes == 4 * (pairs + 2 * CNN_D + 20)
    assert ops == {"fp32": 35 * pairs, "int": 20 * pairs + 10 * CNN_D,
                   "sfu": 5 * pairs}
    b = cs.op_bound(nbytes, ops, MAX_SM_HZ)
    assert b["bytes_ms"] == pytest.approx(0.0242, abs=1e-4)
    assert b["int_ms"] == pytest.approx(0.0212, abs=1e-4)
    assert b["fp32_ms"] == pytest.approx(0.0177, abs=1e-4)
    assert b["sfu_ms"] == pytest.approx(0.0202, abs=1e-4)
    assert (b["bound_term"], b["bound_by"]) == ("bytes", "bytes")
    assert b["bound_ms"] == b["bytes_ms"]
    assert b["dispatch_ms"] == pytest.approx(
        sum(ops.values()) / (128 * 132 * MAX_SM_HZ) * 1e3)
    slow = cs.op_bound(nbytes, ops, 1.2e9)
    assert (slow["bound_term"], slow["bound_by"]) == ("int", "operations")
    assert slow["bound_ms"] == slow["int_ms"]
    _, quiet = cs.robust_agg_work(10, [CNN_D], 0.0)
    assert quiet == {"fp32": 5 * pairs}


def test_clip_norm_bound_is_its_bytes():
    """The norm pass reads x and g once: 74.4 MB, 22.2 us; 3 f32
    operations a pair stay far below."""
    nbytes, ops = cs.clip_norm_work(10, [CNN_D])
    assert nbytes == 4 * (11 * CNN_D + 10)
    b = cs.op_bound(nbytes, ops, MAX_SM_HZ)
    assert b["bound_ms"] == pytest.approx(0.0222, abs=1e-4)
    assert b["bound_term"] == "bytes"


@pytest.mark.parametrize("n, term", [(5, "bytes"), (10, "int")])
def test_k3_bound_counts_each_pair_once(n, term):
    """K3 over a whole group takes each pair once: 10 + 11 n(n-1)/2
    integer operations an element.  A group of 5 is bound by its bytes
    (67.6 MB, 20.2 us against 12.1 us of integer work); a group of 10 by
    its integer work (51 us against 40.4).  A single row walks its n - 1
    partners."""
    nbytes, ops = cs.secagg_mask_work(n, n, CNN_D)
    assert nbytes == 4 * (2 * n * CNN_D + n)
    assert ops["int"] == CNN_D * (10 + 11 * n * (n - 1) // 2)
    assert ops["fp32"] == 4 * n * CNN_D and ops["sfu"] == n * CNN_D
    b = cs.op_bound(nbytes, ops, MAX_SM_HZ)
    assert b["bound_term"] == term
    if n == 5:
        assert b["bytes_ms"] == pytest.approx(0.0202, abs=1e-4)
        assert b["int_ms"] == pytest.approx(0.0121, abs=1e-4)
    else:
        assert b["int_ms"] == pytest.approx(0.0510, abs=1e-4)
    _, row = cs.secagg_mask_work(1, n, CNN_D)
    assert row["int"] == CNN_D * (10 + 10 * (n - 1))


def test_k_ab_tool_modes_refuse_without_a_card(monkeypatch):
    """Each of the A/B tool's kernels refuses without a card before it
    builds anything."""
    from fedml_tpu_torch.utils import k2_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("k1", "k3"):
        with pytest.raises(SystemExit, match="needs a GPU"):
            k2_ab.main([mode, "a.cu", "b.cu"])


GRAPH_DOT = """\
digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[
\tstyle="solid" shape="record" label="{
KERNEL
| {<b>ID | node handle | func handle</b> | 0 | 0x5f3c | 0x7a10}
| {<b>name | mangled name</b> | void flash_fwd_kernel<32>(...) | \
_ZN12_GLOBAL__N_116flash_fwd_kernelILi32EEEvPKfS2_S2_PfS3_S3_if}
}"];
"graph_1_node_1"[
\tstyle="solid" shape="record" label="{
KERNEL
| {<b>name | mangled name</b> | flash_bwd_dq_kernel<32> | \
_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi32EEEvPKfS2_S2_S2_S2_S2_S2_Pfif}
}"];
"graph_1_node_2"[
\tstyle="solid" shape="record" label="{MEMCPY | {dst | src}}"];
"graph_1_node_3"[
\tstyle="solid" shape="record" label="{
KERNEL
| {<b>name | mangled name</b> | flash_fwd_kernel<32> | \
_ZN12_GLOBAL__N_116flash_fwd_kernelILi32EEEvPKfS2_S2_PfS3_S3_if}
}"];
"graph_1_node_0" -> "graph_1_node_1";
"graph_1_node_1" -> "graph_1_node_3";
}
}
"""


def test_graph_kernel_counts_counts_each_node_once():
    """The K4 check reads the captured graph's own kernel nodes: a node
    that names its kernel twice (name and mangled name) counts once, edges
    and other nodes not at all."""
    got = cs.graph_kernel_counts(GRAPH_DOT, cs.K4_KERNELS.values())
    assert got == {"flash_fwd_kernel": 2, "flash_bwd_dkv_kernel": 0,
                   "flash_bwd_dq_kernel": 1}


def test_new_phase_configs_parse_and_pass_the_gates():
    """The configurations the chip phases drive are valid CLI configs: the
    Byzantine rules at the CNN's cohort (multi-Krum's m <= n - f - 2), the
    robust cross-silo modes, the scanned run's cadence."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    for rule, extra in cs.BYZ_ARGS.items():
        cfg = config_from_argv(["--algo", "fedavg_robust", "--defense",
                                rule, *extra, *cs.COMMON_ARGS])
        check_config(cfg)
        if rule == "multi_krum":
            assert cfg.krum_m <= cfg.client_num_per_round - cfg.byz_f - 2
    base = ["--algo", "cross_silo", "--silo_backend", "local",
            *cs.COMMON_ARGS]
    for extra in cs.SILO_ROBUST_ARGS.values():
        check_config(config_from_argv(base + extra))
    for mode in ("stack", "stream"):
        check_config(config_from_argv(cs.SILO_MEAN_ARGS
                                      + ["--agg_mode", mode]))
    cfg = config_from_argv(cs.SCAN_ARGS + ["--rounds_per_dispatch",
                                           str(cs.SCAN_K)])
    check_config(cfg)
    assert (cfg.comm_round, cfg.frequency_of_the_test,
            cfg.rounds_per_dispatch) == (21, 10, 10)


def test_fault_tolerance_phase_configs_parse_and_pass_the_gates(tmp_path):
    """The crash-resume, chaos and MQTT phases' configurations are valid
    CLI configs: the checkpoint and journal flags with the sharded stream,
    chaos with the drop policy, a timeout and heartbeats; the chaos
    timeout follows the measured round; the K2 count each phase requires
    is 4 a closed round."""
    import math
    durable = ["--checkpoint_dir", str(tmp_path / "ck"),
               "--checkpoint_every", "1", "--journal_dir",
               str(tmp_path / "j"), "--journal_snapshot_every", "1"]
    cfg = cs.ft_cfg(durable, cs.FT_ROUNDS)
    assert (cfg.model_shards, cfg.agg_mode, cfg.fused_finalize,
            cfg.comm_round) == (4, "stream", "on", 3)
    assert [p for p, _ in cs.CRASH_AT] == [
        "post_admission_pre_fold", "post_fold_pre_ack", "barrier_close",
        "mid_checkpoint_write"]
    from fedml_tpu_torch.robust.faultline import CRASH_POINTS
    assert all(p in CRASH_POINTS for p, _ in cs.CRASH_AT)
    chaos = cs.ft_cfg([*cs.CHAOS_RATES, "--straggler_policy", "drop",
                       "--round_timeout_s", "2.0", "--heartbeat_s", "0.05",
                       "--dead_after_s", "6.0", "--min_silo_frac", "0.1"],
                      cs.CHAOS_ROUNDS)
    assert (chaos.chaos_drop, chaos.chaos_dup, chaos.chaos_reorder,
            chaos.chaos_delay, chaos.chaos_corrupt) == (0.1, 0.1, 0.1, 0.1,
                                                        0.05)
    # T = 5 rounds rounded up to 0.5 s (at least 1 s), D = 3 T
    for round_ms, want in ((400.0, 2.0), (100.0, 1.0), (1010.0, 5.5)):
        t_s = max(cs.CHAOS_T_MIN_S,
                  math.ceil(cs.CHAOS_T_ROUNDS * round_ms / 500) / 2)
        assert t_s == want
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    with pytest.raises(ValueError, match="wedge"):
        check_config(config_from_argv([*cs.SILO_ARGS, *cs.CHAOS_RATES]))


def test_chip_smoke_imports_no_grpc():
    """The card has no grpcio: importing the script, and the modules of
    the phases it drives, must not import it."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(cs.__file__).resolve().parent
    code = ("import sys\nimport chip_smoke\n"
            "import fedml_tpu_torch.comm.mqtt_transport\n"
            "import fedml_tpu_torch.experiments.main\n"
            "assert 'grpc' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
