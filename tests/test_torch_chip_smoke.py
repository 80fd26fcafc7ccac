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


@pytest.fixture(scope="module")
def nan_chain_bf16():
    """The NaN check's inputs in bf16 through the plain bf16 versions on
    the CPU."""
    return cs.flash_chain(*cs.flash_nan_inputs("cpu", torch.bfloat16),
                          *cs.flash_nan_plains(torch.bfloat16))


def test_flash_nan_check_passes_the_plain_bf16_versions(nan_chain_bf16):
    """Rounded to bf16 the NaNs stay, and the plain bf16 versions put NaN
    in every row they reach through a visible pair; bf16 outputs, held at
    BF16_KERNEL_TOL on every output."""
    must = cs.flash_nan_rows(nan_chain_bf16["o"].shape[:3])
    for name, out in nan_chain_bf16.items():
        assert out.dtype == torch.bfloat16, name
        assert not (must[name] & ~out.isnan().any(-1)).any(), name
    tols = cs.flash_nan_tols(torch.bfloat16)
    assert tols == (cs.BF16_KERNEL_TOL, cs.BF16_KERNEL_TOL)
    assert cs.flash_nan_problems(nan_chain_bf16, nan_chain_bf16, tols) == []


@pytest.mark.parametrize("name", ["o", "dk", "dv", "dq"])
def test_flash_nan_check_catches_a_dropped_bf16_nan(nan_chain_bf16, name):
    """A bf16 output that turns a NaN into a finite number fails."""
    got = dict(nan_chain_bf16,
               **{name: torch.nan_to_num(nan_chain_bf16[name])})
    [problem] = cs.flash_nan_problems(got, nan_chain_bf16,
                                      cs.flash_nan_tols(torch.bfloat16))
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


def test_k4_ab_modes_refuse_without_a_card(monkeypatch):
    """The A/B tool's bf16 K4f, K4dkv and K4dq modes refuse without a
    card before they build anything; without a mode's sources it prints
    its usage."""
    from fedml_tpu_torch.utils import k2_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("k4f", "k4dkv", "k4dq"):
        with pytest.raises(SystemExit, match="needs a GPU"):
            k2_ab.main([mode, "a.cu", "b.cu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mode in ("k4f", "k4dq"):
        with pytest.raises(SystemExit, match="k4dq A.cu B.cu"):
            k2_ab.main([mode, "a.cu"])


def test_tensor_core_kinds_split_hmma_from_hgmma():
    """Phase 8p's build check reads mma.sync (HMMA) and wgmma (HGMMA)
    apart, per function; their sum is tensor_core_counts'."""
    sass = """\
        Function : _Z16flash_fwd_bf16_kernelILi32EEvv
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0110*/                   HGMMA.64x32x16.F32.BF16 R88, R56, gdesc[UR8] ;
        Function : _Z17flash_bwd_dq_bf16_kernelILi32EEvv
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    kinds = cs.tensor_core_kinds(sass)
    [fwd] = [v for k, v in kinds.items() if "fwd_bf16" in k]
    [dq] = [v for k, v in kinds.items() if "dq_bf16" in k]
    assert fwd == {"HMMA": 0, "HGMMA": 2} and dq == {"HMMA": 1, "HGMMA": 0}
    assert sorted(cs.tensor_core_counts(sass).values()) == [1, 2]


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


# ---------------------------------------------------------------------------
# the live SecAgg, server_opt and algorithm-zoo phases, rehearsed on the
# CPU at a tiny size (LR on MNIST, 40 clients, 10 a round)
# ---------------------------------------------------------------------------

def test_pr10_phase_configs_parse_and_pass_the_gates():
    """The configurations of the three phases are valid CLI configs at
    the CNN's widths: 10 silos at the majority threshold (6), the drop
    policy for the lost upload, adam on the sharded spine with K2 on,
    the eight algorithms (three at 200 clients)."""
    cfg = cs.live_cfg(cs.SECAGG_ARGS + cs.SECAGG_DROP, 3, "cpu")
    assert (cfg.secagg, cfg.client_num_per_round, cfg.model,
            cfg.straggler_policy) == ("pairwise", 10, "cnn_fedavg", "drop")
    from fedml_tpu_torch.secure.protocol import SecAggServer
    assert SecAggServer()._threshold_for(cfg.client_num_per_round) == 6
    assert len(cs.SECAGG_OVER) > cfg.client_num_per_round - 6
    adam = cs.live_cfg(cs.SRVOPT_ARGS["adam"], 3, "cpu")
    assert (adam.model_shards, adam.fused_finalize, adam.server_opt) == \
        (4, "on", "adam")
    for name in ("momentum", "fedac"):
        assert cs.live_cfg(cs.SRVOPT_ARGS[name], 3, "cpu").model_shards == 0
    for name in cs.ZOO_ARGS:
        cfg = cs.zoo_cfg(name, "cpu")
        assert cfg.client_num_in_total == (
            cs.ZOO_SMALL_CLIENTS if name in cs.ZOO_SMALL else 3400)


@pytest.fixture
def tiny_phases(monkeypatch, tmp_path):
    """The phases' module constants at a tiny size on the CPU; K2's plain
    version counted as its launches."""
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import load_experiment_data
    common = ["--model", "lr", "--dataset", "mnist",
              "--client_num_in_total", "40", "--client_num_per_round", "10",
              "--batch_size", "20", "--lr", "0.1", "--epochs", "1",
              "--comm_round", "3", "--frequency_of_the_test", "1000",
              "--log_stdout", "false"]

    def tiny(args):
        i, j = args.index("--model"), args.index("--log_stdout") + 2
        return args[:i] + common + args[j:]
    monkeypatch.setattr(cs, "CARD", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "COMMON_ARGS", common)
    for name in ("SILO_ARGS", "PLAIN_STREAM_ARGS", "SECAGG_ARGS"):
        monkeypatch.setattr(cs, name, tiny(getattr(cs, name)))
    monkeypatch.setattr(cs, "SRVOPT_ARGS", {
        k: tiny(v) for k, v in cs.SRVOPT_ARGS.items()})
    monkeypatch.setattr(cs, "ZOO_SMALL_CLIENTS", 20)
    real = fused_agg.shard_finalize_plain

    def counted(*a, **k):
        fused_agg.launch_counts["shard_finalize"] += 1
        return real(*a, **k)
    monkeypatch.setattr(fused_agg, "shard_finalize_plain", counted)
    data = load_experiment_data(config_from_argv(cs.SECAGG_ARGS))
    return data, tmp_path


def test_live_secagg_phase_on_the_cpu(tiny_phases):
    data, root = tiny_phases
    out = cs.check_live_secagg(data, root)
    assert out["ring_sums_bit_equal"] == [True] * 3
    assert out["dropped"] == [cs.SECAGG_DEAD]
    assert max(out["vs_plaintext_max_abs_diff"]) <= cs.SECAGG_TOL
    assert out["mid_unmask_boundary_unchanged"]
    assert out["mid_unmask_rerun_bit_equal"]
    assert "threshold" in out["over_threshold_error"]
    assert out["masking"]["streams"] == 10
    assert out["split_ms_per_round"]["masking_ms"] > 0


def test_live_server_opt_phase_on_the_cpu(tiny_phases):
    data, root = tiny_phases
    out = cs.check_live_server_opt(data, root)
    assert out["k2_launches"] == 4 * cs.SRVOPT_ROUNDS
    assert out["kill"]["params_bit_equal"] and out["kill"]["state_bit_equal"]
    assert "adam" in out["other_optimizer_refused"]
    assert out["runs"]["adam"]["journal_mode"] == \
        "shard_mean[S=4]+srvopt=adam"


def test_algorithm_zoo_phase_on_the_cpu(tiny_phases, monkeypatch):
    """Three of the eight, one of each kind: a device round with a server
    step, a host loop with per-client state, and DP's accountant."""
    data, _ = tiny_phases
    monkeypatch.setattr(cs, "ZOO_ARGS", {
        k: cs.ZOO_ARGS[k] for k in ("fedopt", "scaffold", "dp_fedavg")})
    monkeypatch.setattr(cs, "ZOO_PROFILE_ROUNDS", 1)
    rows = cs.check_algorithm_zoo(data)
    assert set(rows) == set(cs.ZOO_ARGS)
    assert rows["fedopt"]["path"] == "device round"   # graphed on the card
    for name in ("scaffold", "dp_fedavg"):
        assert rows[name]["path"] == "host loop"
    assert all(r["vs_cpu_max_abs_diff"] <= cs.ROUND_TOL
               for r in rows.values())
    assert rows["dp_fedavg"]["dp_epsilon_cpu_equal"]


# ---------------------------------------------------------------------------
# the cross-device phase (8l), rehearsed on the CPU at a tiny size
# ---------------------------------------------------------------------------

def test_cross_device_phase_configs_parse_and_pass_the_gates():
    """At the card's sizes: 4 waves of 256 a round at 3400 clients (the
    last 232 live), SCAFFOLD at 200 clients, the CPU rounds at 2 waves of
    8 (cut from 3 of 16), config 4's ResNet-18-GN at 500 clients, 10 a
    round (its CPU round on 4), and resnet56 on the cifar10 twin."""
    for name, extra in cs.CD_RUNS.items():
        cfg = cs.cd_cfg([*cs.CD_ARGS, *extra], "cpu")
        assert cfg.algo == "cross_device" and cfg.model == "cnn_fedavg"
        if name == "scaffold":
            assert (cfg.client_num_in_total, cfg.client_num_per_round,
                    cfg.wave_size) == (200, 100, 32)
        else:
            assert (cfg.client_num_in_total, cfg.client_num_per_round,
                    cfg.wave_size) == (3400, 1000, 256)
            assert 1000 - 3 * 256 == 232
    par = cs.cd_cfg([*cs.CD_ARGS, *cs.CD_RUNS["scaffold"], *cs.CD_PARITY],
                    "cpu")
    assert (par.client_num_in_total, par.client_num_per_round,
            par.wave_size) == (200, 16, 8)
    c4par = cs.cd_cfg([*cs.CONFIG4_ARGS, *cs.CONFIG4_RUNS["fedprox"],
                       *cs.CONFIG4_PARITY_COHORT], "cpu")
    assert c4par.client_num_per_round == 4
    c4 = cs.cd_cfg([*cs.CONFIG4_ARGS, *cs.CONFIG4_RUNS["fednova"]], "cpu")
    assert (c4.model, c4.dataset, c4.client_num_in_total,
            c4.client_num_per_round, c4.local_alg) == (
        "resnet18_gn", "fed_cifar100", 500, 10, "fednova")
    assert cs.cd_cfg(cs.RESNET56_ARGS, "cpu").model == "resnet56"
    assert cs.cd_cfg([*cs.CD_ARGS, *cs.CD_RUNS["sgd_adam"]],
                     "cpu").server_opt == "adam"


def test_cross_device_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 8l end to end on CPU tensors, one intra-op thread: LR on a
    30-client FEMNIST twin (10 a round, waves of 4, 2 rounds a run),
    CNNDropOut at 3 clients for the dropout check, LR on the cifar twins
    in place of config 4's ResNet-18-GN and of resnet56."""
    from fedml_tpu_torch.experiments.main import load_experiment_data
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(cs, "CARD", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "CD_ARGS", [
        *cs.CD_ARGS, "--model", "lr", "--client_num_in_total", "30",
        "--client_num_per_round", "10", "--wave_size", "4",
        "--comm_round", "2"])
    monkeypatch.setattr(cs, "CD_RUNS", {
        "sgd": [], "fedprox": ["--local_alg", "fedprox"],
        "fednova": ["--local_alg", "fednova"],
        "scaffold": ["--local_alg", "scaffold", "--client_num_in_total",
                     "20", "--client_num_per_round", "6", "--wave_size",
                     "4"]})
    monkeypatch.setattr(cs, "CD_PARITY", ["--client_num_per_round", "6",
                                          "--wave_size", "4"])
    monkeypatch.setattr(cs, "CD_SMALL", ["--client_num_per_round", "3",
                                         "--wave_size", "2"])
    monkeypatch.setattr(cs, "CD_SMALL_SINGLE", 3)
    monkeypatch.setattr(cs, "CD_SINGLE_WAVE", 10)
    monkeypatch.setattr(cs, "CONFIG4_ARGS", [
        *cs.CONFIG4_ARGS, "--model", "lr", "--client_num_in_total", "12",
        "--client_num_per_round", "4", "--comm_round", "2"])
    monkeypatch.setattr(cs, "RESNET56_ARGS", [
        *cs.RESNET56_ARGS, "--model", "lr", "--client_num_in_total", "2",
        "--client_num_per_round", "2", "--batch_size", "4"])
    try:
        data = load_experiment_data(cs.cd_cfg(cs.CD_ARGS, "cpu"))
        out = cs.check_cross_device(data, tmp_path)
    finally:
        torch.set_num_threads(n_threads)
    assert set(out["runs"]) == set(cs.CD_RUNS)
    for row in out["runs"].values():
        assert row["rounds_per_s"] > 0 and row["training_ms_per_wave"] > 0
        assert row["fold_ms_per_wave"] > 0
        assert row["admission_ms_per_wave"] > 0
    assert out["runs"]["sgd"]["waves"] == 3
    assert all(r["ok"] and r["max_abs_diff"] <= cs.ROUND_TOL
               and r["finalize_max_abs_diff"] <= cs.ROUND_TOL
               for r in out["parity"].values())
    assert out["parity"]["fednova"]["tau_eff"] >= 1.0
    assert out["runs"]["scaffold"]["state_gather_ms_per_wave"] > 0
    assert out["chunking"]["deterministic"]["max_abs_diff"] \
        <= cs.WAVE_CHUNK_TOL
    assert out["sampler"]["ids_equal_permutation"]
    assert out["sampler"]["differs_from_numpy"]
    assert out["dropout"]["other_seed_max_abs_diff"] > 0
    assert out["resume"]["bit_equal"]
    assert set(out["config4"]) == {"fedprox", "fednova"}
    assert out["resnet56"]["finite"]


def test_phase_ab_refuses_without_a_card_or_a_known_phase(monkeypatch):
    from fedml_tpu_torch.utils import phase_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="usage"):
        phase_ab.main(["secagg", "a", "b"])
    for phase in ("mqtt", "bf16_lm"):
        with pytest.raises(SystemExit, match="needs a GPU"):
            phase_ab.main([phase, "a", "b"])


# ---------------------------------------------------------------------------
# the model-zoo phase (8m), rehearsed on the CPU at a tiny size
# ---------------------------------------------------------------------------

def test_zoo_phase_configs_parse_and_pass_the_gates():
    """At the card's sizes: BASELINE config 5's two LSTM runs (715
    clients, 10 a round, B=4, lr 1; 342,477 clients, 50 a round, B=16,
    lr 10^-0.5), config 3's live cross-silo runs (10 silos, B=64, lr
    0.001, wd 0.001, E=1 (cut from 20), S=4, K2 on) on both models, the
    BatchNorm FedAvg and defended runs, the centralized runner."""
    got = {k: cs.cd_cfg(v, "cpu") for k, v in cs.ZOO_NWP_ARGS.items()}
    assert {k: (c.model, c.dataset, c.client_num_in_total,
                c.client_num_per_round, c.batch_size, c.lr, c.epochs)
            for k, c in got.items()} == {
        "config5a": ("rnn", "shakespeare", 715, 10, 4, 1.0, 1),
        "config5b": ("rnn", "stackoverflow_nwp", 342_477, 50, 16, 0.31623,
                     1)}
    for model in cs.CONFIG3_MODELS:
        c = cs.cd_cfg([*cs.CONFIG3_ARGS, "--model", model], "cpu")
        assert (c.algo, c.agg_mode, c.model_shards, c.fused_finalize,
                c.client_num_per_round, c.batch_size, c.lr, c.wd,
                c.epochs) == ("cross_silo", "stream", 4, "on", 10, 64,
                              0.001, 0.001, 1)
    assert cs.CONFIG3_MODELS == ("resnet56", "mobilenet")
    bn = cs.cd_cfg(cs.BN_ROBUST_ARGS, "cpu")
    assert (bn.algo, bn.defense, bn.defense_backend, bn.norm_bound,
            bn.stddev, bn.client_num_per_round, bn.batch_size, bn.lr) == (
        "fedavg_robust", "weak_dp", "cuda", 5.0, 0.025, 10, 64, 0.1)
    assert cs.cd_cfg(cs.CENTRAL_ARGS, "cpu").algo == "centralized"
    assert set(cs.bn_models()) == {"resnet56_bn", "mobilenet_bn"}
    assert cs.BN_ROBUST_MODEL in cs.bn_models()


def test_profile_once_counts_a_round_on_the_cpu(monkeypatch):
    monkeypatch.setattr(cs, "CARD", "cpu")
    x = torch.ones(64)
    row = cs.profile_once(lambda: [x.add_(1) for _ in range(4)], 2)
    assert row["profiled_round_ms"] > 0
    assert row["device_kernels_per_round"] == 0
    assert row["device_idle_share"] is None
    assert cs.steady([5.0, 1.0, 3.0]) == {"rounds_per_s": 0.5,
                                          "round_ms": 2000.0}


def test_zoo_phase_on_the_cpu(monkeypatch):
    """Phase 8m end to end on CPU tensors, one intra-op thread, 2 rounds a
    path: the LSTMs narrowed (hidden 16) on 6-client twins, 3 a round,
    the twins' sequences cut to 8 and 4 tokens;
    config 3 on LR (3 silos, E=1); the BatchNorm ResNet's stem alone
    (conv, BatchNorm, dense) for the FedAvg and defended runs (K1's plain
    version); centralized on 5 clients; the oracle at 4.  Plain calls of
    K2 count as its launches."""
    from functools import partial

    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.data import registry
    from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
    from fedml_tpu_torch.experiments import models as exp_models
    from fedml_tpu_torch.models.resnet import CifarResNet
    from fedml_tpu_torch.models.rnn import (RNNOriginalFedAvg,
                                            RNNStackOverflow)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(cs, "CARD", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(exp_models, "RNNOriginalFedAvg",
                        lambda vocab_size, dtype=None: RNNOriginalFedAvg(
                            vocab_size, 8, 16, dtype=dtype))
    monkeypatch.setattr(exp_models, "RNNStackOverflow",
                        lambda dtype=None: RNNStackOverflow(
                            embedding_size=8, latent_size=16, dtype=dtype))
    monkeypatch.setitem(registry._REGISTRY, "shakespeare", {
        **registry._REGISTRY["shakespeare"], "twin": partial(
            synthetic_federated_dataset, sample_shape=(8,),
            sequence_vocab=90, class_num=90)})
    monkeypatch.setitem(registry._REGISTRY, "stackoverflow_nwp", {
        **registry._REGISTRY["stackoverflow_nwp"], "twin": partial(
            synthetic_federated_dataset, sample_shape=(4,),
            sequence_vocab=10004, class_num=10004)})
    small = ["--client_num_in_total", "6", "--client_num_per_round", "3"]
    monkeypatch.setattr(cs, "ZOO_NWP_ARGS", {
        "config5a": [*cs.ZOO_NWP_ARGS["config5a"], *small, "--batch_size",
                     "32"],
        "config5b": [*cs.ZOO_NWP_ARGS["config5b"], *small]})
    monkeypatch.setattr(cs, "CONFIG3_ARGS", [
        *cs.CONFIG3_ARGS, "--client_num_in_total", "3",
        "--client_num_per_round", "3", "--epochs", "1"])
    monkeypatch.setattr(cs, "CONFIG3_MODELS", ("lr",))
    monkeypatch.setattr(cs, "ZOO_ROUNDS", 2)
    monkeypatch.setattr(cs, "bn_models", lambda: {"tiny_bn": lambda: (
        CifarResNet(layers=(0, 0, 0), num_classes=10, norm="batch"))})
    monkeypatch.setattr(cs, "BN_ROBUST_MODEL", "tiny_bn")
    bn_args = [*cs.BN_ARGS, "--client_num_in_total", "3",
               "--client_num_per_round", "3"]
    monkeypatch.setattr(cs, "BN_ROBUST_ARGS", [
        *bn_args, *cs.BN_ROBUST_ARGS[len(cs.BN_ARGS):]])
    monkeypatch.setattr(cs, "BN_ARGS", bn_args)
    monkeypatch.setattr(cs, "CENTRAL_ARGS", [
        *cs.CENTRAL_ARGS, "--client_num_in_total", "5"])
    monkeypatch.setattr(cs, "ORACLE_CLIENTS", 4)
    real = fused_agg.shard_finalize_plain

    def counted(*a, **k):
        fused_agg.launch_counts["shard_finalize"] += 1
        return real(*a, **k)
    monkeypatch.setattr(fused_agg, "shard_finalize_plain", counted)
    try:
        out = cs.check_zoo_models(MAX_SM_HZ)
    finally:
        torch.set_num_threads(n_threads)
    for row in [*out["nwp"].values(), *out["bn"].values()]:
        assert row["graph_vs_host_bit_equal"]
        assert row["vs_cpu_max_abs_diff"] <= cs.ROUND_TOL
        assert row["host_loop"]["rounds_per_s"] > 0
        assert "device_kernels_per_round" in row["graph"]
    assert out["bn"]["tiny_bn"]["stats_moved"] > 1e-3
    assert out["silo"]["lr"]["k2_launches"] == 8     # 4 shards x 2 rounds
    k1 = out["robust"]["k1"]
    assert k1["stats_unclipped"] and k1["max_abs_err"] <= cs.KERNEL_TOL
    assert k1["weight_leaves"] < k1["leaves"]
    assert out["central"]["rounds_per_s"] > 0
    assert out["oracle"]["allclose_excess"] <= 0


def test_live_machinery_phase_configs_parse_and_pass_the_gates():
    """Phase 8n's configurations are valid CLI configs at the CNN's
    widths: the sharded spine with and without the pipeline, the tracker
    and the adversary on it, both compression schemes, async_fl with
    adam, the edge tier (5 silos an edge) plaintext and grouped,
    hierarchical, and the poisoned waves."""
    spine = cs.live_cfg([*cs.SILO_ARGS, "--ingest_pipeline", "true"], 3,
                        "cpu")
    assert (spine.model_shards, spine.fused_finalize, spine.ingest_pipeline,
            spine.model) == (4, "on", True, "cnn_fedavg")
    deg = cs.live_cfg([*cs.SILO_ARGS, *cs.MACH_DEGRADE], 4, "cpu")
    assert (deg.min_quorum, deg.adaptive_deadline, deg.straggler_policy,
            deg.adversary) == (0.6, True, "drop", "2:scale:20,3:nan_bomb")
    for extra in cs.MACH_COMPRESS.values():
        assert cs.live_cfg([*cs.PLAIN_STREAM_ARGS, *extra], 3,
                           "cpu").wire_compression in ("topk", "int8")
    asy = cs.live_cfg([*cs.MACH_ASYNC, *cs.MACH_ASYNC_DURABLE], 6, "cpu")
    assert (asy.async_goal, asy.server_opt, asy.journal) == (5, "adam", True)
    for extra in ([], ["--secagg", "grouped"]):
        e = cs.live_cfg([*cs.PLAIN_STREAM_ARGS, *cs.MACH_EDGES, *extra], 3,
                        "cpu")
        assert e.client_num_per_round // e.edge_aggregators == 5
    h = cs.cd_cfg(cs.MACH_HIER, "cpu")
    assert (h.algo, h.group_num, h.group_comm_round) == ("hierarchical", 2,
                                                         2)
    w = cs.cd_cfg([*cs.CD_ARGS, *cs.MACH_WAVES, "--ingest_pipeline",
                   "true"], "cpu")
    assert (w.client_num_per_round, w.wave_size, w.wave_adversary) == \
        (1000, 256, "1:0:nan_bomb")


def test_live_machinery_phase_on_the_cpu(tiny_phases, monkeypatch):
    """Phase 8n end to end on CPU tensors at the tiny LR size (40 mnist
    clients, 10 a round; waves of 4): every run and every check."""
    data, root = tiny_phases
    common = list(cs.COMMON_ARGS)

    def tiny(args):
        i, j = args.index("--model"), args.index("--log_stdout") + 2
        return args[:i] + common + args[j:]
    monkeypatch.setattr(cs, "MACH_ASYNC", tiny(cs.MACH_ASYNC))
    monkeypatch.setattr(cs, "MACH_HIER", tiny(cs.MACH_HIER))
    monkeypatch.setattr(cs, "CD_ARGS", [
        *cs.CD_ARGS, *common, "--client_num_per_round", "10",
        "--wave_size", "4"])
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.check_live_machinery(data, root)
    finally:
        torch.set_num_threads(n_threads)
    ing = out["ingest"]
    assert ing["bit_equal"]
    assert ing["inline"]["k2_launches"] == ing["ingest"]["k2_launches"] \
        == 4 * cs.MACH_ROUNDS
    assert ing["ingest"]["arena_copies"] == [3 * 10] * 4
    assert ing["inline"]["admission_ms_per_round"] > 0
    deg = out["degrade"]
    assert deg["silo2_quarantined"] and deg["params_finite"]
    assert deg["rejected"]["nonfinite"] >= 1
    assert deg["strike_faults"]["network"] == 0
    assert deg["vs_cpu_max_abs_diff"] <= cs.ROUND_TOL
    for row in out["compression"].values():
        assert row["wire_bytes"] < row["uncompressed_bytes"]
    assert out["compression"]["topk"]["ratio"] < 0.3
    asy = out["async_fl"]
    assert asy["versions"] == cs.MACH_ASYNC_VERSIONS
    assert asy["kill"]["bit_equal"] and asy["kill"]["killed_at"] == 5
    assert asy["mean_staleness"] > 0
    edges = out["edges"]
    assert max(edges["grouped_vs_plaintext_max_abs_diff"]) <= cs.SECAGG_TOL
    assert edges["edge_kill"]["bit_equal"] and edges["edge_kill"]["resumed"]
    hier = out["hierarchical"]
    assert hier["oracle_vs_fedavg_max_abs_diff"] <= cs.MACH_ORACLE_TOL
    waves = out["waves"]
    assert waves["bit_equal"] and waves["debt_after_round"] == 0
    assert waves["inline"]["rejected"] == {"nonfinite": 1}


def test_observability_phase_configs_parse_and_pass_the_gates():
    """Phase 8o's configurations are valid CLI configs at the CNN's
    widths: the instrumented spine inline, pipelined and adaptive, the
    stacked defended round, the instrumented wave engine with the
    controller, async_fl and the edge tier with the observatories."""
    on = cs.live_cfg([*cs.SILO_ARGS, *cs.OBS_FLAGS], cs.OBS_ROUNDS, "cpu")
    assert (on.model_shards, on.fused_finalize, on.perf, on.perf_strict,
            on.device_obs, on.health, on.telemetry, on.model) == \
        (4, "on", True, True, True, True, True, "cnn_fedavg")
    ad = cs.live_cfg([*cs.SILO_ARGS, *cs.OBS_FLAGS, *cs.OBS_ADAPTIVE],
                     cs.OBS_ROUNDS, "cpu")
    assert ad.adaptive and "health_misalignment_ratio" in ad.slo
    pipe = cs.live_cfg([*cs.SILO_ARGS, *cs.OBS_FLAGS, "--ingest_pipeline",
                        "true"], cs.OBS_ROUNDS, "cpu")
    assert pipe.ingest_pipeline
    w = cs.cd_cfg([*cs.CD_ARGS, *cs.OBS_FLAGS, *cs.OBS_ADAPTIVE], "cpu")
    assert (w.client_num_per_round, w.wave_size, w.adaptive) == \
        (1000, 256, True)
    asy = cs.live_cfg([*cs.MACH_ASYNC, *cs.OBS_FLAGS],
                      cs.OBS_ASYNC_VERSIONS, "cpu")
    assert (asy.async_goal, asy.health, asy.device_obs) == (5, True, True)
    e = cs.live_cfg([*cs.PLAIN_STREAM_ARGS, *cs.MACH_EDGES, *cs.OBS_FLAGS],
                    cs.OBS_EDGE_ROUNDS, "cpu")
    assert e.client_num_per_round // e.edge_aggregators == 5
    st = cs.live_cfg([*cs.PLAIN_STREAM_ARGS, *cs.OBS_STACK, *cs.OBS_FLAGS],
                     cs.OBS_DEFENDED_ROUNDS, "cpu")
    assert (st.agg_mode, st.norm_clip, st.agg_noise_std, st.device_obs) == \
        ("stack", 5.0, cs.SIGMA, True)
    # the CLI's gates hold for the phase's flags off the live paths
    with pytest.raises(ValueError, match="live round"):
        cs.live_cfg([*cs.SLICE_ARGS, *cs.OBS_FLAGS], 2, "cpu")


def test_observability_phase_on_the_cpu(tiny_phases, monkeypatch):
    """Phase 8o end to end on CPU tensors at the tiny LR size (40 mnist
    clients, 10 a round; waves of 4): every run and every check but the
    card's memory section."""
    data, root = tiny_phases
    common = list(cs.COMMON_ARGS)

    def tiny(args):
        i, j = args.index("--model"), args.index("--log_stdout") + 2
        return args[:i] + common + args[j:]
    monkeypatch.setattr(cs, "MACH_ASYNC", tiny(cs.MACH_ASYNC))
    monkeypatch.setattr(cs, "CD_ARGS", [
        *cs.CD_ARGS, *common, "--client_num_per_round", "10",
        "--wave_size", "4"])
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.check_observability(data, root)
    finally:
        torch.set_num_threads(n_threads)
    assert out["bit_equal_on_off"]
    for k in ("inline", "ingest", "adaptive"):
        assert out[k]["k2_launches"] == 4 * cs.OBS_ROUNDS
        assert all(0 < m <= 1 for m in out[k]["mfu"])
        assert out[k]["compiles"][0] and not any(out[k]["compiles"][1:])
    assert out["trace"]["roots"] == cs.OBS_ROUNDS
    assert out["trace"]["recv_tracks_per_round"] == [10] * cs.OBS_ROUNDS
    assert len(out["adaptive"]["adapt"]) == cs.OBS_ROUNDS
    assert out["defended"]["bit_equal"]
    assert out["defended"]["aggregate_calls"] == [1] * cs.OBS_DEFENDED_ROUNDS
    assert all(0 < m <= 1 for m in out["defended"]["mfu"])
    assert len(out["waves"]["adapt"]) == cs.OBS_CD_ROUNDS
    assert out["async_fl"]["rounds"] == cs.OBS_ASYNC_VERSIONS
    assert len(out["edges"]["edge_rollup"]) == cs.OBS_EDGE_ROUNDS
    assert len(out["turns_round_ms"]["on"]) == 2
    assert not (root / "build" / "observability").exists()


# ---------------------------------------------------------------------------
# phase 8p: mixed precision, the bf16 K4 kernels, the MoE transformer,
# EfficientNet and VGG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel, d, smem", [
    ("flash_fwd_bf16", 16, 17456), ("flash_fwd_bf16", 32, 33840),
    ("flash_fwd_bf16", 64, 66608), ("flash_bwd_dkv_bf16", 16, 19760),
    ("flash_bwd_dkv_bf16", 32, 36144), ("flash_bwd_dkv_bf16", 64, 68912),
    ("flash_bwd_dq_bf16", 32, 33840), ("flash_bwd_dq_bf16", 64, 66608)])
def test_flash_bf16_smem_bytes(kernel, d, smem):
    """The wgmma kernels' swizzled, unpadded 64-row bf16 tiles: K4f's 128
    Q rows and three stages of K and V, K4dkv's K and V and three stages
    of Q, dO and their f32 -m log2 e, 1 / l and di, K4dq's Q and dO and
    three stages of K and V (K4f's bytes); with the ring's mbarriers and
    1024 bytes to align the base, under 48 KB at d <= 32 and over it at
    d = 64 (the launch allows it)."""
    assert cs.flash_smem_bytes(kernel, d) == smem
    assert (smem < 48 * 1024) == (d < 64)


def test_flash_bf16_bounds_at_the_vmapped_shape():
    """At [8, 2048, 8, 32]: the bytes halve against the f32 kernels' (bf16
    rows, f32 m, l, di), the products run at the 989.4 TF/s bf16 rate, and
    the exps bound K4f and K4dq, the products K4dkv."""
    b, t, h, d = cs.BF16_SHAPES["vmap"]
    got = cs.flash_bf16_bounds(b, h, t, d, MAX_SM_HZ)
    pairs = b * h * t * (t + 1) / 2
    rows, vecs = 2 * b * h * t * d, 4 * b * h * t
    assert got["flash_fwd_bf16"]["bytes_ms"] == pytest.approx(
        (4 * rows + 2 * vecs) / 3.35e12 * 1e3)
    assert got["flash_bwd_dkv_bf16"]["bf16_ms"] == pytest.approx(
        8 * d * pairs / 989.4e12 * 1e3)
    assert got["flash_fwd_bf16"]["exp_ms"] == pytest.approx(
        pairs / (16 * 132 * MAX_SM_HZ) * 1e3)
    assert [got[k]["bound_term"] for k in cs.K4_BF16_NAMES] == [
        "exp", "bf16", "exp"]
    f32 = cs.flash_bounds(b, h, t, d, MAX_SM_HZ)
    for name in cs.K4_NAMES:
        assert got[f"{name}_bf16"]["bytes_ms"] < f32[name]["bytes_ms"]
    from fedml_tpu_torch.obs.device import kernel_flops
    assert kernel_flops("flash_bwd_dq_bf16", b=b, h=h, t=t, d=d) == \
        kernel_flops("flash_bwd_dq", b=b, h=h, t=t, d=d)


def test_mixed_precision_phase_configs_parse_and_pass_the_gates():
    """The runs of phase 8p are valid CLI configs: the FEMNIST CNN, the
    BatchNorm ResNet-56 and the defended FedAvg under bf16 (the defended
    slice's K1 settings), EfficientNet-B0 and VGG-11 on the cifar10 twin
    in f32; bf16 is refused on the live paths as in JAX; the bf16 shapes
    cover every head size and the kernels line reads the vmapped one."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    got = {}
    for name, argv, bn_model in cs.BF16_IMAGE_RUNS:
        cfg = config_from_argv(argv)
        check_config(cfg)
        got[name] = (cfg.algo, cfg.model, cfg.dataset, cfg.compute_dtype,
                     cfg.comm_round)
        assert bn_model is None or bn_model in cs.bn_models()
    assert got == {
        "cnn bf16": ("fedavg", "cnn_fedavg", "femnist", "bfloat16", 2),
        "resnet56_bn bf16": ("fedavg", "resnet56", "cifar10", "bfloat16",
                             2),
        "fedavg_robust bf16": ("fedavg_robust", "cnn_fedavg", "femnist",
                               "bfloat16", 2),
        "efficientnet": ("fedavg", "efficientnet", "cifar10", "", 2),
        "vgg11": ("fedavg", "vgg11", "cifar10", "", 2)}
    robust = config_from_argv(cs.BF16_IMAGE_RUNS[2][1])
    assert (robust.defense, robust.defense_backend) == ("weak_dp", "cuda")
    with pytest.raises(ValueError, match="compute_dtype"):
        check_config(config_from_argv([*cs.SILO_ARGS, "--compute_dtype",
                                       "bfloat16"]))
    assert {d for _, _, _, d in cs.BF16_SHAPES.values()} == set(
        fa.KERNEL_HEAD_DIMS)
    assert cs.BF16_SHAPES["vmap"] == cs.FLASH_SHAPES["vmap"]


def test_parity_row_limits():
    """bf16 steps are held relative to their move, f32 ones at ROUND_TOL;
    a step that does not move fails."""
    init = {"w": torch.zeros(3)}
    want = {"w": torch.tensor([0.1, 0.0, 0.0])}
    near = {"w": torch.tensor([0.1 + 4e-3, 0.0, 0.0])}
    far = {"w": torch.tensor([0.1 + 6e-3, 0.0, 0.0])}
    assert cs.parity_row(near, want, init, torch.bfloat16)["ok"]
    assert not cs.parity_row(far, want, init, torch.bfloat16)["ok"]
    assert not cs.parity_row(near, want, init, None)["ok"]
    assert not cs.parity_row(want, want, want, torch.bfloat16)["ok"]


def test_mixed_precision_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 8p on CPU tensors at a tiny size: the bf16 kernel check (the
    plain versions against themselves), the LM runs (eager stand-ins for
    the graphed slice) and their steps against the CPU, the MoE's dropped
    tokens, and the image runs on LR over the mnist twin (K1's plain
    calls counted as one launch), the BatchNorm stem, and CNNDropOut (a
    keyed, eager device round)."""
    import time as _time
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import load_experiment_data
    from fedml_tpu_torch.models.resnet import CifarResNet
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(cs, "CARD", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def host_ms(fn, n=20):
        t0 = _time.perf_counter()
        fn()
        return (_time.perf_counter() - t0) * 1e3
    monkeypatch.setattr(cs, "launch_ms", host_ms)
    monkeypatch.setattr(cs, "BF16_SHAPES", {"vmap": (2, 128, 2, 32),
                                            "d16": (1, 128, 2, 16)})
    monkeypatch.setattr(cs, "LM", dict(vocab_size=64, d_model=32, n_heads=2,
                                       n_layers=1, d_ff=64, max_len=128))
    monkeypatch.setattr(cs, "LM_DATA", dict(
        sample_shape=(128,), sequence_vocab=64, class_num=64,
        num_clients=6, samples_per_client=4, batch_size=2))
    monkeypatch.setattr(cs, "LM_FEDAVG", dict(
        client_num_per_round=3, batch_size=2, lr=0.5, epochs=1,
        client_axis="vmap"))
    monkeypatch.setattr(cs, "MOE_BLOCK", 64)

    def eager_slice(data, root, algo=None, names=cs.K4_NAMES, label=""):
        algo.evaluate_global = lambda p: {}
        params = algo.run()
        steady = algo.round_times[1:]
        return ({}, 2, dict(rounds_per_s=1.0, peak_mem_gb=None,
                            steady_round_ms=1e3 * sum(steady)
                            / len(steady)), params)
    monkeypatch.setattr(cs, "run_lm_slice", eager_slice)
    small = ["--model", "lr", "--dataset", "mnist", "--client_num_in_total",
             "6", "--client_num_per_round", "3", "--batch_size", "4"]
    runs = {name: (argv, bn) for name, argv, bn in cs.BF16_IMAGE_RUNS}
    monkeypatch.setattr(cs, "BF16_IMAGE_RUNS", (
        ("cnn bf16", [*runs["cnn bf16"][0], *small], None),
        ("resnet56_bn bf16", [*runs["resnet56_bn bf16"][0], *small[4:]],
         "resnet56_bn"),
        ("fedavg_robust bf16", [*runs["fedavg_robust bf16"][0], *small],
         None),
        ("cnn dropout", [*runs["cnn bf16"][0], *small, "--model", "cnn",
                         "--dataset", "femnist", "--compute_dtype", ""],
         None)))
    monkeypatch.setattr(cs, "bn_models", lambda: {"resnet56_bn": lambda: (
        CifarResNet(layers=(0, 0, 0), num_classes=10, norm="batch"))})
    monkeypatch.setattr(cs, "SLICE_ARGS", [*cs.SLICE_ARGS, *small])
    for fn, key, step in (("robust_agg_plain", "robust_agg", 0.5),
                          ("clip_scales_plain", "clip_norm", 1)):
        real = getattr(fused_agg, fn)

        def counted(*a, _real=real, _key=key, _step=step, **k):
            fused_agg.launch_counts[_key] += _step     # LR: 2 leaves
            return _real(*a, **k)
        monkeypatch.setattr(fused_agg, fn, counted)
    data = load_experiment_data(config_from_argv(cs.SLICE_ARGS))
    try:
        out = cs.check_mixed_precision(data, cs.lm_data(), tmp_path,
                                       MAX_SM_HZ, 30.0)
    finally:
        torch.set_num_threads(n_threads)
    assert set(out["worst"]) == set(cs.K4_BF16_NAMES)
    assert all(v == 0.0 for v in out["worst"].values())  # plain vs plain
    assert out["lm"]["vs_cpu"]["ok"] and out["moe"]["f32"]["vs_cpu"]["ok"]
    for label in ("bf16", "f32"):
        assert 0 <= out["moe"][label]["dropped_share"] < 1
    imgs = out["images"]
    assert imgs["fedavg_robust bf16"]["k1_launches"] == cs.BF16_ROUNDS
    assert imgs["cnn bf16"]["compute_dtype"] == "bfloat16"
    assert imgs["cnn dropout"]["compute_dtype"] == "float32"
    assert all(r["all_leaves_f32"] for r in imgs.values())


# ---------------------------------------------------------------------------
# phase 8q: serving
# ---------------------------------------------------------------------------

def test_serving_phase_configs_parse_and_pass_the_gates():
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    for extra in ((), cs.SERVE_POOL_ARGS):
        cfg = config_from_argv([*cs.SERVE_ARGS, *extra, "--serve_port",
                                "18000", "--serve_workers", "2"])
        check_config(cfg)
        assert cfg.release_gate and cfg.model_shards == 4
        assert cfg.fused_finalize == "on" and cfg.comm_round == 3
    assert [m for _, m in cs.decode_requests()].count(cs.DECODE_LONG) \
        == cs.DECODE_REQUESTS // 4


def test_serving_phase_on_the_cpu(tiny_phases, monkeypatch):
    """Phase 8q end to end on CPU tensors at the tiny LR size (40 mnist
    clients, 10 a round) with a narrow decode LM: the client process,
    every check of (a) against the CPU replay, (b) and (c) (the eager
    step stands in for the capture)."""
    data, _ = tiny_phases
    for name in ("reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "SERVE_ARGS", [*cs.SILO_ARGS, "--release_gate",
                                           "true"])
    monkeypatch.setattr(cs, "SERVE_ROUNDS", 2)
    monkeypatch.setattr(cs, "DECODE_LM", dict(
        vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        max_len=64))
    monkeypatch.setattr(cs, "DECODE_CACHE", 64)
    monkeypatch.setattr(cs, "DECODE_REQUESTS", 16)
    monkeypatch.setattr(cs, "DECODE_SWAP_AT", 10)
    out = cs.check_serving(data)
    for run, rounds in (("frontend", 2), ("pool", cs.SERVE_POOL_ROUNDS)):
        assert out[run]["k2_launches"] == 4 * rounds
        assert out[run]["answers"] > 0
        assert out[run]["max_rel_err_vs_cpu"] <= cs.SERVE_TOL
        assert out[run]["decisions"][0] == "promote"
    assert out["pool"]["decisions"] == ["promote"] * cs.SERVE_POOL_ROUNDS
    assert out["containment"]["verdicts"][-1][:3] == (4, "rollback",
                                                      ["shadow"])
    assert out["decode"]["captures"] == 1
    assert out["decode"]["graph_bit_equal_eager"]
    assert out["decode"]["occupancy"]["continuous"] \
        > out["decode"]["occupancy"]["drain"]
    assert not cs.SERVE_DIR.exists()   # the release journals went with it


@pytest.mark.parametrize("status, reason, ok", [
    (429, "deadline", True),
    (429, "queue_full", True),
    (503, "no_model", True),
    ("error", "ConnectionResetError(104)", False),
    (500, "predict_failed", False),
    (503, "timeout", False),
    (400, "bad_instance", False),
    (429, "no_model", False),
])
def test_serve_answers_check_fails_on_unexpected_answers(status, reason, ok):
    """Phase 8q's answer check passes a named shed (429) and a 503 for
    want of a model beside the 200s, counted by status and reason, and
    fails on any other answer: a connection error, a 500, a 400 or a 503
    timeout among the 200s cannot pass."""
    import types
    import numpy as np
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import load_experiment_data
    from fedml_tpu_torch.experiments.models import (create_workload,
                                                    sample_shape_of)
    from fedml_tpu_torch.serve.registry import module_apply
    cfg = config_from_argv(["--model", "lr", "--dataset", "mnist",
                            "--client_num_in_total", "4", "--batch_size",
                            "4"])
    data = load_experiment_data(cfg)
    wl = create_workload("lr", "mnist", data.class_num,
                         sample_shape_of(data))
    params = wl.init(torch.Generator().manual_seed(0), "cpu")
    rows = np.asarray(data.test["x"])[0, 0]
    with torch.no_grad():
        y = module_apply(wl.model)(params, torch.as_tensor(rows[:1]))
    fed = types.SimpleNamespace(
        data=data, cfg=cfg, published={0: cs._flat_host(params)},
        serving=types.SimpleNamespace(release=types.SimpleNamespace(
            verdicts=[{"version": 0, "decision": "promote"}])))
    traffic = types.SimpleNamespace(answers=[[
        (0, 200, 0, y[0].tolist(), None, 0.01),
        (1, status, None, None, reason, 0.01)]])
    if ok:
        out = cs.serve_answers_check(traffic, fed, rows, "serve")
        assert out["statuses"] == {"200": 1, f"{status} {reason}": 1}
    else:
        with pytest.raises(SystemExit):
            cs.serve_answers_check(traffic, fed, rows, "serve")


@pytest.mark.parametrize("arm, profiled", [("host", False), ("off", True)])
def test_serve_split_arm_on_the_cpu(tiny_phases, monkeypatch, arm, profiled):
    """An arm of ``--serve-split`` on CPU tensors at the tiny LR size, two
    rounds: the rounds close and the perf ledger is read back, the host
    stub answers the client traffic without the model, and the profiled
    pass reads the device's busy time."""
    data, _ = tiny_phases
    monkeypatch.setattr(cs, "SERVE_ARGS", [*cs.SILO_ARGS, "--release_gate",
                                           "true"])
    monkeypatch.setattr(cs, "SPLIT_ROUNDS", 2)
    cs.SERVE_DIR.mkdir(parents=True, exist_ok=True)
    try:
        out = cs.split_arm(data, arm, profiled)
    finally:
        import shutil
        shutil.rmtree(cs.SERVE_DIR, ignore_errors=True)
    assert len(out["round_ms"]) == 2
    if profiled:
        assert out["device_busy_ms_per_round"] >= 0.0
        return
    assert out["critical_path_ms"] and "publish" in out["phase_ms"]
    assert len(out["gate_offer_ms"]) == 2
    assert out["answers_per_round"] > 0
    assert set(out["statuses"]) <= {"200", "503 no_model", "429 deadline"}


def test_serve_split_is_the_arms_differences(monkeypatch):
    """The split is ``idle`` - ``off``, ``host`` - ``idle`` and ``full`` -
    ``host`` of the arms' steady rounds, each arm run unprofiled then
    profiled."""
    calls = []
    steady = {"off": 300.0, "idle": 450.0, "host": 900.0, "full": 1400.0}

    def arm(data, name, profiled):
        calls.append((name, profiled))
        return {"steady_round_ms": steady[name]}

    monkeypatch.setattr(cs, "split_arm", arm)
    out = cs.serve_split(None)
    assert calls == [(a, p) for p in (False, True)
                     for a in ("off", "idle", "host", "full")]
    assert out["split_ms"] == {"gate_and_machinery": 150.0,
                               "requests_host": 450.0,
                               "requests_device": 500.0}
    assert out["full"]["profiled"] == {"steady_round_ms": 1400.0}


def _mesh_summary(hashes, backend="gloo", device="cuda:0"):
    return {"device": device, "dist_backend": backend,
            "world_size": len(hashes), "params_sha256": hashes[0],
            "rank_params_sha256": ",".join(hashes)}


@pytest.mark.parametrize("case", [
    "ok", "unequal_hashes", "tolerance_miss", "dead_rank", "no_summary",
    "other_backend", "off_the_card", "not_rank0s_globals",
    "last_round_miss", "first_rounds_only", "round_short"])
def test_mesh_phase_checks(monkeypatch, case):
    """Phase 8r's checks of one run: byte-equal ranks, the written globals
    rank 0's, within MESH_TOL x max|w| of its reference after every round
    (or its first rounds, where so held), the backend and device the
    layout picks; a rank that died (its launch exits non-zero) or a
    missing summary fails."""
    from fedml_tpu_torch.parallel.mesh import params_sha256
    monkeypatch.setattr(cs, "CARD", "cuda")
    ref = [{"w": torch.tensor([1.0, -2.0, 0.5])},
           {"w": torch.tensor([1.5, -2.0, 0.25])}]
    rounds = [{"w": r["w"] + 1e-6} for r in ref]
    tol = None
    if case == "tolerance_miss":
        rounds[0] = {"w": ref[0]["w"] + 3 * cs.MESH_TOL * 2.0}
    elif case == "last_round_miss":
        rounds[1] = {"w": ref[1]["w"] + 3 * cs.MESH_TOL * 2.0}
    elif case == "first_rounds_only":
        # held on its first round only, a miss after it fails nothing
        tol = 1
        rounds[1] = {"w": ref[1]["w"] + 3 * cs.MESH_TOL * 2.0}
    elif case == "round_short":
        rounds = rounds[:1]
    params = rounds[-1]
    h = params_sha256(params)
    rc, summary = 0, _mesh_summary([h, h])
    if case == "unequal_hashes":
        summary = _mesh_summary([h, "0" * 64])
    elif case == "dead_rank":
        rc, summary = 1, None
    elif case == "no_summary":
        summary = None
    elif case == "other_backend":
        summary = _mesh_summary([h, h], backend="nccl")
    elif case == "off_the_card":
        summary = _mesh_summary([h, h], device="cpu")
    elif case == "not_rank0s_globals":
        summary = _mesh_summary(["1" * 64] * 2)
    held = {"single": cs.mesh_held(rounds, ref, tol)}
    problems = cs.mesh_problems("run", rc, summary, ("gloo", 2),
                                last=params, held=held)
    assert (problems == []) == (case in ("ok", "first_rounds_only")), \
        problems
    if case == "dead_rank":
        assert problems == ["run: exited 1"]


def test_parallel_phase_configs_parse_and_pass_the_gates():
    """Phase 8s's argv: the sp CLI runner's, each pipeline run's at 1 and
    2 stages and the wave mesh's pass the CLI's gates (every check the
    runs make before a rank starts)."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import (check_config, mesh_shape,
                                                  resolve_cross_device)
    cfg = config_from_argv(cs.PAR_CLI_ARGS)
    check_config(cfg)
    assert cfg.attn_flash and mesh_shape(cfg, None) == {"clients": 1,
                                                        "sequence": 2}
    for extra in cs.PAR_PP_RUNS.values():
        for stages in ("1", "2"):
            cfg = config_from_argv([*cs.PAR_PP_ARGS, *extra,
                                    "--mesh_stages", stages])
            check_config(cfg)
            assert cfg.pp_microbatches == 2 and cfg.deterministic
    for extra in ([], ["--mesh_clients", "2"]):
        cfg = resolve_cross_device(config_from_argv([*cs.PAR_WAVE_ARGS,
                                                     *extra]))
        check_config(cfg)
        assert cfg.client_num_in_total == 340 and cfg.wave_size == 32


@pytest.mark.parametrize("case", ["ok", "miss", "round_short", "missing"])
def test_parallel_phase_holds_every_round(case):
    """8s's hold of a run's globals against its reference after every
    round: a round past ``tol`` x max|w|, a round short or no globals
    fail."""
    ref = [{"w": torch.tensor([1.0, -2.0])}, {"w": torch.tensor([1.5, -2.0])}]
    rounds = [{"w": r["w"] + 1e-7} for r in ref]
    if case == "miss":
        rounds[1] = {"w": ref[1]["w"] + 1e-3}
    elif case == "round_short":
        rounds = rounds[:1]
    elif case == "missing":
        rounds = None
    held = cs.par_held("run", rounds, ref, 1e-5)
    assert (held["failed"] == []) == (case == "ok"), held
    if case == "ok":
        assert len(held["max_abs_diff"]) == 2
        assert held["limit"] == [2e-5, 2e-5]


def test_tp_ep_phase_configs_parse_and_pass_the_gates():
    """Phase 8t's argv: each keyed run (the dropout CNN under ditto and
    cross_silo, no refusal left) and the served 2-stage pipeline pass the
    CLI's gates."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    for argv in cs.KEYED_RUNS.values():
        cfg = config_from_argv([*argv, *cs.KEYED_COMMON])
        check_config(cfg)
        assert cfg.model == "cnn" and cfg.deterministic
    cfg = config_from_argv([*cs.PP_SERVE_ARGS, "--serve_port", "8080"])
    check_config(cfg)
    assert cfg.mesh_stages == 2 and cfg.serve_port == 8080


@pytest.mark.parametrize("case", ["ok", "shed", "version", "far", "short"])
def test_pp_serve_check_fails_on_a_wrong_answer(case):
    """8t (b): every published round needs a 200 of its own version whose
    logits sit within ``tol`` x max|logit| of the CPU forward."""
    import numpy as np
    refs = [np.array([[1.0, -4.0]]), np.array([[2.0, 0.5]])]
    answers = [(200, {"version": v, "y": (r + 1e-6).tolist()})
               for v, r in enumerate(refs)]
    if case == "shed":
        answers[0] = (429, {"error": "shed", "reason": "deadline"})
    elif case == "version":
        answers[1] = (200, {"version": 0, "y": refs[1].tolist()})
    elif case == "far":
        answers[1] = (200, {"version": 1, "y": (refs[1] + 1e-3).tolist()})
    elif case == "short":
        answers = answers[:1]
    problems = cs.pp_serve_check(answers, refs, 1e-5)
    assert (problems == []) == (case == "ok"), problems


@pytest.mark.parametrize("case", ["ok", "drift", "hashes", "k4", "unsharded",
                                  "untimed"])
def test_tp_ep_problems(monkeypatch, case):
    """8t (c)/(d)'s verdict: rank 0's rounds held to one process, the
    ranks byte-equal, a leaf sharded, the tp layers timed and, on the card,
    K4 launched a rank a round as in one process."""
    monkeypatch.setattr(cs, "CARD", "cuda")
    k4 = {n: 16 for n in cs.K4_NAMES}
    ref = {"rounds": [{"w": torch.tensor([1.0])}, {"w": torch.tensor([2.0])}],
           "k4_launches": [dict(k4), dict(k4)]}
    run = {"rounds": [{"w": torch.tensor([1.0])}, {"w": torch.tensor([2.0])}],
           "hashes": ["a", "a"], "sharded": ["Dense_0/kernel"],
           "tp_ms": [3.0, 2.5], "rank": 0,
           "k4_launches": [dict(k4), dict(k4)]}
    if case == "drift":
        run["rounds"][1] = {"w": torch.tensor([2.001])}
    elif case == "hashes":
        run["hashes"] = ["a", "b"]
    elif case == "k4":
        run["k4_launches"][1] = {**k4, "flash_bwd_dq": 0}
    elif case == "unsharded":
        run["sharded"] = []
    elif case == "untimed":
        run["tp_ms"] = [0.0, 0.0]
    other = dict(run, rank=1, rounds=None)
    verdict = cs.tp_ep_problems("tp", [{"tp": run}, {"tp": other}], ref,
                                cs.TP_TOL)
    assert (verdict["problems"] == []) == (case == "ok"), verdict


# ---------------------------------------------------------------------------
# phase 8u: the data layer
# ---------------------------------------------------------------------------

def _fd_bytes_equal(a, b):
    assert (a.client_num, a.class_num) == (b.client_num, b.class_num)
    for split in ("train", "test", "train_global", "test_global"):
        sa, sb = getattr(a, split), getattr(b, split)
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype
            assert sa[k].tobytes() == sb[k].tobytes(), (split, k)


def test_data_layer_phase_configs_parse_and_pass_the_gates(tmp_path):
    """Phase 8u's argv: the defended LEAF MNIST run and the CIFAR-10 hetero
    run pass the CLI's gates with their ``--data_dir``."""
    from fedml_tpu_torch.experiments.main import check_config
    leaf = cs.data_cfg(cs.DATA_LEAF_ARGS, tmp_path)
    check_config(leaf)
    assert (leaf.defense, leaf.defense_backend, leaf.model) == (
        "weak_dp", "cuda", "lr")
    cifar = cs.data_cfg(cs.DATA_CIFAR_ARGS, tmp_path, "cpu")
    check_config(cifar)
    assert (cifar.partition_method, cifar.partition_alpha) == ("hetero", 0.5)
    assert cifar.data_dir == str(tmp_path) and cifar.platform == "cpu"
    assert cifar.client_num_per_round == cs.DATA_CIFAR_PER_ROUND


def test_leaf_mnist_writer_read_by_both_packages(tmp_path):
    """The phase's LEAF json, read by JAX's loader and the port's: the same
    `FederatedData` byte for byte; 8 in 10 pixels zero, the rest in
    hundredths."""
    import numpy as np
    from fedml_tpu.data.leaf import load_mnist as j_load
    from fedml_tpu_torch.data.leaf import load_mnist as t_load
    cs.write_leaf_mnist(tmp_path, users=12, samples=10, seed=3)
    a, b = t_load(str(tmp_path)), j_load(str(tmp_path))
    _fd_bytes_equal(a, b)
    assert a.client_num == 12 and a.train["num_samples"].tolist() == [10] * 12
    assert a.test["num_samples"].tolist() == [2] * 12
    x = a.train_global["x"][a.train_global["mask"] > 0]
    assert 0.7 < float((x == 0).mean()) < 0.9
    assert np.allclose(x * 100, np.round(x * 100), atol=1e-4)
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0


def test_cifar10_writer_read_by_both_packages(tmp_path):
    """The phase's CIFAR-10 pickles (latin1-readable dicts of data and
    labels), read and partitioned (hetero) by JAX's loader and the port's:
    byte-equal, every sample in a client."""
    import pickle
    from fedml_tpu.data.cifar import load_cifar_partitioned as j_load
    from fedml_tpu_torch.data.cifar import load_cifar_partitioned as t_load
    cs.write_cifar10(tmp_path, n_train=500, n_test=100, seed=1)
    with open(tmp_path / "cifar-10-batches-py" / "data_batch_3", "rb") as f:
        batch = pickle.load(f, encoding="latin1")
    assert batch["data"].shape == (100, 3072)
    assert batch["data"].dtype.name == "uint8"
    assert len(batch["labels"]) == 100 and max(batch["labels"]) <= 9
    kw = dict(client_num=4, partition_method="hetero", partition_alpha=0.5,
              batch_size=16, seed=0)
    a = t_load("cifar10", str(tmp_path), **kw)
    _fd_bytes_equal(a, j_load("cifar10", str(tmp_path), **kw))
    assert a.train["num_samples"].sum() == 500
    assert a.test["num_samples"].sum() == 100


def _data_rows(**over):
    leaf = {"launches": {"clip_norm": 2, "robust_agg": 2}, "rounds": 2,
            "clients": cs.DATA_LEAF_USERS, "vs_cpu_max_abs_diff": 3e-8,
            "params_finite": True}
    counts = [9000, 2000, 500, 12000, 4000, 3000, 6000, 7000, 5500, 1000]
    cifar = {"client_counts": counts, "test_samples": cs.DATA_CIFAR_TEST,
             "params_finite": True}
    augment = {k: {"ulps": 0} for k in ("cifar_train_augment",
                                        "fed_cifar100_train_augment",
                                        "normalize")}
    memmap = {"bit_equal": True, "max_abs_diff": 0.0, "still_mapped": True,
              "host_gather": {"memmap": True, "ram": True}}
    rows = {"leaf": leaf, "cifar": cifar, "augment": augment,
            "memmap": memmap}
    for path, value in over.items():
        part, key = path.split("__")
        rows[part][key] = value
    return rows


@pytest.mark.parametrize("over, ok", [
    ({}, True),
    ({"leaf__launches": {"clip_norm": 2, "robust_agg": 0}}, False),
    ({"leaf__vs_cpu_max_abs_diff": 2e-4}, False),
    ({"leaf__clients": 999}, False),
    ({"cifar__client_counts": [5000] * 10}, False),
    ({"cifar__client_counts": [9, 49991] + [0] * 8}, False),
    ({"cifar__params_finite": False}, False),
    ({"augment__cifar_train_augment": {"ulps": 1}}, False),
    ({"augment__cifar_train_augment": {"ulps": 1},
      "augment__normalize": {"ulps": 1}}, True),
    ({"augment__fed_cifar100_train_augment": {"ulps": 2},
      "augment__normalize": {"ulps": 1}}, False),
    ({"memmap__bit_equal": False}, False),
    ({"memmap__host_gather": {"memmap": False, "ram": True}}, False),
])
def test_data_layer_problems(over, ok):
    """8u's verdict: K1n and K1 once a round on LEAF MNIST, the card within
    ROUND_TOL of the CPU, every user loaded, a hetero split of all 50,000
    samples with each client >= 10, augmentation bit-equal (1 ulp only
    where the card's normalize itself is 1 ulp off), memmap rounds
    bit-equal on the host gather."""
    rows = _data_rows(**over)
    problems = cs.data_problems(rows["leaf"], rows["cifar"], rows["augment"],
                                rows["memmap"])
    assert (problems == []) == ok, problems


def test_data_layer_cpu_parts(monkeypatch, tmp_path):
    """8u (c) and (d) on the CPU: the pipelines against themselves (0
    ulps), and the memmapped LEAF split's FedAvg rounds bit-equal to the
    in-memory ones on the host gather."""
    from fedml_tpu_torch.experiments.main import load_experiment_data
    monkeypatch.setattr(cs, "CARD", "cpu")
    monkeypatch.setattr(cs, "DATA_AUG_SHAPE", (2, 3, 32, 32, 3))
    aug = cs.data_augment()
    assert all(r["ulps"] == 0 for r in aug.values())
    assert aug["fed_cifar100_train_augment"]["shape"] == [2, 3, 24, 24, 3]
    cs.write_leaf_mnist(tmp_path / "leaf", users=30, samples=10)
    cfg = cs.data_cfg(cs.DATA_LEAF_ARGS, tmp_path / "leaf", "cpu")
    data = load_experiment_data(cfg)
    out = cs.data_memmap(data, cfg, tmp_path / "mm")
    assert out["bit_equal"] and out["still_mapped"]
    assert out["host_gather"] == {"memmap": True, "ram": True}


def test_long_tail_phase_configs_parse_and_pass_the_gates():
    """Phase 8v's argv: each run passes the CLI's gates; the gossip runs
    10 FEMNIST CNN nodes over ``--neighbor_num 4``, the online runs keep
    the CLI's defaults (128 nodes, T=100), the backdoor run is K1n + K1's
    defended path."""
    from fedml_tpu_torch.experiments.main import check_config
    for argv in (cs.LT_GOSSIP_ARGS, cs.LT_SPLIT_ARGS, cs.LT_VFL_ARGS,
                 cs.LT_GKT_ARGS, cs.LT_BACKDOOR_ARGS,
                 *(cs.LT_ONLINE_ARGS + extra
                   for extra in cs.LT_ONLINE_RUNS.values())):
        check_config(cs.lt_cfg(argv, "cpu"))
    g = cs.lt_cfg(cs.LT_GOSSIP_ARGS)
    assert (g.model, g.client_num_in_total, g.neighbor_num, g.batch_size,
            g.comm_round) == ("cnn_fedavg", 10, 4, 20, 3)
    o = cs.lt_cfg(cs.LT_ONLINE_ARGS)
    assert (min(o.client_num_in_total, 128), o.iteration_number) == (128,
                                                                     100)
    b = cs.lt_cfg(cs.LT_BACKDOOR_ARGS)
    assert (b.backdoor, b.attacker_num, b.defense, b.defense_backend,
            b.client_num_per_round, b.comm_round) == (True, 1, "weak_dp",
                                                      "cuda", 10, 2)
    k = cs.lt_cfg(cs.LT_GKT_ARGS)
    assert (k.client_num_per_round, k.batch_size, k.comm_round) == (4, 64, 2)


def _long_tail_rows(**over):
    online = {"regret_rel_diff": 2e-7, "z_rel_diff": 3e-7,
              "graph_captures": 2}
    rows = {"gossip": {"node_params": cs.LT_CNN_PARAMS, "rounds": 3,
                       "rounds_vs_cpu": [1e-7, 2e-7, 3e-7]},
            "online": {k: dict(online) for k in cs.LT_ONLINE_RUNS},
            "split": {"body_vs_cpu": 1e-7, "head_vs_cpu": 0.0,
                      "actors_vs_simulator": 1e-7},
            "vfl": {"fit_vs_cpu": 1e-7, "wire_vs_joint": 2e-7},
            "gkt": {"clients_vs_cpu": 3e-6, "server_vs_cpu": 4e-6},
            "backdoor": {"launches": {"clip_norm": 2, "robust_agg": 2},
                         "rounds": 2, "vs_cpu_max_abs_diff": 3e-8,
                         "backdoor_acc": 0.25, "backdoor_acc_cpu": 0.25,
                         "params_finite": True},
            "signal": {"written": True, "matches": True}}
    for path, value in over.items():
        part, key = path.split("__")
        if part == "online":
            rows["online"]["PUSHSUM"][key] = value
        else:
            rows[part][key] = value
    return rows


@pytest.mark.parametrize("over, ok", [
    ({}, True),
    ({"gossip__rounds_vs_cpu": [1e-7, 2e-4, 0.0]}, False),
    ({"gossip__rounds_vs_cpu": []}, False),
    ({"gossip__node_params": 1_199_882}, False),
    ({"online__regret_rel_diff": 2e-5}, False),
    ({"online__z_rel_diff": float("nan")}, False),
    ({"online__graph_captures": 0}, False),
    ({"split__actors_vs_simulator": 3e-4}, False),
    ({"vfl__wire_vs_joint": 1e-3}, False),
    ({"gkt__server_vs_cpu": 2e-4}, False),
    ({"backdoor__launches": {"clip_norm": 2, "robust_agg": 0}}, False),
    ({"backdoor__launches": {"clip_norm": 0, "robust_agg": 2}}, False),
    ({"backdoor__vs_cpu_max_abs_diff": 2e-4}, False),
    ({"backdoor__backdoor_acc": 0.26}, False),
    ({"backdoor__params_finite": False}, False),
    ({"signal__written": False}, False),
    ({"signal__matches": False}, False),
])
def test_long_tail_problems(over, ok):
    """8v's verdict: every gossip round within LT_TOL x max|w| of the CPU
    at the CNN's full width, the online runs' regret and z within
    LT_ONLINE_TOL relative on the card's graphed loop, SplitNN, its
    actors, VFL, its wire and FedGKT
    within LT_TOL, the backdoor run's K1n and K1 once a round and its
    globals within ROUND_TOL, its backdoor_acc equal, the signal
    written."""
    problems = cs.long_tail_problems(_long_tail_rows(**over))
    assert (problems == []) == ok, problems


def test_long_tail_cpu_parts(monkeypatch, tmp_path):
    """8v (c), (d) and (g) on the CPU: the card runs are the CPU's own, so
    every difference is 0, and the completion signal is the summary."""
    monkeypatch.setattr(cs, "CARD", "cpu")
    split = cs.lt_split()
    assert (split["clients"], split["sweeps"]) == (4, 2)
    assert split["body_vs_cpu"] == split["head_vs_cpu"] == 0.0
    assert split["actors_vs_simulator"] <= cs.LT_TOL
    vfl = cs.lt_vfl()
    assert vfl["fit_vs_cpu"] == 0.0 and vfl["wire_vs_joint"] <= cs.LT_TOL
    assert cs.lt_signal(tmp_path) == {"written": True, "matches": True}


def test_chip_smoke_defines_each_name_once():
    """Every top-level function, class and constant of the script is
    defined once: a phase's helper of an earlier phase's name would
    replace it for every phase (a second ``_cpu_tree`` once broke phase
    12 on the card)."""
    import ast
    import collections
    from pathlib import Path
    tree = ast.parse(Path(cs.__file__).read_text())
    names = collections.Counter(
        n.name for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    names.update(t.id for n in tree.body if isinstance(n, ast.Assign)
                 for t in n.targets if isinstance(t, ast.Name))
    assert [k for k, v in names.items() if v > 1] == []
