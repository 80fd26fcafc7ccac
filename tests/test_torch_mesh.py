"""The port's data parallelism over ``torch.distributed`` against the JAX
package's meshes.

Each world size's ranks (D = 2 and 4: a gloo group on the CPU, one rank a
position of the ``clients`` axis) start once for the module: one spawn
(`parallel.launch.spawn_ranks`) runs every case of
`torch_mesh_jobs.mesh_job` and returns each rank's results, while this
process runs the JAX package on the conftest's 8 CPU devices (its mesh of
D devices, and one device) from the same init (carried with
`utils/jax_params.py`).  Each case then holds the port's ranks to:

* each other, bit for bit (every rank's params sha256 equal);
* the JAX package's single device and its D-device mesh at
  ``tests/test_fedavg_oracle.py:184``'s tolerance (rtol 1e-4, atol 1e-5):
  a D-rank sum reassociates the weighted mean;
* the port's single-process run at the same tolerance.

Mirrors ``test_fedavg_oracle.py:146`` and ``:164`` (the sharded cohort
step and the chunked sharded eval), ``test_algorithms.py:262`` (the
two-level round), ``test_experiments.py:65`` and ``:236`` (the CLI on
one invocation's 8 ranks and on two processes with the coordinator
flags), the mesh factorization errors and JAX's refusals.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fedml_tpu.algorithms.fedavg import FedAvg as JFedAvg
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JFedAvgConfig
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobust as JRobust
from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustConfig as JRobustConfig
from fedml_tpu.algorithms.hierarchical import HierarchicalConfig as JHConfig
from fedml_tpu.algorithms.hierarchical import HierarchicalFedAvg as JHier
from fedml_tpu.data.stacking import FederatedData as JData
from fedml_tpu.data.stacking import stack_client_data
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.parallel.cohort import make_cohort_step as j_cohort_step
from fedml_tpu.parallel.mesh import make_mesh as j_make_mesh
from fedml_tpu.parallel.mesh import make_two_level_mesh as j_two_level
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                      FedAvgRobustConfig)
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.parallel import mesh as mesh_lib
from fedml_tpu_torch.parallel.launch import RankFailed, spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL, ATOL = 1e-4, 1e-5        # tests/test_fedavg_oracle.py:184
EVAL_RTOL = 1e-5               # summed eval metrics, port vs JAX
JOIN_S = 120                   # a spawn that outlives this fails the test
DIM, CLASSES = 12, 4


def _clients(n_clients, seed=0, min_n=6, max_n=20):
    """``test_fedavg_oracle.py``'s ragged synthetic clients."""
    rng = np.random.RandomState(seed)
    W = rng.randn(DIM, CLASSES)
    xs, ys = [], []
    for _ in range(n_clients):
        n = rng.randint(min_n, max_n + 1)
        x = rng.randn(n, DIM).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ W + 0.1 * rng.randn(n, CLASSES),
                            axis=1).astype(np.int32))
    return xs, ys


def _jwl():
    return JWorkload(JLR(DIM, CLASSES), num_classes=CLASSES,
                     grad_clip_norm=None)


def _jdata(xs, ys, batch):
    train = stack_client_data(xs, ys, batch_size=batch)
    return JData(client_num=len(xs), class_num=CLASSES, train=train,
                 test=train)


def _init(train, seed=7):
    p = _jwl().init(jax.random.key(seed), jax.tree.map(
        lambda v: jnp.asarray(v[0, 0]),
        {k: train[k] for k in ("x", "y", "mask")}))
    return p, {f"Dense_0/{k}": np.asarray(v)
               for k, v in p["Dense_0"].items()}


def _flat(jax_params):
    return {f"Dense_0/{k}": np.asarray(v)
            for k, v in jax_params["Dense_0"].items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


COHORT_XS, COHORT_YS = _clients(8)
COHORT = stack_client_data(COHORT_XS, COHORT_YS, batch_size=5)
J_INIT, INIT = _init(COHORT)
FEDAVG_XS, FEDAVG_YS = _clients(7, seed=1)
FEDAVG_CFG = dict(comm_round=2, client_num_per_round=4, batch_size=5,
                  lr=0.1, frequency_of_the_test=1, eval_chunk_clients=2)
HIER_XS, HIER_YS = _clients(8, seed=2, min_n=10, max_n=24)
HIER_CFG = dict(comm_round=3, client_num_per_round=8, epochs=1,
                batch_size=30, lr=0.2, group_num=2, group_comm_round=2,
                frequency_of_the_test=100)
ROBUST_CFG = dict(comm_round=2, client_num_per_round=8, batch_size=5,
                  lr=0.1, frequency_of_the_test=100, norm_bound=0.05,
                  stddev=0.01)

SPEC = {
    "cohort": dict(xs=COHORT_XS, ys=COHORT_YS, batch=5, dim=DIM,
                   classes=CLASSES, init=INIT),
    "fedavg": dict(xs=FEDAVG_XS, ys=FEDAVG_YS, batch=5, dim=DIM,
                   classes=CLASSES, init=INIT, cfg=FEDAVG_CFG),
    "robust": dict(algo="fedavg_robust", cfg=ROBUST_CFG, dim=DIM,
                   data=(COHORT_XS, COHORT_YS, 5, CLASSES), init=INIT),
    "hierarchical": dict(xs=HIER_XS, ys=HIER_YS, batch=30, dim=DIM,
                         classes=CLASSES, init=INIT, cfg=HIER_CFG),
}


_CLI = ["--algo", "fedavg", "--model", "lr", "--dataset", "mnist",
        "--client_num_in_total", "16", "--client_num_per_round", "8",
        "--comm_round", "2", "--batch_size", "4", "--frequency_of_the_test",
        "1", "--platform", "cpu", "--log_stdout", "false"]


def _jax_refs():
    """The JAX package's results: one device, and its D-device meshes."""
    refs = {}
    local = j_local(_jwl(), j_opt("sgd", 0.1), epochs=1)
    cohort = {k: jnp.asarray(v) for k, v in COHORT.items()}
    refs["cohort_single"] = _flat(j_cohort_step(local)(
        J_INIT, cohort, jax.random.key(5))[0])
    for d in WORLDS:
        mesh = j_make_mesh(client_axis=d, devices=jax.devices()[:d])
        refs[f"cohort_mesh{d}"] = _flat(j_cohort_step(local, mesh=mesh)(
            J_INIT, cohort, jax.random.key(5))[0])
    fdata = _jdata(FEDAVG_XS, FEDAVG_YS, 5)
    single = JFedAvg(_jwl(), fdata, JFedAvgConfig(**FEDAVG_CFG))
    refs["fedavg_single"] = _flat(single.run(params=J_INIT))
    refs["fedavg_history"] = single.history
    refs["eval_chunked"] = single.evaluate_global(J_INIT)
    refs["robust_clip"] = _flat(JRobust(
        _jwl(), _jdata(COHORT_XS, COHORT_YS, 5), JRobustConfig(
            defense="norm_diff_clipping", **ROBUST_CFG)).run(params=J_INIT))
    hdata = _jdata(HIER_XS, HIER_YS, 30)
    refs["hier_single"] = _flat(JHier(_jwl(), hdata, JHConfig(
        **HIER_CFG)).run(params=J_INIT, rng=jax.random.key(0)))
    for d in WORLDS:
        refs[f"hier_two_level{d}"] = _flat(JHier(
            _jwl(), hdata, JHConfig(**HIER_CFG),
            mesh=j_two_level(group_axis=2, client_axis=d // 2,
                             devices=jax.devices()[:d])).run(
            params=J_INIT, rng=jax.random.key(0)))
    return refs


def _port_single(name):
    """The port's single-process run of a case."""
    if name == "fedavg":
        algo = FedAvg(jobs.lr_workload(DIM, CLASSES),
                      jobs.fed_data(FEDAVG_XS, FEDAVG_YS, 5, CLASSES),
                      FedAvgConfig(**FEDAVG_CFG), device="cpu")
        return jobs._np(algo.run(params={k: torch.tensor(np.array(v))
                                         for k, v in INIT.items()}))
    return jobs.run_algo(dict(SPEC["robust"], cfg=dict(
        ROBUST_CFG, defense=name)))["params"]


@pytest.fixture(scope="module")
def runs():
    """Every rank's results at D = 2 and 4 (both spawned at once, from
    worker threads), and meanwhile the JAX package's results and the
    port's single-process runs."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {d: pool.submit(spawn_ranks, jobs.mesh_job, d, (d, SPEC),
                               "cpu", JOIN_S) for d in WORLDS}
        refs = _jax_refs()
        refs.update({f"port_{name}": _port_single(name) for name in
                     ("fedavg", "norm_diff_clipping", "weak_dp")})
        refs["cli_single"] = main(_CLI)
        return {d: f.result() for d, f in futs.items()}, refs


def _ranks_agree(ranks, key):
    hashes = {r[key + "_sha256"] for r in ranks}
    assert len(hashes) == 1, f"{key}: the ranks' params differ"


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_their_block_of_rows(runs, world):
    ranks = runs[0][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    rows = 8 // world
    ns = COHORT["num_samples"]
    for r in ranks:
        assert r["block_rows"] == [8, rows]
        assert r["block_num_samples"] == ns[r["rank"] * rows:
                                            (r["rank"] + 1) * rows].tolist()
        assert r["coords"] == {"clients": r["rank"], "model": 0}
        assert r["two_level_coords"] == {"groups": r["rank"] // (world // 2),
                                         "clients": r["rank"] % (world // 2)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cohort_step_equals_single_chip(runs, world):
    """``test_fedavg_oracle.py:164``: the D-rank cohort step against JAX's
    one device and its D-device shard_map, rtol 1e-4, atol 1e-5."""
    ranks, refs = runs[0][world], runs[1]
    _ranks_agree(ranks, "cohort_step")
    got = ranks[0]["cohort_step"]
    _close(got, refs["cohort_single"])
    _close(got, refs[f"cohort_mesh{world}"])


@pytest.mark.parametrize("world", WORLDS)
def test_fedavg_rounds_on_the_mesh(runs, world):
    """Two FedAvg rounds (4 of 7 clients a round) on D ranks against JAX's
    one device and the port's single process; the eval rows every round
    within 1e-5 of JAX's; a collective time a round recorded."""
    ranks, refs = runs[0][world], runs[1]
    _ranks_agree(ranks, "fedavg")
    got = ranks[0]["fedavg"]
    _close(got, refs["fedavg_single"])
    _close(got, refs["port_fedavg"])
    for row, want in zip(ranks[0]["fedavg_history"], refs["fedavg_history"]):
        for k in ("train_acc", "train_loss", "test_loss"):
            np.testing.assert_allclose(row[k], want[k], rtol=EVAL_RTOL)
    assert len(ranks[0]["fedavg_collective_ms"]) == 2
    assert all(ms > 0 for ms in ranks[0]["fedavg_collective_ms"])


@pytest.mark.parametrize("world", WORLDS)
def test_chunked_sharded_eval_equals_full_sweep(runs, world):
    """``test_fedavg_oracle.py:146``: 7 clients in chunks of 2, each chunk
    padded to the ranks and summed over them, against JAX's chunked sweep
    (rtol 1e-5)."""
    got, want = runs[0][world][0]["eval_chunked"], runs[1]["eval_chunked"]
    assert got.keys() == want.keys() and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL)
    assert all(r["eval_chunked"] == got for r in runs[0][world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("defense", ["norm_diff_clipping", "weak_dp"])
def test_defense_hook_on_the_mesh(runs, world, defense):
    """JAX :132-144: the clip (and weak DP's noise, keyed by each client's
    global slot) as the per-client hook of the sharded step: against the
    port's single process (rtol 1e-4, atol 1e-5), and the clip against
    JAX's."""
    ranks, refs = runs[0][world], runs[1]
    _ranks_agree(ranks, f"robust_{defense}")
    got = ranks[0][f"robust_{defense}"]
    _close(got, refs[f"port_{defense}"])
    if defense == "norm_diff_clipping":
        _close(got, refs["robust_clip"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", ["two_level", "clients"])
def test_hierarchical_mesh_matches_vmapped(runs, world, layout):
    """``test_algorithms.py:262``: the [groups, clients] round (a [2,
    D/2] mesh) and the group loop over the D-rank client mesh against
    JAX's vmapped groups on one device, and the two-level round against
    JAX's [2, D/2] mesh (rtol 1e-4, atol 1e-5)."""
    ranks, refs = runs[0][world], runs[1]
    _ranks_agree(ranks, f"hier_{layout}")
    got = ranks[0][f"hier_{layout}"]
    _close(got, refs["hier_single"])
    if layout == "two_level":
        _close(got, refs[f"hier_two_level{world}"])


def test_a_failing_rank_fails_the_launch():
    """A rank that raises fails the launch with its error; the rank left
    waiting at a collective is stopped, not waited for."""
    with pytest.raises(RankFailed, match="rank 1 gives up"):
        spawn_ranks(jobs.failing_job, 2, (1,), "cpu", JOIN_S)


def _hashes_equal(summary, world):
    hashes = summary["rank_params_sha256"].split(",")
    assert len(hashes) == world and len(set(hashes)) == 1
    assert hashes[0] == summary["params_sha256"]


def test_cli_mesh_equals_single_chip(runs):
    """``test_experiments.py:65``: ``--mesh_clients 8`` on 8 CPU ranks
    from one invocation reproduces the single-process run (accuracy
    rtol 1e-6, loss 1e-5); the ranks' params byte-equal."""
    single = runs[1]["cli_single"]
    sharded = main(_CLI + ["--host_device_count", "8", "--mesh_clients",
                           "8"])
    np.testing.assert_allclose(single["train_acc"], sharded["train_acc"],
                               rtol=1e-6)
    np.testing.assert_allclose(single["train_loss"], sharded["train_loss"],
                               rtol=1e-5)
    assert sharded["dist_backend"] == "gloo" and sharded["world_size"] == 8
    _hashes_equal(sharded, 8)


def test_cli_coordinator_flags_on_two_processes(runs, tmp_path):
    """``test_experiments.py:236``: two processes joined by
    ``--coordinator_address`` (``--num_processes 2 --process_id i``)
    reproduce the single-process run; rank 0 alone prints the summary
    and writes the run directory."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "fedml_tpu_torch", *_CLI,
            "--mesh_clients", "2", "--coordinator_address",
            f"127.0.0.1:{port}", "--num_processes", "2",
            "--run_dir", str(tmp_path / "run")]
    procs = [subprocess.Popen(argv + ["--process_id", str(i)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    lines = [[json.loads(line) for line in out.splitlines()
              if line.startswith("{")] for out in outs]
    assert len(lines[0]) == 1 and not lines[1]
    sharded, single = lines[0][0], runs[1]["cli_single"]
    np.testing.assert_allclose(single["train_acc"], sharded["train_acc"],
                               rtol=1e-6)
    np.testing.assert_allclose(single["train_loss"], sharded["train_loss"],
                               rtol=1e-5)
    _hashes_equal(sharded, 2)
    assert os.listdir(tmp_path) == ["run"]     # one writer


def test_mesh_factorization_errors():
    """JAX's named errors (``test_shard_spine.py:160``), and a mesh whose
    size is not the world's."""
    with pytest.raises(ValueError, match="factor"):
        mesh_lib.check_mesh_factors(3, 2, 8)
    with pytest.raises(ValueError, match="model_axis"):
        mesh_lib.make_mesh(model_axis=0, device="cpu")
    with pytest.raises(ValueError, match="groups axis must be >= 1"):
        mesh_lib.make_two_level_mesh(group_axis=0, device="cpu")
    with pytest.raises(ValueError, match="product"):
        mesh_lib.check_two_level_factors(3, None, 8)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh(client_axis=2, devices=2, device="cpu")
    # a model axis over 2 ranks is built (tensor parallelism), and like
    # any mesh it needs its ranks
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh(client_axis=1, model_axis=2, devices=2,
                           device="cpu")
    one = mesh_lib.make_mesh(device="cpu")    # one position, no group
    assert one.shape == {"clients": 1, "model": 1} and one.backend is None
    x = {"a": torch.arange(3.0)}
    assert one.allsum(x)["a"].tolist() == [0.0, 1.0, 2.0]
    assert mesh_lib.client_axis_size(one) == 1
    assert mesh_lib.client_axis_size(None) == 1
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.stage_global({"x": torch.zeros(3)},
                              mesh_lib.Mesh({"clients": 2}, device="cpu"),
                              "clients")


@pytest.mark.parametrize("flags, exc, match", [
    (["--mesh_groups", "2"], ValueError, "only the hierarchical"),
    (["--algo", "async_fl", "--mesh_clients", "2"], ValueError,
     "async actor mode"),
    (["--algo", "cross_silo", "--mesh_clients", "2"], ValueError,
     "cross-silo actor mode"),
    (["--algo", "turboaggregate", "--mesh_clients", "2"], ValueError,
     "takes no mesh"),
    (["--mesh_clients", "8", "--host_device_count", "4"], ValueError,
     r"\[8, 1\].*from 4 devices"),
    (["--algo", "hierarchical", "--mesh_groups", "4"], ValueError,
     "exceeds the 1 available"),
    (["--num_processes", "2"], ValueError, "--mesh_clients"),
    (["--algo", "fedavg_robust", "--defense", "krum", "--mesh_clients",
      "2"], ValueError, "full cohort on one"),
    (["--algo", "fedavg_robust", "--defense_backend", "cuda",
      "--mesh_clients", "2"], ValueError, "does not shard"),
    # sequence and pipeline parallelism are ported: JAX's gates
    (["--mesh_sequence", "2"], ValueError, "requires --model transformer"),
    (["--mesh_stages", "2"], ValueError, "only applies to --algo cross_silo"),
])
def test_cli_mesh_gates(flags, exc, match):
    with pytest.raises(exc, match=match):
        main(["--model", "lr", "--dataset", "mnist", "--platform", "cpu",
              "--client_num_in_total", "8", "--client_num_per_round", "4",
              "--comm_round", "1", "--log_stdout", "false"] + flags)


def test_refusals_on_a_mesh():
    """JAX :69-74 and :116-121: the Byzantine rules and the fused kernel
    backend refuse a mesh; the cohort must divide over it."""
    mesh = mesh_lib.make_mesh(device="cpu")
    data = jobs.fed_data(COHORT_XS, COHORT_YS, 5, CLASSES)
    wl = jobs.lr_workload(DIM, CLASSES)
    base = dict(comm_round=1, client_num_per_round=4)
    with pytest.raises(ValueError, match="full cohort on one"):
        FedAvgRobust(wl, data, FedAvgRobustConfig(defense="krum", **base),
                     mesh=mesh)
    with pytest.raises(ValueError, match="does not shard"):
        FedAvgRobust(wl, data, FedAvgRobustConfig(defense_backend="cuda",
                                                  **base), mesh=mesh)
    two = mesh_lib.Mesh({"clients": 3}, device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh"):
        FedAvg(wl, data, FedAvgConfig(**base), mesh=two)


@pytest.mark.parametrize("on", [True, False])
def test_deterministic_flags_hold_for_the_run_only(on):
    """``--deterministic`` sets cuDNN's deterministic algorithms and turns
    TF32 off inside the run, and the process's flags come back after it,
    also when the run raises."""
    from fedml_tpu_torch.experiments.main import deterministic_flags
    b = torch.backends
    flags = lambda: (b.cudnn.deterministic, b.cudnn.benchmark,  # noqa: E731
                     b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    saved = flags()
    b.cudnn.deterministic, b.cudnn.benchmark = False, True
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with deterministic_flags(on):
                assert flags() == ((True, False, False, False) if on
                                   else (False, True, True, True))
                raise RuntimeError("inside")
        assert flags() == (False, True, True, True)
    finally:
        (b.cudnn.deterministic, b.cudnn.benchmark,
         b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32) = saved
