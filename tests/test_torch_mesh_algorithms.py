"""The stateful algorithms' mesh wrap over ``torch.distributed`` against
the JAX package.

FedNova, SCAFFOLD (a full and a genuinely padded cohort), FedDyn, Ditto,
FedAC and DP-FedAvg (noise off and on) share one wrap
(`parallel.cohort.make_sharded_stateful_round`); FedOpt and FedProx ride
FedAvg's sharded step.  Each world size's ranks (D = 2 and 4, a gloo group
on the CPU) start once for the module and run every case
(`torch_mesh_jobs.algorithms_job`) from the JAX package's init, carried
across; meanwhile this process runs each case through the JAX package on
one device and on its D-device mesh (half the cases at D = 2, half at 4).

Each case holds the port's ranks to each other bit for bit (params
sha256), to the JAX package's single device and mesh at
``tests/test_fedavg_oracle.py:184``'s tolerance (rtol 1e-4, atol 1e-5,
params and state), and to the port's single process at the JAX mesh
test's own tolerance (atol 1e-6; rtol 1e-4, atol 1e-5 for FedNova), state
included: every rank scatters the gathered rows by the same global slots.
DP-FedAvg's ε equals JAX's and its accountant counts each mesh round.
Mirrors ``test_scaffold.py:148``, ``:173``, ``test_feddyn.py:146``,
``test_ditto.py:179``, ``test_fedac.py:126``, ``test_dp_fedavg.py:170``,
``test_fednova_detail.py:51`` and ``test_experiments.py:359`` (the
stateful CLI runs on 4 ranks against one process).
"""

import concurrent.futures

import jax
import numpy as np
import pytest

import torch_mesh_jobs as jobs
from fedml_tpu.algorithms.ditto import Ditto as JDitto
from fedml_tpu.algorithms.ditto import DittoConfig as JDittoConfig
from fedml_tpu.algorithms.dp_fedavg import DPFedAvg as JDP
from fedml_tpu.algorithms.dp_fedavg import DPFedAvgConfig as JDPConfig
from fedml_tpu.algorithms.fedac import FedAC as JFedAC
from fedml_tpu.algorithms.fedac import FedACConfig as JFedACConfig
from fedml_tpu.algorithms.feddyn import FedDyn as JFedDyn
from fedml_tpu.algorithms.feddyn import FedDynConfig as JFedDynConfig
from fedml_tpu.algorithms.fednova import FedNova as JFedNova
from fedml_tpu.algorithms.fednova import FedNovaConfig as JFedNovaConfig
from fedml_tpu.algorithms.scaffold import Scaffold as JScaffold
from fedml_tpu.algorithms.scaffold import ScaffoldConfig as JScaffoldConfig
from fedml_tpu.data.stacking import FederatedData as JData
from fedml_tpu.data.stacking import stack_client_data
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.parallel.mesh import make_mesh as j_make_mesh
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.parallel.launch import spawn_ranks

WORLDS = (2, 4)
RTOL, ATOL = 1e-4, 1e-5        # tests/test_fedavg_oracle.py:184
MESH_ATOL = 1e-6               # the JAX stateful mesh tests' limit
JOIN_S = 120                   # a spawn that outlives this fails the test
DIM, CLASSES = 12, 4


def _clients(n_clients, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(DIM, CLASSES)
    xs, ys = [], []
    for _ in range(n_clients):
        n = rng.randint(6, 21)
        x = rng.randn(n, DIM).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ W + 0.1 * rng.randn(n, CLASSES),
                            axis=1).astype(np.int32))
    return xs, ys


FULL, PAD6, PAD4 = _clients(8), _clients(6, seed=1), _clients(4, seed=2)
_J_INIT = JWorkload(JLR(DIM, CLASSES), num_classes=CLASSES).init(
    jax.random.key(7), {"x": np.zeros((1, DIM), np.float32),
                        "y": np.zeros(1, np.int32),
                        "mask": np.ones(1, np.float32)})
INIT = {f"Dense_0/{k}": np.asarray(v) for k, v in _J_INIT["Dense_0"].items()}
BASE = dict(epochs=2, batch_size=8, lr=0.1, frequency_of_the_test=100)

# name -> (algo, clients, config, the D of its JAX mesh comparison, the
# JAX class and config, the port-vs-port tolerance)
CASES = {
    "scaffold_full": ("scaffold", FULL, dict(
        BASE, comm_round=3, client_num_per_round=8), 2,
        JScaffold, JScaffoldConfig, dict(atol=MESH_ATOL)),
    "scaffold_padded": ("scaffold", PAD6, dict(
        BASE, comm_round=2, client_num_per_round=8), 4,
        JScaffold, JScaffoldConfig, dict(atol=MESH_ATOL)),
    "feddyn_padded": ("feddyn", PAD4, dict(
        BASE, comm_round=2, client_num_per_round=8, feddyn_alpha=0.05), 4,
        JFedDyn, JFedDynConfig, dict(atol=MESH_ATOL)),
    "ditto_padded": ("ditto", PAD4, dict(
        BASE, comm_round=2, client_num_per_round=8, ditto_lambda=0.2), 4,
        JDitto, JDittoConfig, dict(atol=MESH_ATOL)),
    "fedac_padded": ("fedac", PAD4, dict(
        BASE, comm_round=2, client_num_per_round=8, fedac_mu=0.1,
        lr=0.05), 2, JFedAC, JFedACConfig, dict(atol=MESH_ATOL)),
    "dp_z0_full": ("dp_fedavg", FULL, dict(
        BASE, comm_round=2, client_num_per_round=8, dp_clip=0.5,
        dp_noise_multiplier=0.0), None, None, None, dict(atol=MESH_ATOL)),
    "dp_z1_padded": ("dp_fedavg", PAD4, dict(
        BASE, comm_round=2, client_num_per_round=8, dp_clip=0.5,
        dp_noise_multiplier=1.0), 4, JDP, JDPConfig, dict(atol=MESH_ATOL)),
    "fednova_full": ("fednova", FULL, dict(
        BASE, comm_round=3, client_num_per_round=8, batch_size=4,
        momentum=0.9, gmf=0.5), 2, JFedNova, JFedNovaConfig,
        dict(rtol=RTOL, atol=ATOL)),
    # DP without noise, and FedAvg's sharded step under a server step and
    # a prox term: the port against its single process only
    "fedopt": ("fedopt", FULL, dict(
        BASE, comm_round=2, client_num_per_round=4, server_optimizer="sgd",
        server_lr=1.0, server_momentum=0.9), None, None, None,
        dict(atol=MESH_ATOL)),
    "fedprox": ("fedprox", FULL, dict(
        BASE, comm_round=2, client_num_per_round=4, mu=0.3), None, None,
        None, dict(atol=MESH_ATOL)),
}

_CLI = ["--model", "lr", "--dataset", "mnist", "--client_num_in_total", "8",
        "--client_num_per_round", "4", "--comm_round", "2",
        "--frequency_of_the_test", "1", "--batch_size", "4", "--log_stdout",
        "false", "--platform", "cpu"]
CLI = {
    "scaffold": ["--algo", "scaffold"],
    "feddyn": ["--algo", "feddyn", "--feddyn_alpha", "0.05"],
    "ditto": ["--algo", "ditto", "--ditto_lambda", "0.1"],
    "fedac": ["--algo", "fedac", "--fedac_mu", "0.1"],
    "dp_fedavg": ["--algo", "dp_fedavg", "--dp_clip", "0.5",
                  "--dp_noise_multiplier", "1.0"],
}
CLI_WORLD = 4                  # test_experiments.py:359's --mesh_clients 4


def _case(name):
    algo, (xs, ys), cfg = CASES[name][:3]
    return dict(algo=algo, cfg=cfg, data=(xs, ys, cfg["batch_size"],
                                          CLASSES), dim=DIM, init=INIT)


def _jax_state(name, algo):
    def arrs(tree):
        return [np.asarray(v) for v in jax.tree.leaves(tree)]
    kind = CASES[name][0]
    if kind == "scaffold":
        return arrs(algo.c_global) + arrs(algo.c_locals)
    if kind == "feddyn":
        return arrs(algo.h_state) + arrs(algo.lam_locals)
    if kind == "ditto":
        return arrs(algo.v_locals)
    if kind == "fedac":
        return arrs(algo._x_state)
    if kind == "fednova":
        return arrs(algo._gmf_buf)
    return []


def _jax_run(name, label):
    """One case through the JAX package, on one device or on its
    D-device mesh: params, state, ε."""
    algo, (xs, ys), cfg, d, jcls, jcfg, _ = CASES[name]
    train = stack_client_data(xs, ys, batch_size=cfg["batch_size"])
    data = JData(client_num=len(xs), class_num=CLASSES, train=train,
                 test=train)
    mesh = (None if label == "single"
            else j_make_mesh(client_axis=d, devices=jax.devices()[:d]))
    wl = JWorkload(JLR(DIM, CLASSES), num_classes=CLASSES,
                   grad_clip_norm=None)
    j = jcls(wl, data, jcfg(**cfg), mesh=mesh)
    params = j.run(params=_J_INIT)
    return {"params": {f"Dense_0/{k}": np.asarray(v)
                       for k, v in params["Dense_0"].items()},
            "state": _jax_state(name, j),
            "epsilon": (j.accountant.epsilon() if algo == "dp_fedavg"
                        else None)}


@pytest.fixture(scope="module")
def runs():
    """Every rank's results at D = 2 and 4 (both spawned at once, from
    worker threads), and meanwhile the JAX package's runs and the port's
    single-process runs."""
    cases = {name: _case(name) for name in CASES}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as spawner:
        futs = {d: spawner.submit(
            spawn_ranks, jobs.algorithms_job, d,
            (d, cases, {k: _CLI + v + ["--mesh_clients", str(d)]
                        for k, v in CLI.items()} if d == CLI_WORLD else {}),
            "cpu", JOIN_S) for d in WORLDS}
        refs = {(name, label): _jax_run(name, label)
                for name in CASES if CASES[name][4] is not None
                for label in ("single", "mesh")}
        singles = {name: jobs.run_algo(case) for name, case in cases.items()}
        cli = {k: main(_CLI + v) for k, v in CLI.items()}
        return {d: f.result() for d, f in futs.items()}, refs, singles, cli


def _close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_round_matches_jax_and_one_process(runs, world, name):
    ranks, refs, singles = runs[0][world], runs[1], runs[2]
    assert len({r[name]["sha256"] for r in ranks}) == 1, \
        "the ranks' params differ"
    for r in ranks[1:]:                # every rank mirrors the same state
        _close(r[name]["state"], ranks[0][name]["state"], rtol=0, atol=0)
    got, single = ranks[0][name], singles[name]
    keys = sorted(single["params"])
    tol = CASES[name][6]
    _close([got["params"][k] for k in keys],
           [single["params"][k] for k in keys], **tol)
    _close(got["state"], single["state"], **tol)
    d = CASES[name][3]
    labels = () if d is None else ("single",) + (("mesh",) if d == world
                                                 else ())
    for label in labels:
        want = refs[name, label]
        _close([got["params"][k] for k in keys],
               [want["params"][k] for k in keys], rtol=RTOL, atol=ATOL)
        _close(got["state"], want["state"], rtol=RTOL, atol=ATOL)
    if CASES[name][0] == "dp_fedavg":
        assert got["dp_rounds"] == CASES[name][2]["comm_round"]
        assert got["epsilon"] == single["epsilon"]
        if d is not None:
            assert got["epsilon"] == refs[name, "single"]["epsilon"]


@pytest.mark.parametrize("algo", sorted(CLI))
def test_cli_stateful_mesh_equals_single_process(runs, algo):
    """``test_experiments.py:359``: ``--mesh_clients 4`` through the CLI on
    4 ranks reproduces the single-process CLI run (rtol 1e-5); the ranks'
    params byte-equal."""
    ranks, single = runs[0][CLI_WORLD], runs[3][algo]
    sharded = ranks[0][f"cli_{algo}"]
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(single[k], sharded[k], rtol=1e-5)
    hashes = sharded["rank_params_sha256"].split(",")
    assert len(hashes) == CLI_WORLD and len(set(hashes)) == 1
    assert all(r[f"cli_{algo}"]["params_sha256"] == hashes[0]
               for r in ranks)
