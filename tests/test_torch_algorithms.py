"""The port's stateful cohort algorithms against the JAX package.

One parametrised case per algorithm (FedOpt, FedProx, FedNova, SCAFFOLD,
FedDyn, Ditto, FedAC, DP-FedAvg): the same synthetic clients, the same
init carried across, two rounds with half the clients a round, each
algorithm's global held to its JAX class at ``atol=1e-5`` (f32 sums in
another order; DP's Gaussian is within one ulp of ``jax.random.normal``).
The per-client state (SCAFFOLD's variates, FedDyn's corrections, Ditto's
personal models, FedAC's x sequence, FedNova's server momentum) is held
at the same limit, and DP-FedAvg's ε bit for bit.  FedOpt's six update
rules are held to optax on the same gradients (1e-6 relative).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.ditto import Ditto as JDitto
from fedml_tpu.algorithms.ditto import DittoConfig as JDittoConfig
from fedml_tpu.algorithms.dp_fedavg import DPFedAvg as JDP
from fedml_tpu.algorithms.dp_fedavg import DPFedAvgConfig as JDPConfig
from fedml_tpu.algorithms.fedac import FedAC as JFedAC
from fedml_tpu.algorithms.fedac import FedACConfig as JFedACConfig
from fedml_tpu.algorithms.fedac import fedac_coupling as j_coupling
from fedml_tpu.algorithms.feddyn import FedDyn as JFedDyn
from fedml_tpu.algorithms.feddyn import FedDynConfig as JFedDynConfig
from fedml_tpu.algorithms.fednova import FedNova as JFedNova
from fedml_tpu.algorithms.fednova import FedNovaConfig as JFedNovaConfig
from fedml_tpu.algorithms.fedopt import SERVER_OPTIMIZERS as J_SERVER_OPTS
from fedml_tpu.algorithms.fedopt import FedOpt as JFedOpt
from fedml_tpu.algorithms.fedopt import FedOptConfig as JFedOptConfig
from fedml_tpu.algorithms.fedprox import FedProx as JFedProx
from fedml_tpu.algorithms.fedprox import FedProxConfig as JFedProxConfig
from fedml_tpu.algorithms.scaffold import Scaffold as JScaffold
from fedml_tpu.algorithms.scaffold import ScaffoldConfig as JScaffoldConfig
from fedml_tpu.data import registry as j_registry
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms.ditto import Ditto, DittoConfig
from fedml_tpu_torch.algorithms.dp_fedavg import DPFedAvg, DPFedAvgConfig
from fedml_tpu_torch.algorithms.fedac import FedAC, FedACConfig, fedac_coupling
from fedml_tpu_torch.algorithms.feddyn import FedDyn, FedDynConfig
from fedml_tpu_torch.algorithms.fednova import FedNova, FedNovaConfig
from fedml_tpu_torch.algorithms.fedopt import (SERVER_OPTIMIZERS, FedOpt,
                                               FedOptConfig)
from fedml_tpu_torch.algorithms.fedprox import FedProx, FedProxConfig
from fedml_tpu_torch.algorithms.scaffold import Scaffold, ScaffoldConfig
from fedml_tpu_torch.data.stacking import FederatedData, stack_client_data
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import LogisticRegression
from fedml_tpu_torch.server_opt import ServerOptMismatchError
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

ATOL = 1e-5
DIM, CLASSES, N_CLIENTS = 12, 4, 8


def _data():
    rng = np.random.RandomState(0)
    W = rng.randn(DIM, CLASSES)
    xs, ys = [], []
    for _ in range(N_CLIENTS):
        n = rng.randint(6, 21)
        x = rng.randn(n, DIM).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ W + 0.1 * rng.randn(n, CLASSES),
                            axis=1).astype(np.int32))
    train = stack_client_data(xs, ys, batch_size=5)
    return (FederatedData(client_num=N_CLIENTS, class_num=CLASSES,
                          train=train, test=train),
            j_registry.FederatedData(client_num=N_CLIENTS, class_num=CLASSES,
                                     train=train, test=train))


def _workloads():
    return (JWorkload(JLR(DIM, CLASSES), num_classes=CLASSES,
                      grad_clip_norm=1.0),
            ClassificationWorkload(LogisticRegression(DIM, CLASSES),
                                   num_classes=CLASSES, grad_clip_norm=1.0))


COMMON = dict(comm_round=2, client_num_per_round=4, batch_size=5, lr=0.3,
              frequency_of_the_test=1, seed=3)

# name -> (JAX class, JAX config, port class, port config, extra kwargs)
ALGOS = {
    "fedopt": (JFedOpt, JFedOptConfig, FedOpt, FedOptConfig,
               dict(server_optimizer="adam", server_lr=0.05)),
    "fedprox": (JFedProx, JFedProxConfig, FedProx, FedProxConfig,
                dict(mu=0.3)),
    "fednova": (JFedNova, JFedNovaConfig, FedNova, FedNovaConfig,
                dict(momentum=0.9, mu=0.1, gmf=0.5, wd=0.001)),
    "scaffold": (JScaffold, JScaffoldConfig, Scaffold, ScaffoldConfig, {}),
    "feddyn": (JFedDyn, JFedDynConfig, FedDyn, FedDynConfig,
               dict(feddyn_alpha=0.1)),
    "ditto": (JDitto, JDittoConfig, Ditto, DittoConfig,
              dict(ditto_lambda=0.2, personal_epochs=2)),
    "fedac": (JFedAC, JFedACConfig, FedAC, FedACConfig,
              dict(fedac_mu=0.5)),
    "dp_fedavg": (JDP, JDPConfig, DPFedAvg, DPFedAvgConfig,
                  dict(dp_clip=0.5, dp_noise_multiplier=1.0)),
}


def _state(name, algo, jax_side):
    """The algorithm's per-client or server state as a list of arrays."""
    def arrs(tree):
        return [np.asarray(v) for v in jax.tree.leaves(tree)] if jax_side \
            else [np.asarray(tree[k]) if isinstance(tree[k], np.ndarray)
                  else tree[k].numpy() for k in sorted(
                      tree, key=lambda k: k.split("/"))]
    if name == "scaffold":
        return arrs(algo.c_global) + arrs(algo.c_locals)
    if name == "feddyn":
        return arrs(algo.h_state) + arrs(algo.lam_locals)
    if name == "ditto":
        return arrs(algo.v_locals)
    if name == "fedac":
        return arrs(algo._x_state)
    if name == "fednova":
        return arrs(algo._gmf_buf)
    return []


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_algorithm_matches_jax_after_two_rounds(name):
    jcls, jcfg, tcls, tcfg, extra = ALGOS[name]
    t_data, j_data = _data()
    jwl, twl = _workloads()
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: v[0, 0], {k: t_data.train[k] for k in ("x", "y", "mask")}))
    tp0 = params_from_numpy(jax.tree.map(np.asarray, p0))
    j_algo = jcls(jwl, j_data, jcfg(**COMMON, **extra))
    want = j_algo.run(params=p0)
    t_algo = tcls(twl, t_data, tcfg(**COMMON, **extra), device="cpu")
    got = t_algo.run(params=tp0)
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)
    for a, b in zip(_state(name, t_algo, False), _state(name, j_algo, True)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert len(t_algo.history) == len(j_algo.history) == 2
    for row_t, row_j in zip(t_algo.history, j_algo.history):
        for k, v in row_j.items():
            if k == "round_s":
                continue
            if k == "dp_epsilon":
                assert row_t[k] == v      # the accountant, bit for bit
            else:
                assert abs(row_t[k] - v) < 1e-4, (k, row_t[k], v)


@pytest.mark.parametrize("opt", sorted(SERVER_OPTIMIZERS))
def test_fedopt_update_rules_match_optax(opt):
    """Three steps of each server optimizer on the same pseudo-gradients:
    the port's tensor rules against optax (1e-6 relative)."""
    rng = np.random.RandomState(1)
    w = {"a": rng.randn(5, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    jopt = J_SERVER_OPTS[opt](0.1, 0.9)
    init, update = SERVER_OPTIMIZERS[opt](0.1, 0.9)
    jw, jstate = w, jopt.init(w)
    tw = {k: torch.tensor(v) for k, v in w.items()}
    tstate = init(tw)
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in w.items()}
        upd, jstate = jopt.update(g, jstate, jw)
        jw = optax.apply_updates(jw, upd)
        tupd, tstate = update({k: torch.tensor(v) for k, v in g.items()},
                              tstate, tw)
        tw = {k: tw[k] + tupd[k] for k in tw}
    for k in w:
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]),
                                   rtol=1e-6, atol=1e-7)


def test_fedac_coupling_matches_jax():
    for lr, mu, k in ((0.1, 0.5, 10), (0.3, 2.0, 1), (0.05, 0.01, 100)):
        assert fedac_coupling(lr, mu, k) == j_coupling(lr, mu, k)


def test_fedopt_checkpoint_resume_and_tag_refusal(tmp_path):
    """Two rounds, resumed to four, equal four straight (bit for bit), and
    a snapshot of another server optimizer is refused by name."""
    t_data, _ = _data()
    _, twl = _workloads()
    cfg = dict(COMMON, comm_round=4, server_optimizer="adam",
               server_lr=0.05)
    straight = FedOpt(twl, t_data, FedOptConfig(**cfg), device="cpu").run()
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
    FedOpt(twl, t_data, FedOptConfig(**dict(cfg, comm_round=2)),
           device="cpu").run(checkpointer=ck)
    resumed = FedOpt(twl, t_data, FedOptConfig(**cfg),
                     device="cpu").run(checkpointer=ck)
    for k in straight:
        assert torch.equal(straight[k], resumed[k])
    other = FedOpt(twl, t_data, FedOptConfig(**dict(
        cfg, server_optimizer="yogi")), device="cpu")
    with pytest.raises(ServerOptMismatchError, match="server-optimizer tag"):
        other.run(checkpointer=ck)


def test_scaffold_checkpoint_resume_is_bit_identical(tmp_path):
    t_data, _ = _data()
    _, twl = _workloads()
    cfg = dict(COMMON, comm_round=3)
    straight = Scaffold(twl, t_data, ScaffoldConfig(**cfg),
                        device="cpu").run()
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
    Scaffold(twl, t_data, ScaffoldConfig(**dict(cfg, comm_round=2)),
             device="cpu").run(checkpointer=ck)
    resumed = Scaffold(twl, t_data, ScaffoldConfig(**cfg),
                       device="cpu").run(checkpointer=ck)
    for k in straight:
        assert torch.equal(straight[k], resumed[k])


def test_scanned_path_is_refused_with_a_server_update():
    """FedOpt asks for K rounds a call; the loop runs them one by one (the
    server step is per-round host state), equal to K = 1."""
    t_data, _ = _data()
    _, twl = _workloads()
    runs = []
    for k in (1, 4):
        algo = FedOpt(twl, t_data, FedOptConfig(
            **dict(COMMON, comm_round=3, rounds_per_dispatch=k,
                   frequency_of_the_test=10)), device="cpu")
        runs.append(algo.run())
        assert algo._scanned_rounds is None
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_cli_runner_runs_on_cpu(algo, tmp_path):
    out = main(["--algo", algo, "--model", "lr", "--dataset", "mnist",
                "--client_num_in_total", "6", "--client_num_per_round", "3",
                "--batch_size", "10", "--comm_round", "2", "--platform",
                "cpu", "--log_stdout", "false", "--run_dir",
                str(tmp_path)])
    assert out["params_finite"] and out["round"] == 1
    if algo == "dp_fedavg":
        assert out["dp_epsilon"] > 0
    if algo == "ditto":
        assert "personal_train_acc" in out


def test_unported_models_name_their_roadmap_item():
    """EfficientNet and VGG are ported (they ride the dropout seam, which
    every runner keys, so no algorithm refuses them, as none refuses
    CNNDropOut); a name neither package has is refused with the port's
    list; the transformer's dropout rides the seam."""
    from fedml_tpu_torch.experiments.config import config_from_argv
    from fedml_tpu_torch.experiments.main import check_config
    from fedml_tpu_torch.models.transformer import TransformerLM
    with pytest.raises(KeyError, match="unknown model"):
        main(["--model", "resnet_gkt", "--dataset", "femnist", "--platform",
              "cpu", "--client_num_in_total", "4", "--comm_round", "1"])
    check_config(config_from_argv([
        "--algo", "ditto", "--model", "efficientnet", "--dataset", "femnist",
        "--platform", "cpu", "--client_num_in_total", "4",
        "--comm_round", "1"]))
    assert TransformerLM(vocab_size=8, dropout_rate=0.1).stochastic


def test_fedac_local_form_collapses_to_fedavg_and_server_fedac():
    """At (alpha=1, beta=1, gamma=lr) FedAC's local form is plain local
    SGD, so its run equals FedAvg's; the server-opt fedac at the same
    knobs is the plain SGD step on the pseudo-gradient (the seam's own
    test), so the two forms meet at FedAvg (1e-6)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.server_opt import ServerOptimizer
    t_data, _ = _data()
    _, twl = _workloads()
    init = twl.init(torch.Generator().manual_seed(3))
    fedac = FedAC(twl, t_data, FedACConfig(**COMMON, fedac_alpha=1.0,
                                           fedac_beta=1.0), device="cpu")
    fedavg = FedAvg(twl, t_data, FedAvgConfig(**COMMON), device="cpu")
    a = fedac.run(params=dict(init))
    b = fedavg.run(params=dict(init))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)
    # one server-opt fedac step at lr = 1 from the global to FedAvg's
    # finalized mean lands on that mean
    srv = ServerOptimizer("fedac", init, lr=1.0)
    stepped = srv.apply(init, b)
    for k in b:
        torch.testing.assert_close(stepped[k], b[k], rtol=0, atol=1e-6)
