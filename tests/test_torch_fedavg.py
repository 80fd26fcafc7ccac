"""The port's FedAvg and FedAvg-Robust against the JAX package.

Port twins of ``tests/test_fedavg_oracle.py`` (full-batch FedAvg ==
centralized, cohort == sequential clients, scan == vmap, chunked eval ==
one sweep, padded clients are no-ops), and whole runs from a shared init
and one ``seed``: the port's round seed words follow the JAX package's
threefry key chain (the ``key_data`` of each round's key), so the fused
defense's noise stream is the same on both sides.  Tolerances are stated per test; they cover f32
sums taken in another order and a few ulps of log/cos in the noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import CentralizedTrainer
from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.algorithms import FedAvgRobust as JRobust
from fedml_tpu.algorithms import FedAvgRobustConfig as JRobustConfig
from fedml_tpu.data import registry as j_registry
from fedml_tpu.data.stacking import batch_global as j_batch_global
from fedml_tpu.data.stacking import stack_client_data as j_stack
from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms import (FedAvg, FedAvgConfig, FedAvgRobust,
                                        FedAvgRobustConfig)
from fedml_tpu_torch.algorithms.fedavg import round_seed_words
from fedml_tpu_torch.core import fused_agg
from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.stacking import (FederatedData, gather_cohort,
                                           stack_client_data)
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.parallel.cohort import make_cohort_step
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              make_client_optimizer)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


def _synthetic_clients(n_clients=8, dim=12, classes=4, seed=0, min_n=6,
                       max_n=20):
    rng = np.random.RandomState(seed)
    W = rng.randn(dim, classes)
    xs, ys = [], []
    for _ in range(n_clients):
        n = rng.randint(min_n, max_n + 1)
        x = rng.randn(n, dim).astype(np.float32)
        y = np.argmax(x @ W + 0.1 * rng.randn(n, classes),
                      axis=1).astype(np.int32)
        xs.append(x)
        ys.append(y)
    return xs, ys


def _lr_pair(dim=12, classes=4, clip=None):
    return (JWorkload(JLR(dim, classes), num_classes=classes,
                      grad_clip_norm=clip),
            ClassificationWorkload(LogisticRegression(dim, classes),
                                   num_classes=classes, grad_clip_norm=clip))


def _shared_init(jwl, data):
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: v[0, 0], {k: data.train[k] for k in ("x", "y", "mask")}))
    return p0, params_from_numpy(jax.tree.map(np.asarray, p0))


def _jax_round_words(key, rounds):
    """The seed words JAX's FedAvg.run hands each round's fused aggregate."""
    words = []
    for _ in range(rounds):
        key, round_key = jax.random.split(key)
        data = np.asarray(jax.random.key_data(round_key)).astype(np.uint32)
        words.append(tuple(int(v) for v in data.view(np.int32)[:2]))
    return words


@pytest.mark.parametrize("drew_init", [False, True])
@pytest.mark.parametrize("seed", [0, 4, 9, 12345, 2**31 - 1])
def test_round_seed_words_follow_jax_chain(seed, drew_init):
    """The port's round seed words == the words JAX's FedAvg.run hands its
    fused aggregate: key(seed), one split for the init when the run draws
    its own weights, then one split per round."""
    key = jax.random.key(seed)
    if drew_init:
        key, _ = jax.random.split(key)
    want = _jax_round_words(key, 4)
    assert [round_seed_words(seed, r, drew_init) for r in range(4)] == want


def _close(got, want, atol, rtol=0.0):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=atol, rtol=rtol), params_to_numpy(got), want)


def test_fullbatch_fedavg_equals_centralized():
    """Full batch + E=1 + full participation: three port FedAvg rounds ==
    three pooled-gradient steps of the JAX package's CentralizedTrainer
    (rtol 2e-4, atol 2e-5, as the JAX oracle), accuracy to 3 decimals."""
    xs, ys = _synthetic_clients()
    train = stack_client_data(xs, ys, batch_size=32)
    data = FederatedData(client_num=8, class_num=4, train=train, test=train)
    jwl, twl = _lr_pair()
    p0, tp0 = _shared_init(jwl, data)
    cfg = FedAvgConfig(comm_round=3, client_num_per_round=8, batch_size=32,
                       lr=0.5, frequency_of_the_test=100)
    fed = FedAvg(twl, data, cfg, device="cpu")
    got = fed.run(params=tp0)

    central = CentralizedTrainer(jwl, lr=0.5)
    pooled = j_batch_global(np.concatenate(xs), np.concatenate(ys),
                            batch_size=sum(len(x) for x in xs))
    want = central.train_rounds(p0, pooled, rounds=3)
    _close(got, want, atol=2e-5, rtol=2e-4)
    cen = central.metrics(want, {k: pooled[k] for k in ("x", "y", "mask")})
    assert abs(fed.evaluate_global(got)["train_acc"] - cen["acc"]) < 1e-3


def test_cohort_equals_sequential_clients():
    """One vmapped cohort step == each client trained alone, then the
    weighted mean (1e-5)."""
    xs, ys = _synthetic_clients(n_clients=4)
    train = stack_client_data(xs, ys, batch_size=5)
    _, twl = _lr_pair()
    local = make_local_trainer(twl, make_client_optimizer("sgd", 0.1), 2)
    params = twl.init(torch.Generator().manual_seed(0))
    cohort = {k: torch.tensor(v) for k, v in train.items()}
    agg, _ = make_cohort_step(local)(params, cohort)
    rows = [local(params, {k: cohort[k][c] for k in ("x", "y", "mask")})[0]
            for c in range(4)]
    want = tree_weighted_mean(rows, cohort["num_samples"])
    for k in want:
        torch.testing.assert_close(agg[k], want[k], atol=1e-5, rtol=1e-4)


def test_fedavg_scan_equals_vmap():
    """Whole FedAvg runs with either client axis agree to 1e-6."""
    data = load_data("mnist", num_clients=9, batch_size=4, seed=2)
    _, twl = _lr_pair(dim=784, classes=10, clip=1.0)
    runs = {}
    for axis in ("vmap", "scan"):
        cfg = FedAvgConfig(comm_round=2, client_num_per_round=4, batch_size=4,
                           lr=0.1, frequency_of_the_test=100,
                           client_axis=axis)
        runs[axis] = FedAvg(twl, data, cfg, device="cpu").run()
    for k in runs["vmap"]:
        torch.testing.assert_close(runs["vmap"][k], runs["scan"][k],
                                   atol=1e-6, rtol=0)


def test_chunked_global_eval_equals_full_sweep():
    """eval_chunk_clients=2 (zero-padded tail chunk) == one sweep, and both
    equal the JAX package's evaluate_global (1e-5)."""
    xs, ys = _synthetic_clients(n_clients=7)
    train = stack_client_data(xs, ys, batch_size=5)
    data = FederatedData(client_num=7, class_num=4, train=train)
    jwl, twl = _lr_pair()
    p0, tp0 = _shared_init(jwl, data)
    base = FedAvgConfig(comm_round=1, client_num_per_round=3, batch_size=5)
    full = FedAvg(twl, data, dataclasses.replace(base, eval_chunk_clients=0),
                  device="cpu").evaluate_global(tp0)
    chunked = FedAvg(twl, data, dataclasses.replace(base,
                                                    eval_chunk_clients=2),
                     device="cpu").evaluate_global(tp0)
    j_data = j_registry.FederatedData(client_num=7, class_num=4,
                                      train=j_stack(xs, ys, batch_size=5))
    want = JFedAvg(jwl, j_data, JFedAvgConfig(
        comm_round=1, client_num_per_round=3, batch_size=5)
    ).evaluate_global(p0)
    assert full.keys() == chunked.keys() == want.keys() and full
    for k in full:
        np.testing.assert_allclose(chunked[k], full[k], rtol=1e-6)
        np.testing.assert_allclose(full[k], want[k], rtol=1e-5)


def test_padded_dummy_clients_are_noops():
    xs, ys = _synthetic_clients(n_clients=5)
    train = stack_client_data(xs, ys, batch_size=5)
    _, twl = _lr_pair()
    step = make_cohort_step(make_local_trainer(
        twl, make_client_optimizer("sgd", 0.1), 1))
    params = twl.init(torch.Generator().manual_seed(0))
    exact, _ = step(params, gather_cohort(train, [1, 3]))
    padded, _ = step(params, gather_cohort(train, [1, 3], pad_to=4))
    for k in exact:
        torch.testing.assert_close(exact[k], padded[k], atol=1e-6, rtol=0)


def _robust_pair(defense, j_data, t_data, jwl, twl, rounds, per_round, lr,
                 seed):
    """JAX (pallas backend, interpreter) and port (cuda backend, plain on
    the CPU) runs of FedAvgRobust from one init and one seed: each package
    derives its own round seed words."""
    common = dict(comm_round=rounds, client_num_per_round=per_round,
                  batch_size=int(t_data.train["x"].shape[2]), lr=lr,
                  frequency_of_the_test=1000, defense=defense,
                  norm_bound=0.5, stddev=0.01, seed=seed)
    j_algo = JRobust(jwl, j_data, JRobustConfig(defense_backend="pallas",
                                                **common))
    p0, tp0 = _shared_init(jwl, j_data)
    want = j_algo.run(params=jax.tree.map(jnp.copy, p0))
    algo = FedAvgRobust(twl, t_data, FedAvgRobustConfig(
        defense_backend="cuda", **common), device="cpu")
    got = algo.run(params=tp0)
    return got, want, algo, j_algo, p0


@pytest.mark.parametrize("defense", ["none", "norm_diff_clipping", "weak_dp"])
def test_robust_three_rounds_lr_matches_jax(defense):
    """3 rounds on the mnist learnable twin with LR: the port's fused
    backend == the JAX package's Pallas backend (2e-5), and the final
    evaluation rows agree (1e-4)."""
    kw = dict(num_clients=12, batch_size=10, seed=0)
    t_data = load_data("mnist_learnable_twin", **kw)
    j_data = j_registry.load_data("mnist_learnable_twin", **kw)
    jwl, twl = _lr_pair(dim=784, classes=10, clip=1.0)
    got, want, algo, j_algo, p0 = _robust_pair(
        defense, j_data, t_data, jwl, twl, rounds=3, per_round=5, lr=0.1,
        seed=4)
    _close(got, want, atol=2e-5)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 1e-3
    for k, v in j_algo.history[-1].items():
        if k != "round_s":
            np.testing.assert_allclose(algo.history[-1][k], v, rtol=1e-4,
                                       atol=1e-4)


def test_robust_one_round_cnn_matches_jax():
    """One weak-DP round of cnn_fedavg on a small femnist twin, fused
    backend against Pallas (5e-5: conv sums and the noise's log/cos)."""
    kw = dict(num_clients=6, samples_per_client=8, batch_size=4, seed=1)
    t_data = load_data("femnist", **kw)
    j_data = j_registry.load_data("femnist", **kw)
    jwl = JWorkload(JCNN(only_digits=False), num_classes=62,
                    grad_clip_norm=1.0)
    twl = ClassificationWorkload(CNNOriginalFedAvg(only_digits=False),
                                 num_classes=62, grad_clip_norm=1.0)
    fused_agg.reset_launch_counts()
    got, want, _, _, _ = _robust_pair(
        "weak_dp", j_data, t_data, jwl, twl, rounds=1, per_round=3, lr=0.1,
        seed=9)
    _close(got, want, atol=5e-5)
    assert fused_agg.launch_counts["robust_agg"] == 0   # CPU: plain version


def test_torch_backend_defends_like_fused():
    """The unfused torch backend clips like the fused one (sigma = 0:
    1e-5) and noises with the requested scale (weak DP moves the result)."""
    data = load_data("mnist_learnable_twin", num_clients=8, batch_size=10)
    _, twl = _lr_pair(dim=784, classes=10, clip=1.0)
    base = dict(comm_round=2, client_num_per_round=4, batch_size=10, lr=0.1,
                frequency_of_the_test=1000, norm_bound=0.3, stddev=0.05)
    p0 = twl.init(torch.Generator().manual_seed(0))
    runs = {}
    for backend in ("torch", "cuda"):
        for defense in ("norm_diff_clipping", "weak_dp"):
            algo = FedAvgRobust(twl, data, FedAvgRobustConfig(
                defense=defense, defense_backend=backend, **base),
                device="cpu")
            runs[backend, defense] = algo.run(params=dict(p0))
    for k in p0:
        torch.testing.assert_close(runs["torch", "norm_diff_clipping"][k],
                                   runs["cuda", "norm_diff_clipping"][k],
                                   atol=1e-5, rtol=0)
    noise = runs["torch", "weak_dp"]["Dense_0/kernel"] \
        - runs["torch", "norm_diff_clipping"]["Dense_0/kernel"]
    assert 0.005 < float(noise.std()) < 0.1


def test_refusals_are_named():
    data = load_data("mnist", num_clients=4, batch_size=4)
    _, twl = _lr_pair(dim=784, classes=10)
    with pytest.raises(ValueError, match="defense_backend"):
        FedAvgRobust(twl, data, FedAvgRobustConfig(defense_backend="pallas"),
                     device="cpu")
    with pytest.raises(ValueError, match="own aggregate"):
        FedAvgRobust(twl, data, FedAvgRobustConfig(
            defense="krum", defense_backend="cuda"), device="cpu")
    # a mesh of 2 CPU ranks needs --host_device_count 2, as JAX's mesh
    # needs 2 devices
    with pytest.raises(ValueError, match="from 1 devices"):
        main(["--mesh_clients", "2", "--platform", "cpu"])
    with pytest.raises(KeyError, match="item 12"):
        main(["--algo", "fednas", "--platform", "cpu"])


def test_gpu_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    data = load_data("mnist", num_clients=4, batch_size=4)
    _, twl = _lr_pair(dim=784, classes=10)
    with pytest.raises(RuntimeError, match="platform cpu"):
        FedAvg(twl, data, FedAvgConfig())


def test_cli_runs_on_cpu(tmp_path, capsys):
    """The CLI on the CPU: fedavg_robust with the fused backend writes its
    metrics stream and prints a summary with the round rate."""
    out = main(["--algo", "fedavg_robust", "--model", "cnn_fedavg",
                "--dataset", "femnist", "--defense", "weak_dp",
                "--defense_backend", "cuda", "--client_num_in_total", "6",
                "--client_num_per_round", "3", "--batch_size", "20",
                "--lr", "0.1", "--comm_round", "2", "--platform", "cpu",
                "--run_dir", str(tmp_path), "--log_stdout", "false"])
    assert out["params_finite"] is True and out["rounds_per_s"] > 0
    assert out["round"] == 1 and 0.0 <= out["test_acc"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()
    assert (tmp_path / "summary.json").exists()
    assert '"rounds_per_s"' in capsys.readouterr().out
