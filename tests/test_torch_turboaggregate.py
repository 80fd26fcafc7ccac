"""The port's TurboAggregate (``fedml_tpu_torch/algorithms/turboaggregate.py``)
against the JAX package's, from carried weights, one seed and one
``privacy_key``; the port runs on the CPU, where its ``cuda`` backend takes
the kernel's plain version, and JAX's ``pallas`` backend runs the kernel in
interpret mode.

* Real local SGD: one round agrees within clients_per_group / scale (each
  client's quantized value can flip by one quantum) + 1e-5 (the local-SGD
  tolerance of ``tests/test_torch_local_sgd.py``).
* Injected trained updates, computed bit-identically in both packages from
  each client's data: the group means, and the round's result, are
  bit-equal, with and without a dropped (LCC-recovered) group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.turboaggregate import TurboAggregate as JTurbo
from fedml_tpu.algorithms.turboaggregate import (
    TurboAggregateConfig as JTurboConfig)
from fedml_tpu.data import registry as j_registry
from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms import TurboAggregate, TurboAggregateConfig
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.secure import fused_mask
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

JAX_BACKEND = {"cuda": "pallas", "torch": "xla"}
LOCAL_SGD_TOL = 1e-5


def _lr_setup(num_clients=12):
    kw = dict(num_clients=num_clients, batch_size=10, seed=0)
    return (load_data("mnist_learnable_twin", **kw),
            j_registry.load_data("mnist_learnable_twin", **kw),
            ClassificationWorkload(LogisticRegression(784, 10),
                                   num_classes=10),
            JWorkload(JLR(784, 10), num_classes=10))


def _pair(backend, setup, **cfg):
    t_data, j_data, twl, jwl = setup
    common = dict(comm_round=1, group_num=2, clients_per_group=4,
                  drop_tolerance=1, lr=0.1, seed=3, privacy_key=99, **cfg)
    j_algo = JTurbo(jwl, j_data, JTurboConfig(
        secagg_backend=JAX_BACKEND[backend], **common))
    algo = TurboAggregate(twl, t_data, TurboAggregateConfig(
        secagg_backend=backend, **common), device="cpu")
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: jnp.asarray(v[0, 0]),
        {k: j_data.train[k] for k in ("x", "y", "mask")}))
    return algo, j_algo, p0, params_from_numpy(jax.tree.map(np.asarray, p0))


def _max_diff(got, want):
    return max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()),
        params_to_numpy(got), want)))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_one_round_lr_matches_jax(backend):
    algo, j_algo, p0, tp0 = _pair(backend, _lr_setup())
    assert algo.quant_scale == j_algo.quant_scale == 2.0**14
    want = j_algo.train_round(p0, 0)
    got = algo.train_round(tp0, 0)
    tol = algo.cfg.clients_per_group / algo.quant_scale + LOCAL_SGD_TOL
    assert _max_diff(got, want) <= tol
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 1e-3


def test_one_round_cnn_matches_jax():
    """cnn_fedavg on a small femnist twin, the cuda backend (conv sums in
    another order: the local-SGD tolerance is 5e-5 here, as in
    ``tests/test_torch_fedavg.py``'s CNN round)."""
    kw = dict(num_clients=8, samples_per_client=8, batch_size=4, seed=1)
    setup = (load_data("femnist", **kw), j_registry.load_data("femnist", **kw),
             ClassificationWorkload(CNNOriginalFedAvg(only_digits=False),
                                    num_classes=62),
             JWorkload(JCNN(only_digits=False), num_classes=62))
    fused_mask.reset_launch_counts()
    algo, j_algo, p0, tp0 = _pair("cuda", setup)
    want = j_algo.train_round(p0, 0)
    got = algo.train_round(tp0, 0)
    assert _max_diff(got, want) <= algo.cfg.clients_per_group \
        / algo.quant_scale + 5e-5
    assert fused_mask.launch_counts["secagg_mask"] == 0   # CPU: plain


def _inject(algo, j_algo):
    """Replace local SGD in both packages by one update computed the same
    way from each client's data: p * 0.5 + 0.01 * (its live samples).
    Returns the lists the group means are recorded into."""
    def port_local(params, data):
        m = torch.sum(data["mask"])
        return {k: v * 0.5 + 0.01 * m for k, v in params.items()}, {}

    def jax_local(params, batches, rngs):
        m = jnp.sum(batches["mask"], axis=(1, 2))
        return jax.tree.map(
            lambda v: v[None] * jnp.float32(0.5)
            + (jnp.float32(0.01) * m).reshape((-1,) + (1,) * v.ndim),
            params), {}

    algo._local_train = port_local
    j_algo._local = jax_local
    j_algo._masked_group_sum = jax.jit(j_algo._masked_group_sum_impl)
    means, j_means = [], []
    group_sum, j_group_sum = algo.masked_group_sum, j_algo._masked_group_sum

    def record(*a):
        out = group_sum(*a)
        means.append(params_to_numpy(out[0]))
        return out

    def j_record(*a):
        out = j_group_sum(*a)
        j_means.append(jax.tree.map(np.asarray, out[0]))
        return out

    algo.masked_group_sum, j_algo._masked_group_sum = record, j_record
    return means, j_means


@pytest.mark.parametrize("dropped", [None, [1]])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_injected_updates_bit_equal(backend, dropped):
    algo, j_algo, p0, tp0 = _pair(backend, _lr_setup())
    means, j_means = _inject(algo, j_algo)
    want = j_algo.train_round(p0, 0, dropped_groups=dropped)
    got = algo.train_round(tp0, 0, dropped_groups=dropped)
    assert len(means) == len(j_means) == 2
    for m, jm in zip(means, j_means):
        jax.tree.map(np.testing.assert_array_equal, m, jm)
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(got),
                 jax.tree.map(np.asarray, want))


def test_dropout_recovery_matches_direct():
    """Port twin of ``tests/test_secure.py``'s recovery test: a group
    decoded from its surviving LCC shares lands within 1e-3 of the direct
    round (quantization through the field costs at most ~1/scale; a group
    mean already on the ring's fixed-point grid comes back exactly)."""
    t_data, _, twl, _ = _lr_setup(num_clients=8)
    algo = TurboAggregate(twl, t_data, TurboAggregateConfig(
        comm_round=1, group_num=2, clients_per_group=4, drop_tolerance=1,
        lr=0.1, seed=0, secagg_backend="cuda"), device="cpu")
    params = algo.init_params()
    direct = algo.train_round(params, 0)
    decoded = []
    recover = algo._lcc_recover
    algo._lcc_recover = lambda *a: decoded.append(a[1:]) or recover(*a)
    recovered = algo.train_round(params, 0, dropped_groups=[1])
    assert decoded == [(0, 1)]
    err = max(float((direct[k] - recovered[k]).abs().max()) for k in direct)
    assert err < 1e-3
    moved = max(float((direct[k] - params[k]).abs().max()) for k in direct)
    assert moved > 0
    with pytest.raises(ValueError, match="tolerance"):
        algo.train_round(params, 0, dropped_groups=[0, 1])
    small = TurboAggregate(twl, t_data, dataclasses.replace(
        algo.cfg, clients_per_group=3), device="cpu")
    with pytest.raises(ValueError, match="cannot tolerate"):
        small.train_round(params, 0, dropped_groups=[0])


def test_group_keys_follow_jax_chain():
    t_data, j_data, twl, jwl = _lr_setup(num_clients=8)
    algo = TurboAggregate(twl, t_data, TurboAggregateConfig(
        group_num=3, seed=5), device="cpu")
    for r in (0, 4):
        rk = jax.random.fold_in(jax.random.key(5), r)
        for g, k in enumerate(algo.group_keys(r)):
            np.testing.assert_array_equal(
                np.array(k, np.uint32),
                np.asarray(jax.random.key_data(jax.random.fold_in(rk, g))))


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = main(["--algo", "turboaggregate", "--model", "lr", "--dataset",
                "mnist", "--client_num_in_total", "8",
                "--client_num_per_round", "4", "--group_num", "2",
                "--comm_round", "2", "--batch_size", "4", "--secagg_backend",
                "cuda", "--platform", "cpu", "--run_dir", str(tmp_path),
                "--log_stdout", "false"])
    assert out["params_finite"] is True and out["rounds_per_s"] > 0
    assert out["round"] == 1 and 0.0 <= out["train_acc"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()
    assert '"rounds_per_s"' in capsys.readouterr().out


@pytest.mark.parametrize("name,twin", [("xla", "torch"), ("pallas", "cuda")])
def test_cli_refuses_jax_backend_names(name, twin):
    with pytest.raises(ValueError, match=f"twin of it is '{twin}'"):
        main(["--algo", "turboaggregate", "--model", "lr", "--dataset",
              "mnist", "--client_num_in_total", "8", "--client_num_per_round",
              "4", "--comm_round", "1", "--secagg_backend", name,
              "--platform", "cpu", "--log_stdout", "false"])
