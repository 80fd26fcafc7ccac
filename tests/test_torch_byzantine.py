"""The port's Byzantine rules (``fedml_tpu_torch/core/byzantine.py``) and
FedAvg-Robust's Byzantine branch against the JAX package.

Inputs are numpy-seeded stacks with weight-0 (padded) slots holding
large garbage.  Tolerances: the coordinate median and the trimmed mean
within 1e-6 (sorts are exact; the trimmed sum runs in another order);
Krum and multi-Krum select the same slots exactly and agree within 1e-6;
the geometric median within 1e-5 (eight Weiszfeld steps of f32 matvecs in
another order); two defended FedAvg rounds on a small LR within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import FedAvgRobust as JRobust
from fedml_tpu.algorithms import FedAvgRobustConfig as JRobustConfig
from fedml_tpu.core import byzantine as jb
from fedml_tpu.data.stacking import stack_client_data as j_stack
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms import FedAvgRobust, FedAvgRobustConfig
from fedml_tpu_torch.core import byzantine as tb
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import LogisticRegression
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

TOL = {"coordinate_median": 1e-6, "trimmed_mean": 1e-6, "krum": 1e-6,
       "multi_krum": 1e-6, "geometric_median": 1e-5}


def _stack(n, pad, seed):
    """A nested stack of ``n`` live clients and ``pad`` weight-0 slots of
    garbage, and its weights."""
    rng = np.random.RandomState(seed)
    tree = {"a": {"kernel": rng.randn(n + pad, 3, 2).astype(np.float32)},
            "b": rng.randn(n + pad, 7).astype(np.float32),
            "c": {"bias": rng.randn(n + pad, 4).astype(np.float32)}}
    for leaf in jax.tree.leaves(tree):
        leaf[n:] = 1e4 * rng.randn(*leaf[n:].shape)
    w = np.concatenate([rng.rand(n).astype(np.float32) + 0.5,
                        np.zeros(pad, np.float32)])
    return tree, w


def _port(tree):
    return params_from_numpy(tree)


def _j_agg(method, **kw):
    return jb.make_byzantine_aggregate(method, **kw)


def _t_agg(method, **kw):
    return tb.make_byzantine_aggregate(method, **kw)


@pytest.mark.parametrize("method", tb.METHODS)
@pytest.mark.parametrize("n,pad,seed", [(5, 0, 0), (5, 3, 1), (8, 2, 2),
                                        (4, 1, 3)])
def test_rule_matches_jax_with_padded_slots(method, n, pad, seed):
    kw = dict(trim_frac=0.2, byz_f=1, krum_m=2)
    tree, w = _stack(n, pad, seed)
    want = _j_agg(method, **kw)(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(w))
    got = _t_agg(method, **kw)(_port(tree), torch.tensor(w))
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=TOL[method])


@pytest.mark.parametrize("f,m", [(0, 1), (1, 1), (1, 2), (2, 3), (0, 4)])
def test_krum_selects_the_same_clients_as_jax(f, m):
    for seed in range(4):
        tree, w = _stack(8, 2, 10 + seed)
        want = np.asarray(jb.krum_weights(jax.tree.map(jnp.asarray, tree),
                                          jnp.asarray(w), f, m))
        got = tb.krum_weights(_port(tree), torch.tensor(w), f, m).numpy()
        assert list(np.flatnonzero(got)) == list(np.flatnonzero(want))
        assert len(np.flatnonzero(got)) == m
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_krum_breaks_ties_by_slot_index():
    """Identical clients tie on every score; the stable argsort picks the
    lowest slots, as JAX's does."""
    base = np.random.RandomState(5).randn(1, 6).astype(np.float32)
    tree = {"w": np.repeat(base, 6, axis=0)}
    w = np.ones(6, np.float32)
    want = np.asarray(jb.krum_weights({"w": jnp.asarray(tree["w"])},
                                      jnp.asarray(w), 1, 2))
    got = tb.krum_weights(_port(tree), torch.tensor(w), 1, 2).numpy()
    assert list(np.flatnonzero(got)) == list(np.flatnonzero(want)) == [0, 1]


@pytest.mark.parametrize("method", tb.METHODS)
def test_padding_changes_nothing(method):
    """Weight-0 slots never change the result, whatever they hold (the
    twin of tests/test_padding_invariance.py's property)."""
    agg = _t_agg(method, trim_frac=0.2, byz_f=1, krum_m=2)
    for trial in range(3):
        rng = np.random.RandomState(40 + trial)
        n, pad = 5, trial + 1
        tree = {"a": rng.randn(n, 3, 2).astype(np.float32),
                "b": rng.randn(n, 4).astype(np.float32)}
        w = rng.rand(n).astype(np.float32) + 0.5
        base = agg(_port(tree), torch.tensor(w))
        garbage = {k: np.concatenate([v, 1e4 * rng.randn(
            pad, *v.shape[1:]).astype(np.float32)]) for k, v in tree.items()}
        got = agg(_port(garbage),
                  torch.tensor(np.concatenate([w, np.zeros(pad, np.float32)])))
        for k in base:
            torch.testing.assert_close(got[k], base[k], rtol=2e-4, atol=1e-5)


def test_geometric_median_all_zero_weights_matches_jax():
    tree = {"w": np.random.RandomState(6).randn(5, 6).astype(np.float32)}
    want = np.asarray(jb.geometric_median({"w": jnp.asarray(tree["w"])},
                                          jnp.zeros(5))["w"])
    got = tb.geometric_median(_port(tree), torch.zeros(5))["w"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    solo = tb.geometric_median(_port(tree), torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 1.0]))["w"].numpy()
    np.testing.assert_allclose(solo, tree["w"][4], atol=1e-3)


@pytest.mark.parametrize("kwargs,match", [
    (dict(method="median-ish"), "unknown byzantine"),
    (dict(method="trimmed_mean", trim_frac=0.5), "trim_frac"),
    (dict(method="trimmed_mean", trim_frac=-0.1), "trim_frac"),
    (dict(method="multi_krum", krum_m=0), "krum_m"),
    (dict(method="krum", byz_f=-1), "byz_f"),
    (dict(method="geometric_median", gm_iters=0), "gm_iters"),
    (dict(method="geometric_median", gm_eps=0.0), "gm_eps"),
])
def test_validation_messages_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as jexc:
        jb.make_byzantine_aggregate(**kwargs)
    with pytest.raises(ValueError, match=match) as texc:
        tb.make_byzantine_aggregate(**kwargs)
    assert str(texc.value) == str(jexc.value)


def _lr_data():
    rng = np.random.RandomState(0)
    W = rng.randn(12, 4)
    xs, ys = [], []
    for _ in range(8):
        n = rng.randint(6, 21)
        x = rng.randn(n, 12).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ W, axis=1).astype(np.int32))
    train = j_stack(xs, ys, batch_size=8)
    return FederatedData(client_num=8, class_num=4, train=train, test=train)


@pytest.mark.parametrize("defense", tb.METHODS)
def test_defended_rounds_match_jax(defense):
    """Two FedAvg-Robust rounds with a Byzantine rule, from one init: the
    port on the CPU against the JAX package (1e-5)."""
    data = _lr_data()
    jwl = JWorkload(JLR(12, 4), num_classes=4, grad_clip_norm=None)
    twl = ClassificationWorkload(LogisticRegression(12, 4), num_classes=4,
                                 grad_clip_norm=None)
    kw = dict(defense=defense, comm_round=2, client_num_per_round=6,
              batch_size=8, lr=0.3, frequency_of_the_test=100, byz_f=1,
              krum_m=2, trim_frac=0.2)
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: v[0, 0], {k: data.train[k] for k in ("x", "y", "mask")}))
    want = JRobust(jwl, data, JRobustConfig(**kw)).run(params=p0)
    got = FedAvgRobust(twl, data, FedAvgRobustConfig(**kw),
                       device="cpu").run(
        params=params_from_numpy(jax.tree.map(np.asarray, p0)))
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_robust_byzantine_checks(caplog):
    data = load_data("mnist", num_clients=8, batch_size=8)
    twl = ClassificationWorkload(LogisticRegression(784, 10),
                                 num_classes=10)
    with pytest.raises(ValueError, match="own aggregate"):
        FedAvgRobust(twl, data, FedAvgRobustConfig(
            defense="trimmed_mean", defense_backend="cuda"), device="cpu")
    with pytest.raises(ValueError, match="m <= n - f - 2"):
        FedAvgRobust(twl, data, FedAvgRobustConfig(
            defense="multi_krum", client_num_per_round=8, byz_f=2,
            krum_m=8), device="cpu")
    with caplog.at_level("WARNING"):
        FedAvgRobust(twl, data, FedAvgRobustConfig(
            defense="krum", client_num_per_round=4, byz_f=1), device="cpu")
    assert "n >= 2f + 3" in caplog.text


def test_cli_byzantine_defense():
    out = main(["--algo", "fedavg_robust", "--defense", "krum",
                "--byz_f", "1", "--model", "lr", "--dataset", "mnist",
                "--client_num_in_total", "8", "--client_num_per_round", "5",
                "--comm_round", "2", "--batch_size", "8", "--platform",
                "cpu", "--log_stdout", "false"])
    assert np.isfinite(out["train_loss"]) and out["params_finite"]
