"""The backdoor attack's poisoning and evaluation against the JAX package,
and ``--backdoor`` on the ``fedavg_robust`` runner.

* ``poison_stacked_clients`` / ``poison_federated_data`` (the
  ``RandomState(seed).choice`` draws, the trigger, the relabel) and
  ``make_targeted_test_set``: bit for bit, for several seeds, fractions
  and attacker sets.
* ``targeted_accuracy`` and ``evaluate_backdoor``: equal to JAX's on a
  backdoored global JAX trained (12x12 images, one attacker), carried
  across.
* The runner: ``backdoor_data`` equal to the JAX runner's steps
  (``experiments/main.py:491-513``) bit for bit; ``--backdoor
  --attacker_num 1 --defense weak_dp --defense_backend cuda`` on
  ``--platform cpu`` reports ``backdoor_acc`` and writes the summary line
  to ``--completion_signal``; a non-image dataset is refused as in JAX.
"""

import json

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import backdoor as jbd
from fedml_tpu.algorithms.fedavg import FedAvg as JFedAvg
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JFedAvgConfig
from fedml_tpu.data.stacking import FederatedData as JData
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms import backdoor as bd
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.stacking import FederatedData, stack_client_data
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.experiments.main import backdoor_data, main
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy

H = W = 12
CLASSES = 4
TARGET = 3
TRIGGER_VALUE = 3.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the suite runs files side by side, and torch's
    CPU convs and GroupNorm slow by tens of times when their thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JMLP(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        x = x.reshape((x.shape[0], -1))
        return nn.Dense(CLASSES)(nn.relu(nn.Dense(32)(x)))


class _MLP(torch.nn.Module):
    """``_JMLP`` under flax's names: the outer Dense is built first, so
    it is ``Dense_0``."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(32, CLASSES)
        self.Dense_1 = Dense(H * W, 32)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.Dense_0(torch.relu(self.Dense_1(x)))


def _image_clients(n_clients=6, per_client=20, seed=0):
    rng = np.random.RandomState(seed)
    bases = rng.rand(CLASSES, H, W, 1).astype(np.float32)
    xs, ys = [], []
    for _ in range(n_clients):
        m = rng.randint(per_client // 2, per_client + 1)
        y = rng.randint(0, CLASSES, m).astype(np.int32)
        x = bases[y] + 0.3 * rng.randn(m, H, W, 1).astype(np.float32)
        xs.append(x.astype(np.float32))
        ys.append(y)
    return xs, ys


def _bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("attackers,frac,seed", [([0], 1.0, 0),
                                                 ([1, 3], 0.5, 7),
                                                 ([2], 0.3, 11),
                                                 ([0, 5], 0.0, 2)])
def test_poisoning_bit_equal(attackers, frac, seed):
    xs, ys = _image_clients()
    train = stack_client_data(xs, ys, batch_size=8)
    got = bd.poison_stacked_clients(train, attackers, TARGET, frac,
                                    trigger_size=3, value=TRIGGER_VALUE,
                                    seed=seed)
    want = jbd.poison_stacked_clients(train, attackers, TARGET, frac,
                                      trigger_size=3, value=TRIGGER_VALUE,
                                      seed=seed)
    _bit_equal(got, want)
    data = FederatedData(client_num=len(xs), class_num=CLASSES, train=train,
                         test=train)
    pd = bd.poison_federated_data(data, attackers, TARGET, frac, seed=seed)
    jpd = jbd.poison_federated_data(
        JData(client_num=len(xs), class_num=CLASSES, train=train,
              test=train), attackers, TARGET, frac, seed=seed)
    _bit_equal(pd.train, jpd.train)
    assert pd.test is data.test


@pytest.mark.parametrize("exclude", [True, False])
def test_targeted_set_bit_equal(exclude):
    xs, ys = _image_clients(seed=3)
    x, y = np.concatenate(xs), np.concatenate(ys)
    _bit_equal(bd.make_targeted_test_set(x, y, TARGET, 4, TRIGGER_VALUE,
                                         exclude),
               jbd.make_targeted_test_set(x, y, TARGET, 4, TRIGGER_VALUE,
                                          exclude))


def test_targeted_accuracy_and_report_equal_jax():
    """A global JAX trains on the poisoned clients (undefended, so the
    backdoor takes), carried across: the port's targeted accuracy, on
    batches of 256 and of 7, and the raw task equal JAX's."""
    xs, ys = _image_clients(n_clients=5, per_client=24)
    train = stack_client_data(xs, ys, batch_size=8)
    poisoned = jbd.poison_stacked_clients(train, [0], TARGET, 1.0,
                                          value=TRIGGER_VALUE, seed=0)
    jwl = JWorkload(_JMLP(), num_classes=CLASSES, grad_clip_norm=None)
    algo = JFedAvg(jwl, JData(client_num=5, class_num=CLASSES,
                              train=poisoned, test=train),
                   JFedAvgConfig(comm_round=4, client_num_per_round=5,
                                 epochs=3, batch_size=8, lr=0.4,
                                 frequency_of_the_test=100, seed=1))
    jparams = algo.run()
    targeted = jbd.make_targeted_test_set(
        np.concatenate(xs[1:]), np.concatenate(ys[1:]), TARGET,
        value=TRIGGER_VALUE)
    wl = ClassificationWorkload(_MLP(), num_classes=CLASSES,
                                grad_clip_norm=None)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    for bs in (256, 7):
        got = bd.targeted_accuracy(wl, params, targeted, batch_size=bs)
        assert got == jbd.targeted_accuracy(jwl, jparams, targeted,
                                            batch_size=bs)
    assert 0.0 < got < 1.0
    clean = {k: train[k][2] for k in ("x", "y", "mask")}
    for c in (clean, {k: v[0] for k, v in clean.items()}):
        assert bd.evaluate_backdoor(wl, params, targeted, c) == \
            jbd.evaluate_backdoor(jwl, jparams, targeted, c)
    assert bd.evaluate_backdoor(wl, params, targeted) == {
        "backdoor_acc": got}


ARGV = ["--algo", "fedavg_robust", "--model", "cnn_fedavg", "--dataset",
        "femnist", "--client_num_in_total", "8", "--client_num_per_round",
        "4", "--batch_size", "20", "--comm_round", "2", "--backdoor",
        "true", "--attacker_num", "1", "--defense", "weak_dp",
        "--defense_backend", "cuda", "--log_stdout", "false"]


def _jax_backdoor_steps(cfg, data):
    """The JAX runner's ``--backdoor`` steps (``experiments/main.py:491-
    513``) on the same host data."""
    attackers = list(range(min(cfg.attacker_num, data.client_num)))
    eval_src = data.test if data.test is not None else data.train
    honest = np.arange(len(attackers), data.client_num)
    x_eval = np.asarray(eval_src["x"])[honest]
    y_eval = np.asarray(eval_src["y"])[honest]
    m_eval = np.asarray(eval_src["mask"])[honest].reshape(-1) > 0
    x_eval = x_eval.reshape((-1,) + x_eval.shape[3:])[m_eval]
    y_eval = y_eval.reshape(-1)[m_eval]
    targeted = jbd.make_targeted_test_set(
        x_eval, y_eval, cfg.target_label, trigger_size=cfg.trigger_size)
    poisoned = jbd.poison_federated_data(
        JData(client_num=data.client_num, class_num=data.class_num,
              train=data.train, test=data.test), attackers,
        cfg.target_label, cfg.poison_frac, cfg.trigger_size, seed=cfg.seed)
    return poisoned, targeted


def test_backdoor_data_equals_the_jax_runners():
    cfg = config_from_argv(ARGV + ["--attacker_num", "2", "--seed", "4"])
    data = load_data("femnist", num_clients=8, batch_size=20, seed=4)
    got, targeted = backdoor_data(cfg, data)
    want, jtargeted = _jax_backdoor_steps(cfg, data)
    _bit_equal(got.train, want.train)
    _bit_equal(targeted, jtargeted)
    assert not np.array_equal(got.train["y"][:2], data.train["y"][:2])
    assert np.array_equal(got.train["y"][2:], data.train["y"][2:])


def test_backdoor_runner_and_completion_signal(tmp_path):
    sig = tmp_path / "done"
    out = main(ARGV + ["--platform", "cpu", "--completion_signal",
                       str(sig)])
    assert 0.0 <= out["backdoor_acc"] <= 1.0 and out["params_finite"]
    line = json.loads(sig.read_text())
    assert line["backdoor_acc"] == out["backdoor_acc"]
    assert line["algo"] == "fedavg_robust" and line["round"] == 1


def test_backdoor_needs_image_data_as_in_jax():
    with pytest.raises(ValueError, match="image-shaped data"):
        main(["--algo", "fedavg_robust", "--model", "lr", "--dataset",
              "synthetic", "--client_num_in_total", "4", "--backdoor",
              "true", "--comm_round", "1", "--platform", "cpu",
              "--log_stdout", "false"])
