"""The centralized trainer and the ``centralized`` runner against the JAX
package.

* ``train_rounds`` from carried weights equals JAX's
  ``CentralizedTrainer.train_rounds`` on the mnist twin after 3 rounds
  within ``ROUND_TOL`` (the earlier slices' round limit).
* The per-round keys equal JAX's ``split`` chain word for word, and a
  keyed trainer (``--model cnn``, dropout) gets each step's key of the
  JAX local trainer's chain from them; training with the keys differs
  from training without them.
* The runner logs JAX's keys (``train_*``, ``test_*``, ``round``) at JAX's
  cadence, and its metrics of the same weights equal JAX's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.centralized import (
    CentralizedTrainer as JCentralizedTrainer)
from fedml_tpu.experiments.config import ExperimentConfig as JConfig
from fedml_tpu.models import LogisticRegression as JLogisticRegression
from fedml_tpu.trainer.workload import (
    ClassificationWorkload as JClassificationWorkload)
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import LogisticRegression
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

j_main = importlib.import_module("fedml_tpu.experiments.main")

ROUND_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: many small ops, on which torch's thread pool
    spins when the workers of a parallel test run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Sink:
    def __init__(self):
        self.rows = []

    def log(self, row, step=None):
        self.rows.append((step, dict(row)))


def test_train_rounds_match_jax_from_carried_weights():
    data = load_data("mnist", num_clients=6, batch_size=8, seed=1)
    jwl = JClassificationWorkload(JLogisticRegression(784, 10), 10)
    twl = ClassificationWorkload(LogisticRegression(784, 10), 10)
    train = data.train_global
    p0 = jwl.init(jax.random.key(2), {"x": jnp.zeros((1, 784))})
    want = JCentralizedTrainer(jwl, lr=0.1).train_rounds(
        p0, jax.tree.map(jnp.asarray, dict(train)), 3, jax.random.key(9))
    got = CentralizedTrainer(twl, lr=0.1).train_rounds(
        params_from_numpy(jax.tree.map(np.asarray, p0)), train, 3,
        prng.key(9))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=ROUND_TOL, rtol=0), params_to_numpy(got),
        want)
    assert np.abs(np.asarray(want["Dense_0"]["kernel"])
                  - np.asarray(p0["Dense_0"]["kernel"])).max() > 1e-3


def _cnn_setup():
    data = load_data("femnist", num_clients=3, batch_size=8, seed=0)
    wl = create_workload("cnn", "femnist", 62, (28, 28, 1))
    assert wl.stochastic
    return data, wl


def test_round_keys_follow_jax_chain_word_for_word():
    data, wl = _cnn_setup()
    trainer = CentralizedTrainer(wl, lr=0.1)
    rng = jax.random.key(5)
    want = []
    for _ in range(3):
        rng, r = jax.random.split(rng)
        want.append(r)
    assert [tuple(int(w) for w in k) for k in trainer.round_keys(
        prng.key(5), 3)] == [tuple(int(w) for w in jax.random.key_data(k))
                             for k in want]
    # the step keys the trainer gets: the JAX local trainer's
    # ``rng, dropout_rng = split(rng)`` from each round's key
    seen = []
    real = trainer.local_train

    def spy(params, batches, *rng_steps):
        seen.append(rng_steps[0].clone())
        return real(params, batches, *rng_steps)

    spy.rng_inputs = real.rng_inputs
    trainer.local_train = spy
    trainer.train_rounds(wl.init(torch.Generator().manual_seed(0)),
                         data.train_global, 3, prng.key(5))
    steps = data.train_global["mask"].shape[0]
    for got, r in zip(seen, want):
        chain, drop = r, []
        for _ in range(steps):
            chain, d = jax.random.split(chain)
            drop.append(np.asarray(jax.random.key_data(d)))
        np.testing.assert_array_equal(got.numpy(), np.stack(drop))


def test_training_with_keys_differs_from_training_without():
    """Before the repair the trainer took no key: the CNN trained with
    its dropout off.  With the keys its masks run."""
    data, wl = _cnn_setup()
    p0 = wl.init(torch.Generator().manual_seed(0))
    keyed = CentralizedTrainer(wl, lr=0.1)
    with_keys = keyed.train_rounds(p0, data.train_global, 2, prng.key(0))
    again = CentralizedTrainer(wl, lr=0.1).train_rounds(
        p0, data.train_global, 2, prng.key(0))
    plain = CentralizedTrainer(wl, lr=0.1)
    plain.local_train.rng_inputs = None       # the trainer before the repair
    without = plain.train_rounds(p0, data.train_global, 2, prng.key(0))
    assert all(torch.equal(with_keys[k], again[k]) for k in p0)
    assert max(float((with_keys[k] - without[k]).abs().max())
               for k in p0) > 1e-4


@pytest.mark.parametrize("rounds,freq", [(3, 2), (4, 1)])
def test_runner_logs_like_jax(rounds, freq):
    args = dict(algo="centralized", model="lr", dataset="mnist",
                client_num_in_total=6, batch_size=8, lr=0.1,
                comm_round=rounds, frequency_of_the_test=freq,
                log_stdout=False)
    jcfg = JConfig(**args, platform="cpu")
    jdata = j_main.load_experiment_data(jcfg)
    jsink = _Sink()
    want = j_main.run_centralized(jcfg, jdata, None, jsink)
    tcfg = t_main.ExperimentConfig(**args, platform="cpu")
    t_main.check_config(tcfg)
    tsink = _Sink()
    got = t_main.run_centralized(tcfg, t_main.load_experiment_data(tcfg),
                                 tsink)
    assert [s for s, _ in tsink.rows] == [s for s, _ in jsink.rows]
    assert [sorted(r) for _, r in tsink.rows] == \
        [sorted(r) for _, r in jsink.rows]
    assert [r["round"] for _, r in tsink.rows] == \
        [r["round"] for _, r in jsink.rows]
    assert {k: v for k, v in got.items()
            if k not in ("rounds_per_s", "params_finite")}.keys() \
        == want.keys()
    assert got["params_finite"] and got["rounds_per_s"] > 0
    # the two runners draw different inits; on the same weights their
    # metrics agree
    jwl = j_main._make_workload(jcfg, jdata)
    p0 = jwl.init(jax.random.key(0), {"x": jnp.zeros((1, 784))})
    jt = JCentralizedTrainer(jwl, lr=0.1)
    tt = CentralizedTrainer(t_main._make_workload(
        tcfg, t_main.load_experiment_data(tcfg)), lr=0.1)
    m_want = jt.metrics(p0, jdata.train_global)
    m_got = tt.metrics(params_from_numpy(jax.tree.map(np.asarray, p0)),
                       jdata.train_global)
    assert m_got.keys() == m_want.keys()
    for k in m_want:
        assert abs(m_got[k] - m_want[k]) <= 1e-5, k


def test_cli_runs_centralized_cnn_on_cpu(tmp_path):
    out = t_main.main(["--algo", "centralized", "--model", "cnn",
                       "--dataset", "femnist", "--client_num_in_total", "4",
                       "--batch_size", "8", "--comm_round", "2",
                       "--platform", "cpu", "--log_stdout", "false",
                       "--run_dir", str(tmp_path)])
    assert out["round"] == 1 and out["params_finite"]
    assert 0.0 <= out["test_acc"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()
