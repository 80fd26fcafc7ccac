"""The port's device-resident round and scanned rounds
(``parallel/cohort.py``: `make_device_round`, `make_scanned_rounds`;
``algorithms/fedavg.py``: the staging, `_run_scanned`) and its
`CentralizedTrainer`, against the port's own host loop and the JAX
package.

On the CPU the device round and the scanned rounds run the eager round
body; the CUDA graph that serves them on a card is held by
``chip_smoke.py``.  Tolerances: the device round, the scanned path and
the host loop of the port agree bit for bit (the same gather values, the
same training); the eval cadence and the round key schedule equal the JAX
package's exactly; full-batch, full-participation FedAvg equals
`CentralizedTrainer`, and that trainer equals the JAX one, within rtol
2e-4, atol 2e-5 (the JAX oracle's limits).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import CentralizedTrainer as JCentral
from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.data.stacking import batch_global as j_batch_global
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms import CentralizedTrainer, FedAvg, FedAvgConfig
from fedml_tpu_torch.algorithms import fedavg as fedavg_mod
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.stacking import (FederatedData, gather_cohort,
                                           stack_client_data, to_device)
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.parallel.cohort import (GraphedRounds,
                                             gather_live_cohort,
                                             make_cohort_step,
                                             make_device_round,
                                             make_scanned_rounds)
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
        ys.append(np.argmax(x @ W + 0.1 * rng.randn(n, classes),
                            axis=1).astype(np.int32))
        xs.append(x)
    return xs, ys


def _fed_data(n_clients=12, seed=3, batch_size=8):
    xs, ys = _synthetic_clients(n_clients=n_clients, seed=seed)
    train = stack_client_data(xs, ys, batch_size)
    return FederatedData(client_num=n_clients, class_num=4, train=train,
                         test=train)


def _lr():
    return ClassificationWorkload(LogisticRegression(12, 4), num_classes=4,
                                  grad_clip_norm=None)


def _bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


def _host_only(algo):
    algo._stage_train_on_device = lambda *a, **k: False
    return algo


@pytest.mark.parametrize("model", ["lr", "cnn"])
@pytest.mark.parametrize("client_axis", ["vmap", "scan"])
def test_device_round_equals_host_gather_round(model, client_axis):
    """One round from the resident split (gather by ids, live mask) ==
    the host gather's round, bit for bit, with padded slots."""
    if model == "lr":
        data = _fed_data()
        wl = _lr()
    else:
        data = load_data("femnist", num_clients=6, batch_size=20)
        wl = ClassificationWorkload(CNNOriginalFedAvg(only_digits=False),
                                    num_classes=62)
    local = make_local_trainer(wl, make_client_optimizer("sgd", 0.1), 1)
    params = wl.init(torch.Generator().manual_seed(1))
    m = 5
    ids = np.asarray(sample_clients(2, data.client_num, 4))
    padded, live = fedavg_mod.pad_ids(ids, m)
    resident = to_device(data.train, "cpu")
    got, _ = make_device_round(local, m, client_axis=client_axis)(
        params, resident, padded, live)
    cohort = gather_cohort(data.train, ids, pad_to=m, device="cpu")
    want, _ = make_cohort_step(local, client_axis=client_axis)(params, cohort)
    _bits(got, want)
    live_cohort = gather_live_cohort(resident, torch.as_tensor(padded),
                                     torch.as_tensor(live))
    for k in cohort:
        assert torch.equal(live_cohort[k], cohort[k]), k


def test_fedavg_device_path_equals_host_loop():
    data = _fed_data()
    cfg = FedAvgConfig(comm_round=4, client_num_per_round=5, batch_size=8,
                       lr=0.3, frequency_of_the_test=2, seed=1)
    fast_algo = FedAvg(_lr(), data, cfg, device="cpu")
    fast = fast_algo.run()
    assert fast_algo._train_dev is not None     # the device path ran
    slow_algo = _host_only(FedAvg(_lr(), data, cfg, device="cpu"))
    slow = slow_algo.run()
    assert slow_algo._train_dev is None
    _bits(fast, slow)
    assert [h["round"] for h in fast_algo.history] == [0, 2, 3]
    assert fast_algo.history[-1]["train_acc"] == \
        slow_algo.history[-1]["train_acc"]


@pytest.mark.parametrize("rpd", [2, 4, 7])
def test_scanned_rounds_equal_the_loop_and_jax_cadence(rpd):
    """rounds_per_dispatch > 1: the same params as the per-round loop, bit
    for bit (plain FedAvg draws no randomness), and the eval rounds of
    JAX's `_run_scanned` ([0, 16, 32] at 33 rounds, test every 16)."""
    data = _fed_data()
    kw = dict(comm_round=33, client_num_per_round=4, batch_size=8, lr=0.5,
              frequency_of_the_test=16, seed=5)
    loop = FedAvg(_lr(), data, FedAvgConfig(**kw), device="cpu")
    scan = FedAvg(_lr(), data, FedAvgConfig(rounds_per_dispatch=rpd, **kw),
                  device="cpu")
    _bits(scan.run(), loop.run())
    assert scan._scanned_rounds is not None and loop._scanned_rounds is None
    jwl = JWorkload(JLR(12, 4), num_classes=4, grad_clip_norm=None)
    jscan = JFedAvg(jwl, data, JFedAvgConfig(rounds_per_dispatch=rpd, **kw))
    jscan.run()
    rounds = [h["round"] for h in scan.history]
    assert rounds == [h["round"] for h in loop.history] \
        == [h["round"] for h in jscan.history] == [0, 16, 32]
    assert len(scan.round_times) == 33
    assert scan.history[-1]["train_acc"] == loop.history[-1]["train_acc"]


def test_scanned_rounds_feed_sample_clients_ids_and_the_jax_keys(
        monkeypatch):
    """Each absolute round gets ``sample_clients(round)``'s ids, and each
    round the words of ``fold_in(chunk key, k)`` on the JAX run's chain
    (one split for the init, one per chunk)."""
    captured = []
    real = fedavg_mod.make_scanned_rounds

    def spy(local_train, m, **kw):
        fn = real(local_train, m, **kw)

        def wrapped(params, stacked, ids, live, seed_words):
            captured.append((np.asarray(ids), np.asarray(live),
                             list(seed_words)))
            return fn(params, stacked, ids, live, seed_words)
        return wrapped

    monkeypatch.setattr(fedavg_mod, "make_scanned_rounds", spy)
    data = _fed_data()
    algo = FedAvg(_lr(), data, FedAvgConfig(
        comm_round=7, client_num_per_round=4, batch_size=8, lr=0.3,
        frequency_of_the_test=3, seed=5, rounds_per_dispatch=3),
        device="cpu")
    algo.run()
    assert [len(ids) for ids, _, _ in captured] == [1, 3, 3]
    flat_ids = np.concatenate([ids for ids, _, _ in captured])
    for r in range(7):
        np.testing.assert_array_equal(flat_ids[r],
                                      sample_clients(r, 12, 4))
    assert np.all(np.concatenate([lv for _, lv, _ in captured]) == 1.0)
    rng = jax.random.key(5)
    rng, _ = jax.random.split(rng)
    for _, _, words in captured:
        rng, chunk = jax.random.split(rng)
        want = []
        for k in range(len(words)):
            kd = np.asarray(jax.random.key_data(
                jax.random.fold_in(chunk, k))).astype(np.uint32)
            want.append(tuple(int(v) for v in kd.view(np.int32)[:2]))
        assert words == want


def test_fullbatch_scanned_fedavg_equals_centralized():
    """Full batch + E=1 + full participation: scanned FedAvg == the port's
    CentralizedTrainer == the JAX package's (rtol 2e-4, atol 2e-5), and
    accuracy to 3 decimals."""
    xs, ys = _synthetic_clients()
    train = stack_client_data(xs, ys, batch_size=32)
    data = FederatedData(client_num=8, class_num=4, train=train, test=train)
    jwl = JWorkload(JLR(12, 4), num_classes=4, grad_clip_norm=None)
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: v[0, 0], {k: train[k] for k in ("x", "y", "mask")}))
    tp0 = params_from_numpy(jax.tree.map(np.asarray, p0))
    cfg = FedAvgConfig(comm_round=3, client_num_per_round=8, batch_size=32,
                       lr=0.5, frequency_of_the_test=100,
                       rounds_per_dispatch=3)
    fed = FedAvg(_lr(), data, cfg, device="cpu")
    got = fed.run(params={k: v.clone() for k, v in tp0.items()})
    pooled = j_batch_global(np.concatenate(xs), np.concatenate(ys),
                            batch_size=sum(len(x) for x in xs))
    central = CentralizedTrainer(_lr(), lr=0.5)
    mine = central.train_rounds(tp0, pooled, rounds=3)
    want = JCentral(jwl, lr=0.5).train_rounds(p0, pooled, rounds=3)
    for a, b, c in zip(jax.tree.leaves(params_to_numpy(got)),
                       jax.tree.leaves(params_to_numpy(mine)),
                       jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b, np.asarray(c), rtol=2e-4, atol=2e-5)
    cen = central.metrics(mine, pooled)
    assert abs(fed.evaluate_global(got)["train_acc"] - cen["acc"]) < 1e-3


def test_over_budget_takes_the_host_gather(monkeypatch, caplog):
    data = _fed_data()
    cfg = FedAvgConfig(comm_round=3, client_num_per_round=4, batch_size=8,
                       lr=0.3, frequency_of_the_test=100,
                       rounds_per_dispatch=2)
    want = FedAvg(_lr(), data, cfg, device="cpu").run()
    monkeypatch.setenv("FEDML_TPU_DEVICE_DATA_BYTES", "1024")
    algo = FedAvg(_lr(), data, cfg, device="cpu")
    with caplog.at_level(logging.INFO):
        got = algo.run()
    assert algo._train_dev is None and algo._scanned_rounds is None
    assert "host gather" in caplog.text
    _bits(got, want)


def test_test_split_stays_resident_when_it_fits(monkeypatch):
    data = _fed_data()
    xs, ys = _synthetic_clients(n_clients=12, seed=9)
    data.test = stack_client_data(xs, ys, 8)
    train_b = fedavg_mod.split_nbytes(data.train)
    cfg = FedAvgConfig(comm_round=2, client_num_per_round=4, batch_size=8,
                       frequency_of_the_test=1)
    algo = FedAvg(_lr(), data, cfg, device="cpu")
    algo.run()
    assert algo._test_dev is not None
    monkeypatch.setenv("FEDML_TPU_DEVICE_DATA_BYTES", str(train_b))
    algo = FedAvg(_lr(), data, cfg, device="cpu")
    algo.run()
    assert algo._train_dev is not None and algo._test_dev is None


def test_graphed_rounds_refuse_data_off_the_card():
    """A graphed round is captured only over a split resident on a CUDA
    device; CPU data raises instead of running eagerly."""
    data = _fed_data()
    with pytest.raises(ValueError, match="resident split is on cpu"):
        GraphedRounds(None, to_device(data.train, "cpu"), 4)


def test_scanned_rounds_on_cpu_are_the_eager_loop():
    data = _fed_data()
    wl = _lr()
    local = make_local_trainer(wl, make_client_optimizer("sgd", 0.2), 1)
    params = wl.init(torch.Generator().manual_seed(3))
    resident = to_device(data.train, "cpu")
    ids = np.stack([fedavg_mod.pad_ids(sample_clients(r, 12, 4), 4)[0]
                    for r in range(3)])
    live = np.ones((3, 4), np.float32)
    got, _ = make_scanned_rounds(local, 4, max_rounds=3)(
        params, resident, ids, live)
    round_fn = make_device_round(local, 4)
    want = params
    for r in range(3):
        want, _ = round_fn(want, resident, ids[r], live[r])
    _bits(got, want)


def test_cli_rounds_per_dispatch(capsys):
    out = main(["--algo", "fedavg", "--model", "cnn_fedavg", "--dataset",
                "femnist", "--client_num_in_total", "8",
                "--client_num_per_round", "4", "--batch_size", "20",
                "--rounds_per_dispatch", "4", "--comm_round", "5",
                "--frequency_of_the_test", "4", "--platform", "cpu",
                "--log_stdout", "false"])
    assert out["params_finite"] and out["round"] == 4
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        main(["--rounds_per_dispatch", "0", "--platform", "cpu"])
