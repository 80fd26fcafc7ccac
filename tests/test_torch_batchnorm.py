"""BatchNorm (``Norm(kind="batch")``) and stateful workloads against the
JAX package.

* ``Norm("batch")`` in train mode equals flax's ``nn.BatchNorm`` (output
  and new running statistics, padded zero rows counted in the batch's
  statistics, as flax counts them) within ``NORM_TOL``; eval mode
  normalises with the running statistics.
* The stateful local trainer on ``CifarResNet(layers=(1, 1, 1),
  norm="batch")`` at 8x8 equals JAX's ``make_local_trainer`` after 2
  steps and a fully padded batch, weights and running statistics, within
  ``STEP_TOL``; two FedAvg rounds within ``ROUND_TOL``, the earlier
  slices' round limit.
* The defended mean (fused backend, K1's plain version on the CPU) equals
  JAX's fused path in interpret mode within ``ROUND_TOL``; it clips the
  weight leaves only (the statistics come out as the plain weighted
  mean).
* A stateful run resumes from its checkpoint bit for bit; the manifest's
  crc is JAX's ``tree_crc`` over the variables tree.
* SCAFFOLD, FedDyn, Ditto, FedAC and the wave engine's scaffold refuse a
  stateful workload with the JAX classes' messages; the wave engine's
  sgd carries the statistics through its fold."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.algorithms.fedavg_robust import FedAvgRobust as JRobust
from fedml_tpu.algorithms.fedavg_robust import (
    FedAvgRobustConfig as JRobustConfig)
from fedml_tpu.data.synthetic import (
    synthetic_federated_dataset as j_synthetic)
from fedml_tpu.models.norms import Norm as JNorm
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local_trainer
from fedml_tpu.trainer.workload import (
    ClassificationWorkload as JClassificationWorkload)
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu.utils.journal import tree_crc as j_tree_crc
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobust,
                                                      FedAvgRobustConfig)
from fedml_tpu_torch.core.fused_agg import make_fused_robust_aggregate
from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
from fedml_tpu_torch.models.norms import Norm, batch_stats_collector
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              make_client_optimizer)
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer, manifest_path
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

NORM_TOL = 1e-5
STEP_TOL = 1e-5
ROUND_TOL = 1e-4
SIDE = 8


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=atol, rtol=0), got, want)


@pytest.mark.parametrize("padded", [0, 3])
def test_batch_norm_matches_flax(padded):
    rng = np.random.RandomState(padded)
    x = (3.0 + 2.0 * rng.randn(8, 5, 5, 6)).astype(np.float32)
    x[len(x) - padded:] = 0.0                       # padded rows
    jn = JNorm("batch")
    variables = {
        "params": {"BatchNorm_0": {
            "scale": (1 + 0.1 * rng.randn(6)).astype(np.float32),
            "bias": (0.1 * rng.randn(6)).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": (0.5 * rng.randn(6)).astype(np.float32),
            "var": (1 + np.abs(rng.randn(6))).astype(np.float32)}}}
    want, new = jn.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    want_eval = jn.apply(variables, jnp.asarray(x), train=False)
    norm = Norm(6, "batch")
    bn = norm.BatchNorm_0
    with torch.no_grad():
        for k, v in {**variables["params"]["BatchNorm_0"],
                     **variables["batch_stats"]["BatchNorm_0"]}.items():
            getattr(bn, k).copy_(torch.tensor(v))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad(), batch_stats_collector() as stats:
        got = norm(xt).permute(0, 2, 3, 1).numpy()
    with torch.no_grad():
        got_eval = norm(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=NORM_TOL, rtol=0)
    np.testing.assert_allclose(got_eval, np.asarray(want_eval),
                               atol=NORM_TOL, rtol=0)
    mean, var = stats[bn]
    j_stats = new["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(mean.numpy(), j_stats["mean"], atol=NORM_TOL)
    np.testing.assert_allclose(var.numpy(), j_stats["var"], atol=NORM_TOL)
    # the buffers themselves are not written
    np.testing.assert_array_equal(
        bn.mean.numpy(), variables["batch_stats"]["BatchNorm_0"]["mean"])


def random_variables(jm, x, rng):
    """flax's tree for ``jm`` (its shapes from ``jax.eval_shape``) filled
    from ``rng``: kernels N(0, 1 / fan_in), scales and variances
    1 + |0.1 N|, biases and means 0.1 N."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x))

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.randn(*s.shape).astype(np.float32)
        if "kernel" in name:
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if "scale" in name or "'var'" in name:
            return 1 + 0.1 * np.abs(z)
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def resnet():
    """The BatchNorm ResNet pair, flax's variables and their flat form."""
    jm = JCifarResNet(layers=(1, 1, 1), num_classes=10, norm="batch")
    variables = random_variables(jm, jnp.zeros((1, SIDE, SIDE, 3)),
                                 np.random.RandomState(0))
    jwl = JClassificationWorkload(jm, 10, stateful=True)
    twl = ClassificationWorkload(
        CifarResNet(layers=(1, 1, 1), num_classes=10, norm="batch"), 10,
        stateful=True)
    return jwl, twl, variables, params_from_numpy(variables)


def _twins(**kw):
    kw = dict(num_clients=4, samples_per_client=8, sample_shape=(SIDE, SIDE,
                                                                 3),
              class_num=10, batch_size=4, seed=3, **kw)
    return j_synthetic(**kw), synthetic_federated_dataset(**kw)


def test_stateful_tree_layout(resnet):
    jwl, twl, variables, tp = resnet
    mine = twl.init(torch.Generator().manual_seed(0))
    assert list(mine) == list(tp) and list(tp)[0].startswith("batch_stats/")
    assert all(mine[k].shape == tp[k].shape for k in mine)
    assert all(float(v.abs().sum()) == 0 for k, v in mine.items()
               if k.endswith("/mean"))
    assert all(bool((v == 1).all()) for k, v in mine.items()
               if k.endswith("/var"))
    with pytest.raises(ValueError, match="stateful"):
        ClassificationWorkload(CifarResNet(layers=(1, 1, 1), norm="batch"),
                               10)
    with pytest.raises(ValueError, match="stateful"):
        ClassificationWorkload(CifarResNet(layers=(1, 1, 1)), 10,
                               stateful=True)


def test_stateful_local_trainer_matches_jax(resnet):
    """E=1 over 3 batches of 4 (one row padded, one batch fully padded),
    SGD lr 0.1, clip 1: weights and running statistics."""
    jwl, twl, variables, tp = resnet
    rng = np.random.RandomState(4)
    data = {"x": rng.randn(3, 4, SIDE, SIDE, 3).astype(np.float32),
            "y": rng.randint(0, 10, (3, 4)).astype(np.int32),
            "mask": np.array([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]],
                             np.float32)}
    want, _ = jax.jit(j_local_trainer(jwl, j_opt("sgd", 0.1), 1))(
        variables, jax.tree.map(jnp.asarray, data), jax.random.key(0))
    got, _ = make_local_trainer(twl, make_client_optimizer("sgd", 0.1), 1)(
        tp, {k: torch.tensor(v) for k, v in data.items()})
    assert list(got) == list(tp)
    _close(params_to_numpy(got), want, STEP_TOL)
    stats = want["batch_stats"]["Norm_0"]["BatchNorm_0"]
    assert np.abs(stats["mean"] - variables["batch_stats"]["Norm_0"][
        "BatchNorm_0"]["mean"]).max() > 1e-3


def test_stateful_fedavg_two_rounds_match_jax(resnet):
    jwl, twl, variables, tp = resnet
    j_data, t_data = _twins()
    common = dict(comm_round=2, client_num_per_round=3, batch_size=4,
                  lr=0.1, frequency_of_the_test=1)
    j_algo = JFedAvg(jwl, j_data, JFedAvgConfig(**common))
    want = j_algo.run(params=variables)
    t_algo = FedAvg(twl, t_data, FedAvgConfig(**common), device="cpu")
    got = t_algo.run(params=tp)
    _close(params_to_numpy(got), want, ROUND_TOL)
    for a, b in zip(t_algo.history, j_algo.history):
        for k in ("train_acc", "test_acc"):
            assert abs(a[k] - b[k]) <= 1e-6, k
        for k in ("train_loss", "test_loss"):
            assert abs(a[k] - b[k]) <= ROUND_TOL, k


def test_defended_mean_matches_jax_fused_and_skips_statistics(resnet):
    """One weak-DP round (clip 0.05, sigma 0.025): the port's fused
    backend (K1's plain version) against JAX's pallas backend in interpret
    mode; then the aggregate alone at sigma 0 leaves the statistics at
    the plain weighted mean while it clips the weights."""
    jwl, twl, variables, tp = resnet
    j_data, t_data = _twins()
    common = dict(comm_round=1, client_num_per_round=3, batch_size=4,
                  lr=0.1, frequency_of_the_test=1000, defense="weak_dp",
                  norm_bound=0.05, stddev=0.025)
    want = JRobust(jwl, j_data, JRobustConfig(
        defense_backend="pallas", **common)).run(params=variables)
    got = FedAvgRobust(twl, t_data, FedAvgRobustConfig(
        defense_backend="cuda", **common), device="cpu").run(params=tp)
    _close(params_to_numpy(got), want, ROUND_TOL)

    rng = np.random.RandomState(5)
    stacked = {k: v[None] + 0.2 * torch.tensor(
        rng.randn(3, *v.shape).astype(np.float32)) for k, v in tp.items()}
    weights = torch.tensor([3.0, 1.0, 2.0])
    out = make_fused_robust_aggregate(norm_bound=0.05)(stacked, weights, tp,
                                                       (1, 2))
    plain = tree_weighted_mean(stacked, weights)
    for k in tp:
        if k.startswith("batch_stats/"):
            torch.testing.assert_close(out[k], plain[k], atol=1e-6, rtol=0)
        elif k.endswith("kernel"):
            assert float((out[k] - plain[k]).abs().max()) > 1e-3, k


def test_stateful_checkpoint_resumes_bit_identical(resnet, tmp_path):
    jwl, twl, variables, tp = resnet
    _, data = _twins()
    kw = dict(client_num_per_round=2, batch_size=4, lr=0.1,
              frequency_of_the_test=100)
    straight = FedAvg(twl, data, FedAvgConfig(comm_round=3, **kw),
                      device="cpu").run(params=tp)
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1)
    FedAvg(twl, data, FedAvgConfig(comm_round=2, **kw),
           device="cpu").run(params=tp, checkpointer=ck)
    ck.close()
    resumed = FedAvg(twl, data, FedAvgConfig(comm_round=3, **kw),
                     device="cpu").run(params=tp, checkpointer=
                                       RoundCheckpointer(str(tmp_path /
                                                             "ck")))
    assert list(resumed) == list(straight)
    for k in straight:
        assert straight[k].numpy().tobytes() == resumed[k].numpy().tobytes()
    with open(manifest_path(ck.ckpt_dir, 1)) as f:
        manifest = json.load(f)
    saved = RoundCheckpointer(str(tmp_path / "ck")).restore(1)["params"]
    assert manifest["crc"]["params"] == j_tree_crc(
        params_to_numpy({k: torch.as_tensor(v) for k, v in saved.items()}))
    assert set(params_to_numpy(straight)) == {"batch_stats", "params"}


REFUSALS = ("scaffold", "feddyn", "ditto", "fedac")


def _jax_refusal(name, jwl, j_data):
    import importlib
    mod = importlib.import_module(f"fedml_tpu.algorithms.{name}")
    cls = {"scaffold": "Scaffold", "feddyn": "FedDyn", "ditto": "Ditto",
           "fedac": "FedAC"}[name]
    with pytest.raises(ValueError) as e:
        getattr(mod, cls)(jwl, j_data, getattr(mod, cls + "Config")())
    return str(e.value)


@pytest.mark.parametrize("name", REFUSALS)
def test_stateful_refusals_match_jax(resnet, name):
    import importlib
    jwl, twl, _, _ = resnet
    j_data, t_data = _twins()
    want = _jax_refusal(name, jwl, j_data)
    assert "stateful (BatchNorm)" in want
    mod = importlib.import_module(f"fedml_tpu_torch.algorithms.{name}")
    cls = {"scaffold": "Scaffold", "feddyn": "FedDyn", "ditto": "Ditto",
           "fedac": "FedAC"}[name]
    with pytest.raises(ValueError) as e:
        getattr(mod, cls)(twl, t_data, getattr(mod, cls + "Config")(),
                          device="cpu")
    assert str(e.value) == want


def test_wave_engine_refuses_scaffold_and_carries_statistics(resnet):
    from fedml_tpu.algorithms.cross_device import CrossDevice as JCrossDevice
    from fedml_tpu.algorithms.cross_device import (
        CrossDeviceConfig as JCrossDeviceConfig)
    from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                         CrossDeviceConfig)
    jwl, twl, variables, tp = resnet
    j_data, t_data = _twins()
    with pytest.raises(ValueError) as want:
        JCrossDevice(jwl, j_data, JCrossDeviceConfig(local_alg="scaffold"))
    with pytest.raises(ValueError) as got:
        CrossDevice(twl, t_data, CrossDeviceConfig(local_alg="scaffold"),
                    device="cpu")
    assert str(got.value) == str(want.value)
    kw = dict(comm_round=1, client_num_per_round=3, wave_size=2,
              batch_size=4, lr=0.1, frequency_of_the_test=1000)
    j_out = JCrossDevice(jwl, j_data, JCrossDeviceConfig(**kw)).run(
        params=variables)
    out = CrossDevice(twl, t_data, CrossDeviceConfig(**kw),
                      device="cpu").run(params=tp)
    _close(params_to_numpy(out), j_out, ROUND_TOL)
    key = "batch_stats/Norm_0/BatchNorm_0/mean"
    assert float((out[key] - tp[key]).abs().max()) > 1e-3
