"""The image models on a one-channel input (the ``femnist`` twin, 28 x 28
x 1) against the JAX package.

flax infers a conv's input channels from the first batch; the port's
factory (``experiments/models.py::create_workload``) passes the sample's
channel count to every image model.  For each model: the port's tree
equals the JAX package's (``jax.eval_shape`` of its workload's init:
paths, order and every shape, the stem's kernel ``[k, k, 1, c]``), and
one FedAvg round (2 of 4 clients, B=2, SGD lr 0.1, clip 1) from flax-shaped
weights drawn by numpy and carried across lands within ``ROUND_TOL`` of
JAX's round, the tolerance of the ResNets' f32 rounds
(``tests/test_torch_batchnorm.py``): f32 sums in another order.  The
models that draw dropout masks (MobileNet V3's head, EfficientNet's head
and drop-connect) run their round with those rates at 0 on both sides:
the port's masks are a counter hash, not flax's ``make_rng`` stream.
VGG on 28 x 28 leaves a 0 x 0 map after five pools (flax fails at init);
the port refuses it by name."""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.data.synthetic import \
    synthetic_federated_dataset as j_synthetic
from fedml_tpu.experiments.models import create_workload as j_create_workload
from fedml_tpu.models import EfficientNet as JEfficientNet
from fedml_tpu.models.mobilenet import MobileNetV3 as JMobileNetV3
from fedml_tpu.trainer.workload import \
    ClassificationWorkload as JClassificationWorkload
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models.efficientnet import EfficientNet
from fedml_tpu_torch.models.mobilenet import MobileNetV3
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import (params_from_numpy,
                                              params_to_numpy)

SHAPE, CLASSES = (28, 28, 1), 62      # the femnist twin
ROUND_TOL = 1e-4                      # abs, every leaf of the new global
MODELS = ("resnet56", "resnet110", "resnet18_gn", "mobilenet",
          "mobilenet_v3", "efficientnet")
# the round's deterministic twins of the models that draw dropout masks
DETERMINISTIC = {
    "mobilenet_v3": (lambda: JMobileNetV3(num_classes=CLASSES, dropout=0.0),
                     lambda: MobileNetV3(num_classes=CLASSES,
                                         dropout_rate=0.0, in_channels=1)),
    "efficientnet": (lambda: JEfficientNet(num_classes=CLASSES, dropout=0.0,
                                           drop_connect=0.0),
                     lambda: EfficientNet(num_classes=CLASSES,
                                          dropout_rate=0.0, drop_connect=0.0,
                                          in_channels=1)),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return ["/".join(k.strip("[]'").split("']['"))
            for k in (jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_leaves_with_path(tree))]


def _fill(shapes, rng):
    """Weights in flax's tree drawn from ``rng``: kernels N(0, 1 /
    fan_in), scales 1 + |0.1 N|, biases 0.1 N."""
    def fill(path, s):
        name = jax.tree_util.keystr(path)
        z = rng.randn(*s.shape).astype(np.float32)
        if "kernel" in name:
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if "scale" in name:
            return 1 + 0.1 * np.abs(z)
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("name", MODELS)
def test_one_channel_tree_and_round_match_jax(name):
    jwl = j_create_workload(name, "femnist", CLASSES, SHAPE)
    twl = create_workload(name, "femnist", CLASSES, SHAPE)
    x0 = {"x": np.zeros((1, *SHAPE), np.float32)}
    shapes = jax.eval_shape(lambda: jwl.init(jax.random.key(0), x0))
    mine = twl.init(torch.Generator().manual_seed(0))
    assert list(mine) == _paths(shapes)
    assert [tuple(v.shape) for v in mine.values()] \
        == [tuple(s.shape) for s in jax.tree.leaves(shapes)]
    assert any(v.dim() == 4 and v.shape[2] == 1 for v in mine.values())

    if name in DETERMINISTIC:
        jfn, tfn = DETERMINISTIC[name]
        jwl = JClassificationWorkload(jfn(), CLASSES)
        twl = ClassificationWorkload(tfn(), CLASSES, grad_clip_norm=1.0)
        assert not twl.stochastic
    p0 = _fill(dict(shapes), np.random.RandomState(0))
    kw = dict(num_clients=4, samples_per_client=4, sample_shape=SHAPE,
              class_num=CLASSES, batch_size=2, seed=3)
    common = dict(comm_round=1, client_num_per_round=2, batch_size=2,
                  lr=0.1, frequency_of_the_test=1000)
    want = JFedAvg(jwl, j_synthetic(**kw), JFedAvgConfig(**common)).run(
        params=p0)
    got = FedAvg(twl, synthetic_federated_dataset(**kw),
                 FedAvgConfig(**common), device="cpu").run(
        params=params_from_numpy(p0))
    got = params_to_numpy(got)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=ROUND_TOL), got, want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 10 * ROUND_TOL


@pytest.mark.parametrize("name", ["vgg11", "vgg13", "vgg16"])
def test_vgg_refuses_a_28x28_input_by_name(name):
    with pytest.raises(ValueError, match=rf"{name} on a 28x28 input"):
        create_workload(name, "femnist", CLASSES, SHAPE)
    wl = create_workload(name, "cifar10", 10, (32, 32, 1))
    stem = wl.init(torch.Generator().manual_seed(0))["Conv_0/kernel"]
    assert tuple(stem.shape) == (3, 3, 1, 64)
