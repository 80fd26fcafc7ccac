"""EfficientNet and VGG (``models/efficientnet.py``, ``models/vgg.py``)
against the JAX package's.

Trees: leaf paths, order and shapes equal flax's auto-named trees (from
``jax.eval_shape``: flax's own init of EfficientNet takes tens of seconds
on the CPU).  Logits: with flax-shaped weights drawn by numpy carried
across, eval-mode logits (no dropout, no drop-connect) equal flax's
within ``CV_TOL`` x max|logit| (f32 sums in another order; GroupNorm's
variance form, as tests/test_torch_resnet.py states), at the
``test_models_cv.py`` shapes (2 x 32 x 32 x 3, 10 classes).  The dropout
seam draws only with a key; the VGG16 perceptual trunk's taps and loss
equal flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import efficientnet as j_efficientnet
from fedml_tpu.models import vgg11 as j_vgg11
from fedml_tpu.models.vgg import VGG16Features as JVGG16Features
from fedml_tpu.models.vgg import perceptual_loss as j_perceptual_loss
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import (VGG16Features, efficientnet,
                                    perceptual_loss, vgg11)
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              apply_model)
from fedml_tpu_torch.utils.jax_params import params_from_numpy

CV_TOL = 1e-5              # x max|logit|

MODELS = {
    "efficientnet_b0": (lambda norm: j_efficientnet("b0", 10, norm=norm),
                        lambda norm: efficientnet("b0", 10, norm=norm)),
    "vgg11": (lambda norm: j_vgg11(10, norm=norm),
              lambda norm: vgg11(10, norm=norm)),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(jm, x, rng):
    """flax's tree for ``jm`` from ``jax.eval_shape``, filled from ``rng``:
    kernels N(0, 1 / fan_in), scales and variances 1 + |0.1 N|, biases
    and means 0.1 N."""
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


def _paths(tree):
    return ["/".join(k.strip("[]'").split("']['"))
            for k in (jax.tree_util.keystr(p) for p, _ in
                      jax.tree_util.tree_leaves_with_path(tree))]


@pytest.mark.parametrize("name,norm", [("efficientnet_b0", "group"),
                                       ("vgg11", "none"),
                                       ("vgg11", "batch")])
def test_eval_logits_with_carried_weights(name, norm):
    jfn, tfn = MODELS[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jfn(norm)
    variables = random_variables(jm, x, rng)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    stateful = norm == "batch"
    tree = variables if stateful else variables["params"]
    wl = ClassificationWorkload(tfn(norm), 10, stateful=stateful)
    mine = wl.init(torch.Generator().manual_seed(0))
    carried = params_from_numpy(tree)
    assert list(mine) == list(carried) == _paths(tree)
    assert all(mine[k].shape == carried[k].shape for k in mine)
    with torch.no_grad():
        got = apply_model(wl.model, carried, torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CV_TOL * float(np.abs(want).max()))


def test_factories_and_dropout_seam():
    """The CLI names build B0 and VGG-11/13/16 at CIFAR width, stochastic
    (head dropout, drop-connect) only with a key: keyed train-mode logits
    move and repeat; without a key they are the eval forward."""
    x = torch.tensor(np.random.RandomState(1).randn(2, 32, 32, 3)
                     .astype(np.float32))
    sizes = {"efficientnet": 4_020_358, "vgg11": 28_144_010,
             "vgg13": 28_328_522, "vgg16": 33_638_218}
    for name, n in sizes.items():
        wl = create_workload(name, "cifar10", 10, (32, 32, 3))
        assert wl.stochastic
        assert sum(p.numel() for p in wl.model.parameters()) == n, name
    wl = create_workload("efficientnet", "cifar10", 10, (32, 32, 3))
    p = wl.init(torch.Generator().manual_seed(0))
    key = torch.tensor([5, 6], dtype=torch.int64)
    with torch.no_grad():
        plain = apply_model(wl.model, p, x)
        keyed = apply_model(wl.model, p, x, key)
        again = apply_model(wl.model, p, x, key)
    assert torch.equal(keyed, again) and not torch.equal(keyed, plain)


def test_vgg16_features_and_perceptual_loss():
    """The trunk's four taps and the perceptual loss equal flax's (a
    single-channel input repeated to RGB), at 16 x 16."""
    rng = np.random.RandomState(2)
    x1 = rng.rand(2, 16, 16, 1).astype(np.float32)
    x2 = rng.rand(2, 16, 16, 1).astype(np.float32)
    jm = JVGG16Features()
    variables = random_variables(jm, np.repeat(x1, 3, -1), rng)
    params = variables["params"]
    want = jm.apply(variables, jnp.asarray(np.repeat(x1, 3, -1)))
    want_loss = float(j_perceptual_loss(params, jm, jnp.asarray(x1),
                                        jnp.asarray(x2)))
    carried = params_from_numpy(params)
    model = VGG16Features()
    assert sorted(k.replace(".", "/") for k, _ in
                  model.named_parameters()) == sorted(carried)
    from torch.func import functional_call
    names = {k.replace("/", "."): v for k, v in carried.items()}
    with torch.no_grad():
        got = functional_call(model, names,
                              (torch.tensor(np.repeat(x1, 3, -1)),))
        loss = float(perceptual_loss(carried, model, torch.tensor(x1),
                                     torch.tensor(x2)))
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), v,
                                   rtol=0, atol=1e-5 * np.abs(v).max())
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
