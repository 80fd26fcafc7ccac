"""MobileNet V1 and V3 (config 3) against the JAX package.

The leaf paths, shapes and order of ``mobilenet`` and ``mobilenet_v3``
(small and large) equal flax's auto-named trees (``Conv_10`` before
``Conv_2``), in GroupNorm and in BatchNorm; with flax's weights (every
leaf perturbed, BatchNorm's running statistics too) carried across,
eval-mode logits equal flax's within ``MOBILENET_TOL`` x max|logit| (f32
sums in another order, GroupNorm's variance form: see
tests/test_torch_resnet.py).  V3's head dropout runs only with a key, so
eval mode is the deterministic forward on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.mobilenet import mobilenet as j_mobilenet
from fedml_tpu.models.mobilenet import mobilenet_v3 as j_mobilenet_v3
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import mobilenet, mobilenet_v3
from fedml_tpu_torch.models.mobilenet import InvertedResidual
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              apply_model)
from fedml_tpu_torch.utils.jax_params import params_from_numpy

MOBILENET_TOL = 1e-5       # x max|logit|

MODELS = {
    "v1": (lambda norm: j_mobilenet(10, norm=norm, width_mult=0.25),
           lambda norm: mobilenet(10, norm=norm, width_mult=0.25), 16),
    "v3_small": (lambda norm: j_mobilenet_v3(10, "small", norm=norm),
                 lambda norm: mobilenet_v3(10, "small", norm=norm), 32),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(jm, x, rng):
    """flax's tree for ``jm`` (from ``jax.eval_shape``: flax's own init
    of these nets takes tens of seconds on the CPU) filled from ``rng``:
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


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_mobilenet_eval_logits_with_carried_weights(name, norm):
    jfn, tfn, side = MODELS[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, side, side, 3).astype(np.float32)
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
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MOBILENET_TOL * float(np.abs(want).max()))


def test_mobilenet_trees_equal_flax():
    """Leaf counts and element counts at CIFAR width, 10 classes: V1 83
    leaves (3,217,226), V3 small 142, large 174; V1 in BatchNorm adds the
    27 norms' running statistics."""
    x = jnp.zeros((1, 32, 32, 3))
    for jm, tm, stateful, leaves in (
            (j_mobilenet(10), mobilenet(10), False, 83),
            (j_mobilenet_v3(10, "small"), mobilenet_v3(10, "small"), False,
             142),
            (j_mobilenet_v3(10, "large"), mobilenet_v3(10, "large"), False,
             174),
            (j_mobilenet(10, norm="batch"), mobilenet(10, norm="batch"),
             True, 137)):
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x))
        tree = dict(shapes) if stateful else shapes["params"]
        mine = ClassificationWorkload(tm, 10, stateful=stateful).init()
        assert list(mine) == _paths(tree) and len(mine) == leaves
        assert [tuple(v.shape) for v in mine.values()] == \
            [tuple(v.shape) for v in jax.tree.leaves(tree)]
    v1 = ClassificationWorkload(mobilenet(10), 10).init()
    assert sum(v.numel() for v in v1.values()) == 3_217_226


def test_dropout_seam_and_factories():
    """V3 draws its head dropout (and a block's stochastic depth) only
    with a key: with one, train-mode logits move; without, they are the
    eval forward.  The CLI factory builds both models at CIFAR width."""
    x = torch.tensor(np.random.RandomState(1).randn(4, 32, 32, 3)
                     .astype(np.float32))
    wl = create_workload("mobilenet_v3", "cifar10", 10, (32, 32, 3))
    assert wl.stochastic and not create_workload(
        "mobilenet", "cifar10", 10, (32, 32, 3)).stochastic
    p = wl.init(torch.Generator().manual_seed(0))
    key = torch.tensor([3, 4], dtype=torch.int64)
    with torch.no_grad():
        plain = apply_model(wl.model, p, x)
        keyed = apply_model(wl.model, p, x, key)
        again = apply_model(wl.model, p, x, key)
    assert torch.equal(keyed, again) and not torch.equal(keyed, plain)
    block = InvertedResidual(8, 16, 8, 3, 1, False, True, drop_rate=0.5,
                             layer=1)
    h = torch.randn(16, 8, 4, 4)
    for m in block.modules():
        if m is not block and hasattr(m, "reset_parameters"):
            m.reset_parameters()
    with torch.no_grad():
        base = block(h)
        dropped = block(h, key)
    # each sample keeps its branch (x 2) or drops it to the identity
    branch = base - h
    per_sample = [(torch.allclose(dropped[i] - h[i], 2 * branch[i],
                                  atol=1e-6)
                   or torch.equal(dropped[i], h[i])) for i in range(16)]
    assert all(per_sample)
