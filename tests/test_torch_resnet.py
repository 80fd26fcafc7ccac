"""The port's GroupNorm ResNets (``models/resnet.py``, ``models/norms.py``)
and flax's ``SAME`` padding (``models/layers.py``) against the JAX package.

Logits of ``resnet18_gn``, ``resnet56`` and ``resnet110`` with flax's
weights carried across (every leaf perturbed, so the zero-initialised
scales open every residual branch) at batch 2, 32x32x3, within
``RESNET_TOL`` x max|logit|: f32 sums in another order, and GroupNorm's
variance, which flax takes as E[x^2] - E[x]^2 and ``F.group_norm`` as
E[(x - mean)^2] (a cancellation flax pays when |mean| >> std; measured at
~6e-7 x max|logit| on these inputs).  The padding cases are exact
layouts, held at 1e-5."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.norms import Norm as JNorm
from fedml_tpu.models.resnet import resnet18_gn as j_resnet18_gn
from fedml_tpu.models.resnet import resnet56 as j_resnet56
from fedml_tpu.models.resnet import resnet110 as j_resnet110
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import resnet18_gn, resnet56, resnet110
from fedml_tpu_torch.models.layers import Conv2d, max_pool_same, same_pads
from fedml_tpu_torch.models.norms import Norm, group_count
from fedml_tpu_torch.trainer.workload import apply_model
from fedml_tpu_torch.utils.jax_params import params_from_numpy

RESNET_TOL = 1e-5          # x max|logit|
PAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these tests run many small ops, on which
    torch's thread pool spins when the workers of a parallel test run
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODELS = {
    "resnet18_gn": (j_resnet18_gn, resnet18_gn, 100, 11_227_812),
    "resnet56": (j_resnet56, resnet56, 10, 591_322),
    "resnet110": (j_resnet110, resnet110, 10, 1_147_738),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_resnet_logits_with_carried_weights(name):
    jfn, tfn, classes, n_params = MODELS[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jfn(classes)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda v: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(
            np.float32), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tp = params_from_numpy(params)
    model = tfn(classes)
    assert sorted(k.replace(".", "/") for k, _ in model.named_parameters()) \
        == sorted(tp)
    assert sum(v.numel() for v in tp.values()) == n_params
    got = apply_model(model, tp, torch.tensor(x)).detach().numpy()
    assert got.shape == (2, classes)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESNET_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_resnet_init_matches_flax_layout(name):
    """The port's init draws the same tree as flax's: every leaf's shape,
    the zero-initialised scale of each block's last norm, unit scales
    elsewhere, zero biases, conv kernels at flax's fan-out variance."""
    jfn, tfn, classes, _ = MODELS[name]
    ref = jfn(classes).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    ref = params_from_numpy(jax.tree.map(np.asarray, ref["params"]))
    wl = create_workload(name, "fed_cifar100" if classes == 100
                         else "cifar10", classes, (32, 32, 3))
    p = wl.init(torch.Generator().manual_seed(0))
    assert list(p) == list(ref)
    for k in p:
        assert p[k].shape == ref[k].shape, k
        if k.endswith("/scale") or k.endswith("/bias"):
            assert torch.equal(p[k], torch.as_tensor(ref[k])), k
    stem = p["Conv_0/kernel"]
    fan_out = stem.shape[0] * stem.shape[1] * stem.shape[3]
    np.testing.assert_allclose(float(stem.std()), np.sqrt(2 / fan_out),
                               rtol=0.15)


@pytest.mark.parametrize("channels,per_group", [(64, 32), (16, 32),
                                                (96, 32), (48, 20),
                                                (256, 32), (7, 3)])
def test_norm_group_counts_match_flax(channels, per_group):
    """``channels // channels_per_group`` groups, at least one, decremented
    until they divide the channels; the normalised output equals flax's
    GroupNorm over NHWC, zero_init starts the scale at 0, ``none`` is the
    identity without parameters, ``batch`` is refused by name."""
    x = np.random.RandomState(1).randn(2, 5, 5, channels).astype(np.float32)
    jn = JNorm("group", channels_per_group=per_group)
    jp = jn.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jn.apply(jp, jnp.asarray(x)))
    norm = Norm(channels, "group", channels_per_group=per_group)
    groups = norm.GroupNorm_0.groups
    assert groups == group_count(channels, per_group)
    assert channels % groups == 0 and groups >= 1
    # flax's group count, read back from its normalised statistics
    flat = want.reshape(2, -1, groups, channels // groups)
    np.testing.assert_allclose(flat.mean(axis=(1, 3)), 0, atol=1e-5)
    got = norm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    z = Norm(channels, zero_init=True)
    z.GroupNorm_0.reset_parameters()
    assert float(z.GroupNorm_0.scale.detach().abs().sum()) == 0.0
    zj = JNorm("group", zero_init=True).init(jax.random.key(0),
                                             jnp.asarray(x))
    assert float(np.abs(zj["params"]["GroupNorm_0"]["scale"]).sum()) == 0.0
    assert list(Norm(channels, "none").parameters()) == []
    # BatchNorm builds under flax's path (tests/test_torch_batchnorm.py
    # holds it to flax)
    bn = Norm(channels, "batch")
    assert [k for k, _ in bn.named_parameters()] == ["BatchNorm_0.scale",
                                                     "BatchNorm_0.bias"]
    assert [k for k, _ in bn.named_buffers()] == ["BatchNorm_0.mean",
                                                  "BatchNorm_0.var"]


@pytest.mark.parametrize("size", [15, 16, 32, 7])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_same_padding_is_flax_asymmetric(size, k, stride):
    """flax ``SAME`` pads the smaller half before, the larger after: on 32
    a 7x7/2 conv pads (2, 3), on 16 a 3x3/2 one (0, 1).  The port's conv
    and max pool give flax's outputs on odd and even sizes."""
    assert same_pads(32, 7, 2) == (2, 3) and same_pads(16, 3, 2) == (0, 1)
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    jconv = fnn.Conv(4, (k, k), strides=(stride, stride), padding="SAME",
                     use_bias=False)
    jp = jconv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(jp, jnp.asarray(x)))
    conv = Conv2d(3, 4, k, stride=stride, use_bias=False)
    conv.kernel.data = torch.tensor(np.asarray(jp["params"]["kernel"]))
    got = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=PAD_TOL,
                               rtol=0)
    want_pool = np.asarray(fnn.max_pool(jnp.asarray(x), (k, k),
                                        strides=(stride, stride),
                                        padding="SAME"))
    got_pool = max_pool_same(torch.tensor(x).permute(0, 3, 1, 2), k,
                             stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)


@pytest.mark.parametrize("clients", [1, 2])
def test_groupnorm_resnet_under_a_vmap_of_one_client(clients):
    """The cohort engine vmaps a client's forward; with one client a CPU
    conv of the permuted (channels-last) input returns channels-last,
    which `F.group_norm` under vmap could not query.  The vmapped logits
    equal each client's own forward."""
    from torch.func import vmap
    from fedml_tpu_torch.trainer.workload import init_module
    model = resnet56(10)
    params = init_module(model, torch.Generator().manual_seed(0))
    stacked = {k: torch.stack([v] * clients) for k, v in params.items()}
    x = torch.rand(clients, 4, 16, 16, 3,
                   generator=torch.Generator().manual_seed(1))
    got = vmap(lambda p, xx: apply_model(model, p, xx))(stacked, x)
    for c in range(clients):
        np.testing.assert_allclose(got[c].numpy(),
                                   apply_model(model, params, x[c]).numpy(),
                                   rtol=1e-5, atol=1e-6)
