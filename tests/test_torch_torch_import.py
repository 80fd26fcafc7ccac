"""``utils/torch_import.py``, the port's copy of the JAX package's
reference-checkpoint importer, on state_dicts the tests build.

A reference ``state_dict`` (DataParallel's ``module.`` prefix on every
key; torchvision's VGG16 trunk and a BatchNorm ResNet-56 in the
reference's module order) is imported into the port's flat parameters
and into the JAX package's variables by the JAX importer; both give the
same leaves bit for bit (a transpose and a copy), conv kernels OIHW -> HWIO,
dense ``[out, in]`` -> ``[in, out]``, BatchNorm's running statistics into
``batch_stats``; a checkpoint file round-trips through
``load_torch_checkpoint``; a unit-count or shape mismatch raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import resnet56 as j_resnet56
from fedml_tpu.models.vgg import VGG16Features as JVGG16Features
from fedml_tpu.utils.torch_import import (
    import_torch_state_dict as j_import)
from fedml_tpu_torch.models import (LogisticRegression, VGG16Features,
                                    resnet56)
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_to_numpy
from fedml_tpu_torch.utils.torch_import import (import_torch_state_dict,
                                                load_pretrained_resnet,
                                                load_torch_checkpoint,
                                                strip_module_prefix)


def _features_state_dict(seed):
    """torchvision ``vgg16().features`` truncated to its first 10 convs
    (the reference's perceptual-loss trunk): ``features.<i>.weight``
    OIHW and ``.bias``, with the ReLU and pool indices in between."""
    g = torch.Generator().manual_seed(seed)
    sd, c, i, convs = {}, 3, 0, 0
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512):
        if v == "M":
            i += 1
            continue
        sd[f"features.{i}.weight"] = torch.randn(v, c, 3, 3, generator=g)
        sd[f"features.{i}.bias"] = torch.randn(v, generator=g)
        c, i, convs = v, i + 2, convs + 1
        if convs == 10:
            break
    return sd


def test_import_layouts_equal_jax():
    """The VGG16 trunk (10 convs, OIHW -> HWIO) from a DataParallel
    state_dict, and a dense layer ([out, in] -> [in, out]): equal to the
    JAX importer's leaves bit for bit; a truncated or mis-shaped
    checkpoint raises."""
    sd = strip_module_prefix({f"module.{k}": v for k, v in
                              _features_state_dict(0).items()})
    model = VGG16Features()
    params = {k.replace(".", "/"): p.detach().clone()
              for k, p in model.named_parameters()}
    got = import_torch_state_dict(params, sd)
    np.testing.assert_array_equal(
        got["Conv_0/kernel"].numpy(),
        sd["features.0.weight"].numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(got["Conv_9/bias"].numpy(),
                                  sd["features.21.bias"].numpy())
    jm = JVGG16Features()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.zeros((1, 16, 16, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         shapes["params"])
    want = j_import(zeros, {k: v.numpy() for k, v in sd.items()})
    mine = params_to_numpy(got)
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree.leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(p))
    with pytest.raises(ValueError, match="unit count"):
        import_torch_state_dict(params, dict(list(sd.items())[:-2]))
    bad = dict(sd)
    bad["features.21.weight"] = torch.zeros(512, 512, 5, 5)
    with pytest.raises(ValueError, match="shape"):
        import_torch_state_dict(params, bad)
    lr = ClassificationWorkload(LogisticRegression(12, 4), 4).init()
    w = torch.randn(4, 12)
    dense = import_torch_state_dict(lr, {"linear.weight": w,
                                         "linear.bias": torch.ones(4)})
    assert torch.equal(dense["Dense_0/kernel"], w.T)
    assert torch.equal(dense["Dense_0/bias"], torch.ones(4))


def _ref_resnet56_state_dict(seed):
    """A ResNet-56 state_dict in the reference's module order (conv1,
    bn1, then each Bottleneck's conv1/bn1/conv2/bn2/conv3/bn3 and its
    downsample conv/bn, then fc), built from the port's tree shapes."""
    params = ClassificationWorkload(resnet56(10, norm="batch"), 10,
                                    stateful=True).init()
    from fedml_tpu_torch.utils.torch_import import _flax_units
    rng = np.random.RandomState(seed)
    sd = {}
    for i, (path, leaves) in enumerate(_flax_units(params, "params/")):
        name = f"unit{i:03d}"
        if "kernel" in leaves:
            k = params[leaves["kernel"]]
            shape = (tuple(k.shape[::-1]) if k.dim() == 2 else
                     (k.shape[3], k.shape[2], k.shape[0], k.shape[1]))
            sd[f"{name}.weight"] = torch.tensor(rng.randn(*shape),
                                                dtype=torch.float32)
            if "bias" in leaves:
                sd[f"{name}.bias"] = torch.tensor(
                    rng.randn(k.shape[-1]), dtype=torch.float32)
        else:
            c = params[leaves["scale"]].shape[0]
            for part in ("weight", "bias", "running_mean"):
                sd[f"{name}.{part}"] = torch.tensor(rng.randn(c),
                                                    dtype=torch.float32)
            sd[f"{name}.running_var"] = torch.tensor(rng.rand(c) + 0.5,
                                                     dtype=torch.float32)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(3)
    return params, sd


def test_batchnorm_resnet_import_equals_jax(tmp_path):
    """The BatchNorm ResNet-56 from a checkpoint file: the port's import
    equals the JAX importer's on flax's variables, leaf for leaf, the
    running statistics included; ``load_pretrained_resnet`` gives the
    same tree."""
    params, sd = _ref_resnet56_state_dict(1)
    path = tmp_path / "resnet56.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    loaded = load_torch_checkpoint(str(path))
    assert list(loaded) == list(sd)
    got = import_torch_state_dict(params, loaded)
    jm = j_resnet56(10, norm="batch")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.zeros((1, 32, 32, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    want = j_import(zeros, loaded)
    mine = params_to_numpy(got)
    for coll in ("params", "batch_stats"):
        for (p, a), b in zip(
                jax.tree_util.tree_leaves_with_path(want[coll]),
                jax.tree.leaves(mine[coll])):
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg=jax.tree_util.keystr(p))
    _, pre = load_pretrained_resnet(str(path))
    assert all(torch.equal(pre[k], got[k]) for k in got)
