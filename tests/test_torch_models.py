"""Port models against flax with carried weights: logistic regression and
the FedAvg-paper CNN give the same logits within 1e-5 (f32 sums taken in
another order).  The CNN case pins the NHWC input and the (H, W, C)
flatten before ``Dense_0``: a wrong flatten order still trains but fails
here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.trainer.workload import apply_model
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


def _carry(jmodel, x):
    params = jmodel.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    return params_from_numpy(jax.tree.map(np.asarray, params)), want


def test_logistic_regression_logits(rng):
    x = rng.randn(5, 784).astype(np.float32)
    params, want = _carry(JLR(784, 10), x)
    got = apply_model(LogisticRegression(784, 10), params, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(4, 28, 28, 1), (3, 28, 28)])
@pytest.mark.parametrize("only_digits", [False, True])
def test_cnn_logits_with_carried_weights(rng, shape, only_digits):
    x = rng.randn(*shape).astype(np.float32)
    params, want = _carry(JCNN(only_digits=only_digits), x)
    model = CNNOriginalFedAvg(only_digits=only_digits)
    got = apply_model(model, params, torch.tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def test_cnn_flatten_order_matters(rng):
    """Feeding the CNN an NCHW-flattened Dense_0 (torch's habit) changes
    the logits: the test above would catch that layout slip."""
    x = rng.randn(2, 28, 28, 1).astype(np.float32)
    params, want = _carry(JCNN(only_digits=False), x)
    k = params["Dense_0/kernel"].reshape(7, 7, 64, 512)
    wrong = dict(params)
    wrong["Dense_0/kernel"] = k.permute(2, 0, 1, 3).reshape(3136, 512)
    got = apply_model(CNNOriginalFedAvg(only_digits=False), wrong,
                      torch.tensor(x))
    assert np.abs(got.detach().numpy() - want).max() > 1e-3


def test_port_init_matches_flax_layout():
    """The port's own init: flax's leaf paths, order, shapes and dtypes;
    1,690,046 parameters at 62 classes; biases zero, kernels LeCun-scaled;
    the same seed gives the same weights."""
    x = jnp.zeros((1, 28, 28, 1))
    jp = JCNN(only_digits=False).init(jax.random.key(0), x)["params"]
    wl = create_workload("cnn_fedavg", "femnist", 62, (28, 28, 1))
    p = wl.init(torch.Generator().manual_seed(0))
    ref = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert list(p) == list(ref)
    for k in p:
        assert p[k].shape == ref[k].shape and p[k].dtype == ref[k].dtype
    assert sum(v.numel() for v in p.values()) == 1_690_046
    assert float(p["Dense_0/bias"].abs().sum()) == 0.0
    np.testing.assert_allclose(float(p["Dense_0/kernel"].std()),
                               np.sqrt(1 / 3136), rtol=0.05)
    again = wl.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
    tree = params_to_numpy(p)
    assert tree["Conv_1"]["kernel"].shape == (5, 5, 32, 64)


def test_unported_model_named():
    with pytest.raises(KeyError, match="not ported"):
        create_workload("cnn", "femnist", 62, (28, 28, 1))
