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
    # VGG is ported (its head sized from the 32 x 32 input; a 28 x 28 one,
    # which its five pools leave 0 x 0, is refused by name); an unknown
    # name is refused with the port's list
    from fedml_tpu_torch.models import VGG
    assert isinstance(create_workload("vgg11", "cifar10", 10,
                                      (32, 32, 3)).model, VGG)
    with pytest.raises(ValueError, match="vgg11 on a 28x28 input"):
        create_workload("vgg11", "femnist", 62, (28, 28, 1))
    with pytest.raises(KeyError, match="unknown model.*vgg16"):
        create_workload("vgg19", "femnist", 62, (28, 28, 1))


# CNNDropOut's eval-mode logits: f32 sums in another order, as the CNN's
DROPOUT_CNN_TOL = 1e-5


@pytest.mark.parametrize("shape", [(4, 28, 28, 1), (3, 28, 28)])
@pytest.mark.parametrize("only_digits", [False, True])
def test_cnn_dropout_eval_logits_with_carried_weights(rng, shape,
                                                      only_digits):
    """Eval mode (no key): the port's CNNDropOut gives flax's logits with
    carried weights; the parameter tree and count are flax's."""
    from fedml_tpu.models import CNNDropOut as JDrop
    from fedml_tpu_torch.models import CNNDropOut
    x = rng.randn(*shape).astype(np.float32)
    params, want = _carry(JDrop(only_digits=only_digits), x)
    model = CNNDropOut(only_digits=only_digits)
    assert sorted(k.replace(".", "/") for k, _ in model.named_parameters()) \
        == sorted(params)
    assert sum(v.numel() for v in params.values()) == (
        1_199_882 if only_digits else 1_206_590)
    got = apply_model(model, params, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=DROPOUT_CNN_TOL,
                               rtol=0)


def test_cnn_dropout_masks_keep_their_rates_and_follow_the_key():
    """Train mode (a key): each dropout layer keeps 1 - rate of its
    elements (0.75 and 0.5, within 1% over ~10^5 draws) and scales the
    kept ones by 1 / keep; the same key gives the same masks, another key
    other masks, and no key none (eval equals the deterministic
    forward)."""
    from fedml_tpu_torch.models.layers import dropout
    x = torch.ones(8, 12, 12, 64)
    k = torch.tensor([123, 456], dtype=torch.int64)
    for layer, rate in ((0, 0.25), (1, 0.5)):
        out = dropout(x, rate, k, layer)
        kept = out != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
        torch.testing.assert_close(out[kept], torch.full_like(
            out[kept], 1 / (1 - rate)), rtol=0, atol=0)
        assert torch.equal(out, dropout(x, rate, k.clone(), layer))
        other = dropout(x, rate, torch.tensor([123, 457]), layer)
        assert not torch.equal(out, other)
    assert not torch.equal(dropout(x, 0.5, k, 0), dropout(x, 0.5, k, 1))
    assert dropout(x, 0.5, None, 0) is x
    wl = create_workload("cnn", "femnist", 62, (28, 28, 1))
    assert wl.stochastic
    p = wl.init(torch.Generator().manual_seed(0))
    batch = {"x": torch.randn(4, 28, 28, 1), "y": torch.zeros(4).long(),
             "mask": torch.ones(4)}
    eval_loss, _ = wl.loss_fn(p, batch)
    a, _ = wl.loss_fn(p, batch, k)
    b, _ = wl.loss_fn(p, batch, k)
    assert float(a) == float(b) and float(a) != float(eval_loss)
