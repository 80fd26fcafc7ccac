"""The Switch MoE FFN (``models/moe.py``) of the port against the JAX
package's, on numpy-seeded inputs with flax's weights carried across.

Mirrors ``tests/test_moe.py``'s claims (routing and drops, pads kept out
of dispatch and of the balance statistics, grouped dispatch, the balance
loss reaching training) and holds each output to the JAX module's:
outputs and the balance loss within 1e-5 (f32 sums in another order;
routing itself is exact, so a dropped token is 0 on both sides).  It also
shows the layer runs under ``vmap(grad)`` over clients, as local
training takes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad, vmap

from fedml_tpu.models import SwitchFFN as JSwitchFFN
from fedml_tpu.models import TransformerLM as JTransformerLM
from fedml_tpu.trainer.workload import NWPWorkload as JNWPWorkload
from fedml_tpu_torch.models import TransformerLM
from fedml_tpu_torch.models.moe import SwitchFFN, capacity
from fedml_tpu_torch.trainer.workload import NWPWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy

TOL = 1e-5


def _jax_ffn(ffn, x, mask=None):
    params = ffn.init(jax.random.key(0), x)["params"]
    y, sown = ffn.apply({"params": params}, x, mask, mutable=["losses"])
    aux = float(jax.tree.leaves(sown["losses"])[0])
    return jax.tree.map(np.asarray, params), np.asarray(y), aux


def _port_ffn(jffn, params, x, mask=None):
    """The port's SwitchFFN of ``jffn``'s sizes over the carried params:
    ``(module, y, load_balance)``."""
    ffn = SwitchFFN(jffn.n_experts, jffn.d_model, jffn.d_ff,
                    capacity_factor=jffn.capacity_factor,
                    group_size=jffn.group_size)
    names = {k.replace("/", "."): v
             for k, v in params_from_numpy(params).items()}
    m = None if mask is None else torch.tensor(np.asarray(mask))
    y, aux = functional_call(ffn, names, (torch.tensor(np.asarray(x)), m))
    return ffn, y.detach().numpy(), float(aux)


def test_switch_ffn_routes_and_drops():
    """One 64-token group at capacity ceil(0.04 * 64 / 2) = 2 an expert:
    at most 4 tokens kept, the rest exactly 0, as in JAX."""
    jffn = JSwitchFFN(n_experts=2, d_model=8, d_ff=16, capacity_factor=0.04)
    x = jnp.asarray(np.random.RandomState(1).randn(1, 64, 8), jnp.float32)
    params, want, want_aux = _jax_ffn(jffn, x)
    _, y, aux = _port_ffn(jffn, params, x)
    assert capacity(0.04, 64, 2) == 2
    kept = (np.abs(y[0]).sum(-1) > 0).sum()
    assert 1 <= kept <= 4, kept
    np.testing.assert_array_equal(y[0] == 0, want[0] == 0)
    np.testing.assert_allclose(y, want, atol=TOL, rtol=0)
    assert abs(aux - want_aux) < TOL
    ffn = SwitchFFN(2, 8, 16, capacity_factor=0.04)
    names = {k.replace("/", "."): v
             for k, v in params_from_numpy(params).items()}
    ffn.load_state_dict(names)
    assert float(ffn.dropped(torch.tensor(np.asarray(x)))) == 64 - kept


def test_switch_ffn_pads_excluded():
    """Pads come back 0, take no capacity and stay out of the balance
    statistics: real-token outputs and the aux equal the unpadded
    prefix's, on both sides."""
    jffn = JSwitchFFN(n_experts=4, d_model=8, d_ff=16, capacity_factor=4.0)
    x = jnp.asarray(np.random.RandomState(2).randn(1, 16, 8), jnp.float32)
    mask = jnp.asarray([[1.0] * 8 + [0.0] * 8])
    params, want_all, aux_all_j = _jax_ffn(jffn, x)
    _, want_mask, aux_mask_j = _jax_ffn(jffn, x, mask)
    _, y_all, aux_all = _port_ffn(jffn, params, x)
    _, y_mask, aux_mask = _port_ffn(jffn, params, x, mask)
    _, _, aux_prefix = _port_ffn(jffn, params, x[:, :8])
    np.testing.assert_array_equal(y_mask[0, 8:], 0.0)
    np.testing.assert_allclose(y_mask[0, :8], y_all[0, :8], rtol=1e-6)
    assert abs(aux_mask - aux_prefix) < 1e-5
    assert abs(aux_mask - aux_all) > 1e-6
    np.testing.assert_allclose(y_all, want_all, atol=TOL, rtol=0)
    np.testing.assert_allclose(y_mask, want_mask, atol=TOL, rtol=0)
    assert abs(aux_all - aux_all_j) < TOL and abs(aux_mask - aux_mask_j) < TOL


def test_switch_ffn_grouped_routing_bounds_dispatch():
    """Groups of 32 and of 128 give the same output without drops (the
    dispatch is [G, g, E, C]); a group that does not divide B*T is
    refused, as in JAX."""
    x = jnp.asarray(np.random.RandomState(3).randn(2, 64, 8), jnp.float32)
    jbig = JSwitchFFN(n_experts=4, d_model=8, d_ff=16, capacity_factor=4.0,
                      group_size=128)
    params, want, _ = _jax_ffn(jbig, x)
    small = JSwitchFFN(n_experts=4, d_model=8, d_ff=16, capacity_factor=4.0,
                       group_size=32)
    _, y_big, _ = _port_ffn(jbig, params, x)
    _, y_small, _ = _port_ffn(small, params, x)
    np.testing.assert_allclose(y_big, y_small, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y_big, want, atol=TOL, rtol=0)
    bad = JSwitchFFN(n_experts=4, d_model=8, d_ff=16, group_size=48)
    with pytest.raises(ValueError, match="must divide"):
        _port_ffn(bad, params, x)


@pytest.fixture(scope="module")
def lm_setup():
    kw = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=16, moe_experts=8)
    jlm = JTransformerLM(**kw)
    toks = np.random.RandomState(0).randint(1, 32, (4, 16)).astype(np.int32)
    toks[:, -3:] = 0                       # trailing pads
    jparams = jlm.init(jax.random.key(0), jnp.asarray(toks))["params"]
    batch = {"x": toks, "y": np.roll(toks, -1, axis=1),
             "mask": np.ones(4, np.float32)}
    return kw, jlm, jax.tree.map(np.asarray, jparams), batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_balance_loss_reaches_training(lm_setup):
    """The port's training loss equals JAX's (CE + alpha x the layers'
    load-balance sum), is larger than at alpha 0, gives router
    gradients, and evaluation ignores the term."""
    kw, jlm, jparams, batch = lm_setup
    want, _ = JNWPWorkload(jlm).loss_fn(jparams, jax.tree.map(
        jnp.asarray, batch), None, True)
    wl = NWPWorkload(TransformerLM(**kw))
    params = params_from_numpy(jparams)
    tb = _torch_batch(batch)
    loss, _ = wl.loss_fn(params, tb)
    assert abs(float(loss) - float(want)) < TOL
    loss0, _ = NWPWorkload(TransformerLM(**kw, moe_aux_weight=0.0)).loss_fn(
        params, tb)
    assert float(loss) > float(loss0)
    g = grad(lambda p: wl.loss_fn(p, tb)[0])(params)
    assert float(g["moe_0/router/kernel"].abs().max()) > 0
    ce = wl.metric_fn(params, tb)
    assert abs(float(ce["loss_sum"] / ce["total"]) - float(loss0)) < TOL


def test_moe_vmap_grad_over_clients(lm_setup):
    """vmap(grad(loss)) over a 2-client stack (as local training maps a
    cohort) equals each client's own gradient: the routing has no host
    sync or data-dependent shape."""
    kw, _, jparams, batch = lm_setup
    wl = NWPWorkload(TransformerLM(**kw))
    params = params_from_numpy(jparams)
    tb = _torch_batch(batch)
    other = {**tb, "x": torch.flip(tb["x"], dims=[0]),
             "y": torch.flip(tb["y"], dims=[0])}
    stacked = {k: torch.stack([tb[k], other[k]]) for k in tb}
    fn = grad(lambda p, b: wl.loss_fn(p, b)[0])
    both = vmap(fn, in_dims=(None, 0))(params, stacked)
    for i, b in enumerate((tb, other)):
        one = fn(params, b)
        for k in ("moe_1/w1", "moe_0/router/kernel", "tok_embed/embedding"):
            np.testing.assert_allclose(both[k][i].numpy(), one[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
