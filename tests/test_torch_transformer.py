"""The port's TransformerLM against flax's, on carried weights.

Parameter paths, shapes and leaf order equal flax's ``init``; the logits
of every attention branch (dense, ``block_size``, auto-blockwise, and the
flash path, whose plain version the CPU runs) equal the JAX model's
within 1e-5 (f32 sums in another order); the model is causal; and the
parts not ported yet are refused by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import TransformerLM as JTransformerLM
from fedml_tpu_torch.models import TransformerLM
from fedml_tpu_torch.models.transformer import init_decode_cache
from fedml_tpu_torch.trainer.workload import NWPWorkload, apply_model
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

SMALL = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=256)
LOGIT_TOL = 1e-5


def _tokens(b, t, vocab=40, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def _carry(jkw, tkw, x, seed=1):
    """Init the JAX model, carry its weights, return (port logits, JAX
    logits)."""
    jm = JTransformerLM(**jkw)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = apply_model(TransformerLM(**tkw), tp, torch.tensor(x))
    return got.numpy(), want


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_param_paths_shapes_and_order_equal_flax(n_layers):
    kw = dict(SMALL, n_layers=n_layers)
    jp = JTransformerLM(**kw).init(jax.random.key(0),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    ref = params_from_numpy(jax.tree.map(np.asarray, jp))
    p = NWPWorkload(TransformerLM(**kw)).init(torch.Generator().manual_seed(0))
    assert list(p) == list(ref)
    for k in p:
        assert p[k].shape == ref[k].shape and p[k].dtype == ref[k].dtype, k
    assert p["attn_0/query/kernel"].shape == (32, 2, 16)
    assert p["attn_0/out/kernel"].shape == (2, 16, 32)
    assert f"LayerNorm_{2 * n_layers}/scale" in p
    tree = params_to_numpy(p)
    assert tree["attn_0"]["key"]["bias"].shape == (2, 16)
    # the carry is a renaming: the 3-D attention kernels round-trip
    jax.tree.map(np.testing.assert_array_equal,
                 params_to_numpy(params_from_numpy(jp)),
                 jax.tree.map(np.asarray, jp))


def test_port_init_follows_flax_defaults():
    """LeCun-normal kernels over the contracted axes, N(0, 1/d_model)
    embeddings, unit norms, zero biases; one seed, one init."""
    wl = NWPWorkload(TransformerLM(**dict(SMALL, d_model=64, d_ff=128)))
    p = wl.init(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(p["attn_0/out/kernel"].std()),
                               np.sqrt(1 / 64), rtol=0.05)
    np.testing.assert_allclose(float(p["pos_embed/embedding"].std()),
                               np.sqrt(1 / 64), rtol=0.05)
    assert float(p["LayerNorm_1/scale"].min()) == 1.0
    assert float(p["attn_1/value/bias"].abs().sum()) == 0.0
    again = wl.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("branch,t,jkw,tkw", [
    ("dense", 16, {}, {}),
    ("block_size", 16, dict(block_size=4), dict(block_size=4)),
    # T=640 > auto_block_len=512: _auto_block picks 320, two key blocks
    ("auto_block", 640, dict(auto_block_len=512, max_len=640),
     dict(auto_block_len=512, max_len=640)),
    # the JAX flash path needs a TPU; the port's runs its plain version
    # and is held to the JAX model's dense path
    ("flash", 128, {}, dict(use_flash=True)),
])
def test_logits_match_jax(branch, t, jkw, tkw):
    x = _tokens(2, t)
    got, want = _carry(dict(SMALL, **jkw), dict(SMALL, **tkw), x)
    assert got.shape == want.shape == (2, t, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("tkw", [{}, dict(block_size=32),
                                 dict(use_flash=True)])
def test_causal(tkw):
    """Changing the tokens after position 63 leaves logits 0..63 as they
    were, and changes the later ones."""
    model = TransformerLM(**dict(SMALL, **tkw))
    params = NWPWorkload(model).init(torch.Generator().manual_seed(2))
    x = torch.tensor(_tokens(1, 128))
    y = x.clone()
    y[:, 64:] = (y[:, 64:] + 1) % SMALL["vocab_size"]
    with torch.no_grad():
        a, b = apply_model(model, params, x), apply_model(model, params, y)
    torch.testing.assert_close(a[:, :64], b[:, :64], atol=0, rtol=0)
    assert float((a[:, 64:] - b[:, 64:]).abs().max()) > 1e-3


def test_refusals_are_named():
    # the Switch MoE FFN and mixed precision are ported (not refused):
    # the MoE layers replace the MLP's Dense pair under flax's names
    names = dict(TransformerLM(**SMALL, moe_experts=4).named_parameters())
    assert "moe_0.w1" in names and not any(k.startswith("Dense_")
                                           for k in names)
    assert TransformerLM(**SMALL, dropout_rate=0.1).stochastic
    model = TransformerLM(**SMALL)
    x = torch.tensor(_tokens(1, 8))
    # incremental decode is ported (tests/test_torch_decode.py): a cache
    # without positions is refused in JAX's words
    cache = init_decode_cache(model, 2, 16)
    assert cache["attn_0"]["k"].shape == (2, 16, 2, 16)
    with pytest.raises(ValueError, match="positions"):
        model(x[:, :2].reshape(-1), cache=cache)
    # a ring of one rank is the dense forward, bit for bit
    from fedml_tpu_torch.parallel.ring_attention import make_sequence_mesh
    NWPWorkload(model).init(torch.Generator().manual_seed(0))
    ring = make_sequence_mesh(1, device="cpu").axis("sequence")
    assert torch.equal(model(x, ring_axis=ring), model(x))
    with pytest.raises(ValueError, match="compute_dtype"):
        NWPWorkload(model, compute_dtype="int32")
