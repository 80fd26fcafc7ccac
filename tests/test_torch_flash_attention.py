"""K4, the port's flash attention, against the JAX library's Pallas flash
attention and the dense path.

The library's kernels (forward, dK/dV and dQ) run on the CPU under
``force_tpu_interpret_mode()``, as JAX's own tests of that library run
them; the port's plain versions (what the CUDA kernels compute, the path a
CPU tensor takes) are held to them at B=1, H=2, d=32, T=128 and 256.
Inputs are unit-normal, drawn by numpy from a seed.  Tolerances: 2e-5 abs
on the outputs and 5e-5 abs on the gradients, f32 sums taken in another
order over up to 256 keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as pallas_flash)
from torch.func import grad, vmap

from fedml_tpu.parallel.ring_attention import full_attention as j_full
from fedml_tpu_torch.models import flash_attention as fa
from fedml_tpu_torch.parallel.ring_attention import full_attention

D = 32
OUT_TOL = 2e-5
GRAD_TOL = 5e-5


def _inputs(t, seed, b=1, h=2, d=D):
    """q, k, v, dO as numpy [B, H, T, d] (the library's layout)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(4)]


def _library(q, k, v, do):
    """The interpret-mode library kernel: o and (dq, dk, dv) = vjp(dO)."""
    fn = lambda q, k, v: pallas_flash(q, k, v, causal=True,
                                      sm_scale=1.0 / np.sqrt(q.shape[-1]))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[128, 256])
def case(request):
    t = request.param
    q, k, v, do = _inputs(t, seed=t)
    o, grads = _library(q, k, v, do)
    return dict(t=t, q=q, k=k, v=v, do=do, o=o, dq=grads[0], dk=grads[1],
                dv=grads[2])


def _plain(case):
    q, k, v, do = (torch.tensor(case[n]) for n in ("q", "k", "v", "do"))
    o, m, l = fa.flash_fwd_plain(q, k, v)
    di = (o * do).sum(-1)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, m, l, di)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, m, l, di)
    return dict(o=o, m=m, l=l, dq=dq, dk=dk, dv=dv)


def test_plain_forward_matches_pallas(case):
    got = _plain(case)
    np.testing.assert_allclose(got["o"].numpy(), case["o"], atol=OUT_TOL,
                               rtol=0)
    # m is the row max of the visible scaled scores, l = sum exp(s - m)
    s = np.einsum("bhqd,bhkd->bhqk", case["q"], case["k"]) / np.sqrt(D)
    s = np.where(np.tri(case["t"], dtype=bool), s, -np.inf)
    m = s.max(-1)
    np.testing.assert_allclose(got["m"].numpy(), m, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["l"].numpy(),
                               np.exp(s - m[..., None]).sum(-1), rtol=1e-5)


def test_plain_backward_matches_pallas_grad(case):
    """The plain dK/dV and dQ halves, fed m, l and di as the kernels are,
    against jax.vjp of the interpret-mode library kernel."""
    got = _plain(case)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name].numpy(), case[name],
                                   atol=GRAD_TOL, rtol=0, err_msg=name)


def _jax_dense(q, k, v, do):
    """The JAX package's dense path on [B, T, H, d]: o and vjp(dO)."""
    pos = jnp.arange(q.shape[1])
    fn = lambda q, k, v: j_full(q, k, v, pos, pos)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def test_flash_attention_matches_dense_paths(case):
    """The port's flash_attention ([B, T, H, d], autograd through the
    plain kernels' versions) against the port's and the JAX package's
    full_attention, values and gradients."""
    tr = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    q, k, v, do = (tr(case[n]) for n in ("q", "k", "v", "do"))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv)
    o.backward(torch.tensor(do))
    pos = torch.arange(case["t"])
    dense = full_attention(*(torch.tensor(x) for x in (q, k, v)), pos, pos)
    np.testing.assert_allclose(o.detach().numpy(), dense.numpy(),
                               atol=OUT_TOL, rtol=0)
    j_o, j_grads = _jax_dense(q, k, v, do)
    np.testing.assert_allclose(o.detach().numpy(), j_o, atol=OUT_TOL, rtol=0)
    for g, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL, rtol=0)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Record what each kernel's plain version receives (what the CUDA
    kernel would): the leading axis and whether any input is still a
    functorch wrapper (a ctypes launch needs real data pointers)."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    calls = []
    for name in ("flash_fwd_plain", "flash_bwd_dkv_plain",
                 "flash_bwd_dq_plain"):
        orig = getattr(fa, name)

        def spy(*args, _orig=orig, _name=name):
            calls.append((_name, args[0].shape[0],
                          any(is_functorch_wrapped_tensor(a) for a in args),
                          all(a.is_contiguous() for a in args)))
            return _orig(*args)
        monkeypatch.setattr(fa, name, spy)
    return calls


@pytest.mark.parametrize("k_mapped", [True, False])
def test_vmap_grad_wiring_equals_dense_autograd(kernel_calls, k_mapped):
    """torch.func.vmap(torch.func.grad(...)) through flash_attention, as
    local training runs it over a cohort, equals the same transform of the
    dense plain path; each kernel runs once for the whole cohort, on plain
    contiguous tensors with the client axis folded into B."""
    rng = np.random.RandomState(3)
    n, b, t, h = 3, 2, 128, 2
    q, v = (torch.tensor(rng.randn(n, b, t, h, D).astype(np.float32))
            for _ in range(2))
    k = torch.tensor(rng.randn(*((n,) if k_mapped else ()), b, t, h, D)
                     .astype(np.float32))
    w = torch.tensor(rng.randn(b, t, h, D).astype(np.float32))
    pos = torch.arange(t)

    def loss(attn):
        return lambda q, k, v: (attn(q, k, v) * w).square().sum()

    in_dims = (0, 0 if k_mapped else None, 0)
    got = vmap(grad(loss(fa.flash_attention), argnums=(0, 1, 2)),
               in_dims=in_dims)(q, k, v)
    want = vmap(grad(loss(lambda q, k, v: full_attention(q, k, v, pos, pos)),
                     argnums=(0, 1, 2)), in_dims=in_dims)(q, k, v)
    for g, ref in zip(got, want):
        torch.testing.assert_close(g, ref, atol=GRAD_TOL, rtol=0)
    assert [c[0] for c in kernel_calls] == ["flash_fwd_plain",
                                            "flash_bwd_dkv_plain",
                                            "flash_bwd_dq_plain"]
    assert all(c[1] == n * b and not c[2] and c[3] for c in kernel_calls)


def test_no_grad_runs_the_forward_only(kernel_calls):
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(2, 128, 2, D).astype(np.float32))
               for _ in range(3))
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert [c[0] for c in kernel_calls] == ["flash_fwd_plain"]


def _library_error(t, d=D):
    z = jnp.zeros((1, 1, t, d), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(ValueError) as err:
            pallas_flash(z, z, z, causal=True)
    return str(err.value)


@pytest.mark.parametrize("t", [80, 200])
def test_shape_refusals_match_the_library(t):
    """T=80 (below the 128 block) and T=200 (not a multiple of it) are
    refused with the library's own message."""
    z = torch.zeros(1, t, 1, D)
    with pytest.raises(ValueError) as err:
        fa.flash_attention(z, z, z)
    assert str(err.value) == _library_error(t)


def test_d160_at_t128_is_accepted_as_the_library_accepts_it():
    q, k, v, _ = _inputs(128, seed=5, h=1, d=160)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_flash(*(jnp.asarray(x) for x in (q, k, v)),
                            causal=True, sm_scale=1.0 / np.sqrt(160))
    tr = lambda x: torch.tensor(x).transpose(1, 2)
    got = fa.flash_attention(tr(q), tr(k), tr(v)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL,
                               rtol=0)


def test_wrappers_never_fall_back_and_count_only_launches():
    """A tensor on neither the CPU nor a CUDA device is refused, not
    computed by the plain version; CPU calls launch nothing."""
    fa.reset_launch_counts()
    q = torch.zeros(1, 1, 128, D, device="meta")
    vec = torch.zeros(1, 1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_dkv(q, q, q, q, vec, vec, vec)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_bwd_dq(q, q, q, q, vec, vec, vec)
    z = torch.zeros(1, 1, 128, D)
    fa.flash_fwd(z, z, z)
    assert all(n == 0 for n in fa.launch_counts.values())
