"""K4 at bf16: the port's plain bf16 flash halves against the JAX
library's Pallas flash attention on bf16 inputs.

Under ``--compute_dtype bfloat16`` the JAX transformer hands the library
bf16 q, k and v; the library multiplies bf16 x bf16 into f32 and rounds P,
P^T and dS to bf16 before their products.  The library runs on the CPU
under ``force_tpu_interpret_mode()``; the port's plain bf16 versions (what
the ``_bf16`` CUDA kernels compute, the path a CPU tensor takes) are held
to it at B=1, H=2, d=32, T=128 and 256, on numpy-seeded unit-normal
inputs rounded to bf16.  Limit: 2^-7 x max|ref| on o, dq, dk and dv (two
bf16 ulps at the top of the range: the library rounds P against the
running max of its 128-key block, the plain version against the row's
final max, and sums in another order); m and l are f32 and within 1e-5
relative of numpy's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as pallas_flash)
from torch.func import grad, vmap

from fedml_tpu_torch.models import flash_attention as fa

D = 32
TOL = 2.0 ** -7          # x max|ref|


def _inputs(t, seed, b=1, h=2, d=D):
    """q, k, v, dO as bf16-representable f32 numpy [B, H, T, d]."""
    rng = np.random.RandomState(seed)
    return [np.asarray(jnp.asarray(rng.randn(b, h, t, d), jnp.bfloat16)
                       .astype(jnp.float32)) for _ in range(4)]


def _library(q, k, v, do):
    fn = lambda q, k, v: pallas_flash(q, k, v, causal=True,
                                      sm_scale=1.0 / np.sqrt(q.shape[-1]))
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(fn, bf(q), bf(k), bf(v))
        grads = vjp(bf(do))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    assert o.dtype == jnp.bfloat16 and grads[0].dtype == jnp.bfloat16
    return f32(o), [f32(g) for g in grads]


@pytest.fixture(scope="module", params=[128, 256])
def case(request):
    t = request.param
    q, k, v, do = _inputs(t, seed=100 + t)
    o, grads = _library(q, k, v, do)
    return dict(t=t, q=q, k=k, v=v, do=do, o=o, dq=grads[0], dk=grads[1],
                dv=grads[2])


def _bf16(x):
    return torch.tensor(x).to(torch.bfloat16)


def _plain(case):
    q, k, v, do = (_bf16(case[n]) for n in ("q", "k", "v", "do"))
    o, m, l = fa.flash_fwd(q, k, v)            # CPU tensors: the plain path
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, m, l, di)
    dq = fa.flash_bwd_dq(q, k, v, do, m, l, di)
    return dict(o=o, m=m, l=l, dq=dq, dk=dk, dv=dv)


def _close(got, want, name):
    assert got.dtype == torch.bfloat16, (name, got.dtype)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (name, err, np.abs(want).max())


def test_plain_bf16_forward_matches_pallas(case):
    got = _plain(case)
    _close(got["o"], case["o"], "o")
    s = np.einsum("bhqd,bhkd->bhqk", case["q"].astype(np.float64),
                  case["k"]) / np.sqrt(D)
    s = np.where(np.tri(case["t"], dtype=bool), s, -np.inf)
    m = s.max(-1)
    assert got["m"].dtype == got["l"].dtype == torch.float32
    np.testing.assert_allclose(got["m"].numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["l"].numpy(),
                               np.exp(s - m[..., None]).sum(-1), rtol=1e-5)


def test_plain_bf16_backward_matches_pallas_grad(case):
    got = _plain(case)
    for name in ("dq", "dk", "dv"):
        _close(got[name], case[name], name)


def test_bf16_rounding_points_matter():
    """The roundings of P and dS are what the library computes: at T=256
    (two 128-key blocks, the library's multi-step form, which rounds P
    before normalising as the kernels do) the plain bf16 halves are closer
    to the library, in RMS over every element of o, dq, dk and dv, than
    the f32 halves rounded once on output, by at least 2x.  (At T=128 the
    library's single-step form rounds the normalised P instead; both stay
    within the limit above.)"""
    t = 256
    q, k, v, do = _inputs(t, seed=100 + t)
    o, grads = _library(q, k, v, do)
    case = dict(t=t, q=q, k=k, v=v, do=do, o=o, dq=grads[0], dk=grads[1],
                dv=grads[2])
    got = _plain(case)
    qf, kf, vf, dof = (_bf16(case[n]).float() for n in ("q", "k", "v", "do"))
    of, m, l = fa.flash_fwd_plain(qf, kf, vf)
    di = (of * dof).sum(-1)
    dk, dv = fa.flash_bwd_dkv_plain(qf, kf, vf, dof, m, l, di)
    dq = fa.flash_bwd_dq_plain(qf, kf, vf, dof, m, l, di)
    once = dict(o=of, dq=dq, dk=dk, dv=dv)
    rms = lambda x, n: np.sqrt(np.mean(
        (x.to(torch.bfloat16).float().numpy() - case[n]) ** 2))
    for n in ("o", "dq", "dk", "dv"):
        assert rms(got[n], n) < 0.5 * rms(once[n], n), n


LOG2E = np.float32(1.4426950408889634)      # kLog2e, an f32
KEY_TILE = 64                               # keys a tile of the bf16 K4dq


def _f32(x):
    """f64 values rounded to f32 (to nearest even), kept as f64."""
    return x.astype(np.float32).astype(np.float64)


def _dq_in_kernel_order(q, k, v, do, m, l, di):
    """dq of one [T, d] head as the bf16 K4dq orders its arithmetic: per
    64-key tile, S = Q K^T and dP = dO V^T in f32 (exact bf16 products,
    summed in f64 and rounded once); P scale = 2^fmaf(s, scale log2 e,
    -m log2 e + log2(scale / l)), the row's term taken once a row in f32,
    the fmaf in f64 rounded to f32, ex2 exact and then rounded; dS =
    fmaf(P scale, dP, -(P scale) di) likewise, set to 0 above the diagonal
    and rounded to bf16 pair by pair; the tile's dS K rounded to f32 and
    added to dQ in f32; dQ rounded to bf16 once."""
    t, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    sl2 = _f32(np.float64(scale) * np.float64(LOG2E))
    row = _f32(_f32(-m.astype(np.float64) * np.float64(LOG2E))
               + _f32(np.log2(_f32(np.float64(scale) / l.astype(np.float64)))))
    nl, dd = row[:, None], di.astype(np.float64)[:, None]
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    dq = np.zeros((t, d), np.float64)
    rows = np.arange(t)[:, None]
    for c0 in range(0, t, KEY_TILE):
        keys = slice(c0, c0 + KEY_TILE)
        s = _f32(q @ k[keys].T)
        dp = _f32(do @ v[keys].T)
        ps = _f32(np.exp2(_f32(s * sl2 + nl)))
        ds = _f32(ps * dp - _f32(ps * dd))
        ds = np.where(c0 + np.arange(KEY_TILE)[None, :] > rows, 0.0, ds)
        ds = torch.tensor(ds).to(torch.bfloat16).double().numpy()
        dq = _f32(dq + _f32(ds @ k[keys]))
    return torch.tensor(dq).to(torch.bfloat16).float().numpy()


def test_dq_in_kernel_order_matches_pallas(case):
    """The bf16 K4dq's rounding points, emulated on the CPU (the kernel
    runs only on the card): dq in its order, on the plain forward's m and
    l and di = sum(o dO), is held to the interpret-mode library within
    2^-7 x max|ref|, as the plain version is, and to the plain version
    within the same limit."""
    got = _plain(case)
    m, l = got["m"].numpy(), got["l"].numpy()
    di = (got["o"].float() * _bf16(case["do"]).float()).sum(-1).numpy()
    emulated = np.stack([np.stack([
        _dq_in_kernel_order(case["q"][b, h], case["k"][b, h],
                            case["v"][b, h], case["do"][b, h], m[b, h],
                            l[b, h], di[b, h])
        for h in range(case["q"].shape[1])])
        for b in range(case["q"].shape[0])])
    ref = case["dq"]
    limit = TOL * np.abs(ref).max()
    plain = got["dq"].float().numpy()
    err = {"emulated": np.abs(emulated - ref).max(),
           "plain": np.abs(plain - ref).max()}
    assert err["emulated"] <= limit and err["plain"] <= limit, (err, limit)
    assert np.abs(emulated - plain).max() <= limit, (err, limit)


def test_autograd_bf16_grads_are_bf16_and_match_halves(case):
    """flash_attention on bf16 [B, T, H, d] CPU tensors: bf16 output and
    gradients equal to the plain halves fed di = sum(o * dO) in f32, under
    vmap(grad) as local training runs it."""
    tr = lambda x: _bf16(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    q, k, v, do = (tr(case[n]) for n in ("q", "k", "v", "do"))

    def loss(q, k, v, do):
        return (fa.flash_attention(q, k, v).float() * do.float()).sum()

    g = vmap(grad(loss, argnums=(0, 1, 2)))(*(x[None] for x in
                                               (q, k, v, do)))
    want = _plain(case)
    for got, name in zip(g, ("dq", "dk", "dv")):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[0].transpose(1, 2).float().numpy(),
            want[name].float().numpy(), err_msg=name)


def test_mixed_dtypes_refused():
    """The kernels' check takes q, k, v (and dO) all f32 or all bf16 with
    m, l, di f32, and refuses a mixed set; launches count per kernel and
    dtype."""
    bf = torch.zeros(1, 1, 128, 32, dtype=torch.bfloat16)
    f32 = bf.float()
    vec = torch.zeros(1, 1, 128)
    fa.check_dtypes("flash_fwd_bf16", bf, (bf, bf), ())
    fa.check_dtypes("flash_bwd_dq", f32, (f32, f32, f32), (vec,) * 3)
    for q, rows, vecs in ((bf, (f32, bf), ()), (f32, (bf, f32), ()),
                          (bf, (bf, bf, bf), (vec, vec.to(bf.dtype), vec)),
                          (bf.half(), (bf.half(),) * 2, ())):
        with pytest.raises(ValueError):
            fa.check_dtypes("k4", q, rows, vecs)
    assert set(fa.launch_counts) == {
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_bf16",
        "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"}
