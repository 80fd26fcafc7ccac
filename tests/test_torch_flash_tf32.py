"""The arithmetic of the tensor-core flash kernels (K4f, K4dkv and K4dq in
``fedml_tpu_torch/csrc/flash_attention.cu``), emulated on the CPU and held
to JAX's Pallas library flash attention.

The kernels split each f32 operand a into hi = tf32(a) (``cvt.rna``) and
lo = a - hi truncated to TF32, and take a product as lo*hi + hi*lo + hi*hi
into an f32 accumulator.  Here torch does the same on the CPU:
``cvt.rna.tf32.f32`` is integer rounding of the f32 bits, ``(bits +
0x1000) & ~0x1FFF``, the truncation ``bits & ~0x1FFF``, and a
product is three f32 matmuls of the pieces (a product of two TF32 values is
exact in f32).  The forward walks 64-key tiles with the kernel's online
softmax; dK/dV and dQ recompute P from the emulated forward's m and l as
the kernels do.  The library runs under ``force_tpu_interpret_mode()``, as
its own tests run it, at B=1, H=2, d=32, T=128 and 256, on unit-normal
inputs drawn by numpy from a seed.  The limits are ``chip_smoke.py``'s for
the kernels on the card: o, m and l within 1e-5 x max|ref|; dk, dv and dq
within 1e-4 x max|ref|.  One TF32 pass misses the forward's limit by far:
that is why the kernels split.

This is the ideal 3xTF32 scheme, not the kernels' exact arithmetic: here
each 64-key tile is one matmul summed round-to-nearest, where the kernels
sum 32-key (K4f), 16-query (K4dkv) or 16-key (K4dq) parts in the tensor
cores' own accumulation.  Their fragment indices and that accumulation are checked on
the card, where ``chip_smoke.py`` holds the kernels to the plain versions.

``python tests/test_torch_flash_tf32.py`` prints the emulations' errors
against the library for one and three passes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib

D = 32
TILE = 64                      # the kernels' tile rows
O_TOL = 1e-5                   # x max|ref|: o, m, l (chip_smoke.py)
GRAD_TOL = 1e-4                # x max|ref|: dk, dv, dq


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, ties away from
    zero, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """hi = tf32(x); lo = x - hi (exact) with its low 13 bits cleared."""
    hi = tf32(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 passes (lo*hi, hi*lo,
    hi*hi) or, for comparison, one (hi*hi)."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def fwd_emulated(q, k, v, passes):
    """K4f's walk over [BH, T, d]: per 64-row query tile, key tiles
    0..diagonal, S = Q K^T * scale, the online softmax, O += P V, then
    o = acc / l; returns o, m, l."""
    bh, t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    m_out = torch.empty(bh, t)
    l_out = torch.empty(bh, t)
    causal = torch.ones(TILE, TILE, dtype=torch.bool).tril()
    for qt in range(t // TILE):
        rows = slice(qt * TILE, (qt + 1) * TILE)
        m = torch.full((bh, TILE), -math.inf)
        l = torch.zeros(bh, TILE)
        acc = torch.zeros(bh, TILE, d)
        for kt in range(qt + 1):
            keys = slice(kt * TILE, (kt + 1) * TILE)
            s = mm(q[:, rows], k[:, keys].transpose(1, 2), passes) * scale
            if kt == qt:
                s = torch.where(causal, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            l, acc, m = l * corr, acc * corr[..., None], m_new
            p = torch.exp(s - m[..., None])
            l = l + p.sum(-1)
            acc = acc + mm(p, v[:, keys], passes)
        o[:, rows] = acc / l[..., None]
        m_out[:, rows], l_out[:, rows] = m, l
    return o, m_out, l_out


def dkv_emulated(q, k, v, do, m, l, di, passes):
    """K4dkv's sums over [BH, T, d]: S^T = K Q^T, P^T = exp(S^T * scale -
    m) * (1/l) with the pairs above the diagonal zero, dP^T = V dO^T,
    dS^T = P^T (dP^T - di) scale; dV = P^T dO, dK = dS^T Q."""
    t, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    st = mm(k, q.transpose(1, 2), passes)               # [BH, key, query]
    p = torch.exp(st * scale - m[:, None, :]) * (1.0 / l)[:, None, :]
    p = torch.where(torch.ones(t, t, dtype=torch.bool).triu(), p, 0.0)
    dp = mm(v, do.transpose(1, 2), passes)
    ds = p * (dp - di[:, None, :]) * scale
    return mm(ds, q, passes), mm(p, do, passes)


def dq_emulated(q, k, v, do, m, l, di, passes):
    """K4dq's sums over [BH, T, d]: S = Q K^T, P = exp(S * scale - m) *
    (1/l), dP = dO V^T, dS = P (dP - di) scale with the pairs above the
    diagonal zero; dQ = dS K."""
    t, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = mm(q, k.transpose(1, 2), passes)                # [BH, query, key]
    p = torch.exp(s * scale - m[..., None]) * (1.0 / l)[..., None]
    dp = mm(do, v.transpose(1, 2), passes)
    ds = torch.where(torch.ones(t, t, dtype=torch.bool).tril(),
                     p * (dp - di[..., None]) * scale, 0.0)
    return mm(ds, k, passes)


def _library(q, k, v, do):
    """The interpret-mode library: (o, m, l) from its forward with
    residuals, and (dq, dk, dv) from jax.vjp of its public entry."""
    b, h, t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    blocks = lib.BlockSizes.get_default(b, h, t, t, d)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    fn = lambda q, k, v: lib.flash_attention(q, k, v, causal=True,
                                             sm_scale=scale)
    with pltpu.force_tpu_interpret_mode():
        o, l, m = lib._flash_attention(qj, kj, vj, None, None, True, True,
                                       scale, blocks, False)
        _, vjp = jax.vjp(fn, qj, kj, vj)
        dq, dk, dv = vjp(jnp.asarray(do))
    return {n: np.asarray(x).reshape(b * h, *x.shape[2:])
            for n, x in dict(o=o, m=m, l=l, dk=dk, dv=dv, dq=dq).items()}


def make_case(t):
    rng = np.random.RandomState(1000 + t)
    q, k, v, do = (rng.randn(1, 2, t, D).astype(np.float32)
                   for _ in range(4))
    return dict(ref=_library(q, k, v, do),
                inputs=[torch.tensor(x.reshape(2, t, D))
                        for x in (q, k, v, do)])


@pytest.fixture(scope="module", params=[128, 256])
def case(request):
    return make_case(request.param)


def emulate(case, passes):
    """The kernels' chain as the transformer runs it: K4f, di = sum(o dO)
    in torch, then K4dkv and K4dq on the forward's m and l."""
    q, k, v, do = case["inputs"]
    o, m, l = fwd_emulated(q, k, v, passes)
    di = (o * do).sum(-1)
    dk, dv = dkv_emulated(q, k, v, do, m, l, di, passes)
    return dict(o=o, m=m, l=l, dk=dk, dv=dv,
                dq=dq_emulated(q, k, v, do, m, l, di, passes))


def rel_errors(case, passes):
    """max|emulated - library| / max|library| for each output."""
    got = emulate(case, passes)
    return {n: float(np.abs(got[n].numpy() - ref).max() / np.abs(ref).max())
            for n, ref in case["ref"].items()}


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero; below half an ulp of TF32 rounds off;
    the low 13 bits are clear; hi + lo is x within 2^-22 relative."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + ulp * 1.5, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.tensor(np.random.RandomState(0).randn(4096)
                     .astype(np.float32))
    hi, lo = split(y)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22


def test_split_keeps_a_nan_in_lo():
    """The rounding's add carries a NaN's payload out of the mantissa
    (0x7FFFFFFF becomes -0, 0x7F800001 inf), but lo = x - hi is a NaN and
    stays one under the mask: a NaN operand makes a NaN product."""
    x = torch.tensor([0x7FFFFFFF, 0x7FC00000, 0x7F800001],
                     dtype=torch.int32).view(torch.float32)
    hi, lo = split(x)
    assert hi.view(torch.int32).tolist() == [-2 ** 31, 0x7FC00000,
                                             0x7F800000]
    assert lo.isnan().all()
    assert (lo * 1.0 + hi * 1.0).isnan().all()


def test_three_pass_forward_within_chip_limits(case):
    errs = rel_errors(case, passes=3)
    for name in ("o", "m", "l"):
        assert errs[name] <= O_TOL, (name, errs[name])


def test_three_pass_dkv_within_chip_limits(case):
    errs = rel_errors(case, passes=3)
    for name in ("dk", "dv"):
        assert errs[name] <= GRAD_TOL, (name, errs[name])


def test_three_pass_dq_within_chip_limits(case):
    assert rel_errors(case, passes=3)["dq"] <= GRAD_TOL


def test_one_pass_forward_misses_the_limit(case):
    """One TF32 pass (10 mantissa bits) puts o far outside 1e-5 x
    max|ref|: the reason for the split."""
    assert rel_errors(case, passes=1)["o"] > 10 * O_TOL


if __name__ == "__main__":
    OUTPUTS = ("o", "m", "l", "dk", "dv", "dq")
    print(f"{'T':>5} {'passes':>6} " + " ".join(
        f"{n:>10}" for n in OUTPUTS))
    for t in (128, 256):
        c = make_case(t)
        for passes in (1, 3):
            e = rel_errors(c, passes)
            print(f"{t:>5} {passes:>6} " + " ".join(
                f"{e[n]:10.3e}" for n in OUTPUTS))
