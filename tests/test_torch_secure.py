"""The port's secure aggregation (``fedml_tpu_torch/secure``) against the
JAX package's ``fedml_tpu/secure``.

* ``field.py``: the same outputs for the same ``RandomState`` (exact);
* ring budget: the same scales, refused at the same boundary;
* K3: on the CPU the port's wrapper takes the plain PyTorch version of the
  CUDA kernel; its ring values are **bit-equal** (uint32) to the Pallas
  kernel run through the interpreter, for every client of groups of 2, 5
  and 10, odd and same-shape leaves, weights that are not 1 and a
  zero-weight pad slot.  Port-masked and JAX-masked clients cancel in one
  ring sum;
* the ``torch`` backend's masks are bit-equal to the ``xla`` backend's;
* ``aggregate_stacked`` is bit-equal across packages, and its result is the
  weighted mean within N / scale * 2 (one quantum per client, twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.secure import field as j_field
from fedml_tpu.secure import secagg as j_secagg
from fedml_tpu.secure.pallas_mask import fused_quantize_mask
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.secure import field, fused_mask, secagg
from fedml_tpu_torch.secure.fused_mask import (quantize_mask,
                                               quantize_mask_plain)
from fedml_tpu_torch.secure.secagg import SecureCohortAggregator
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

SCALE, CLIP = 2.0**14, 2.0**14
JAX_BACKEND = {"cuda": "pallas", "torch": "xla"}


# ---------------------------------------------------------------------------
# field.py
# ---------------------------------------------------------------------------

def _field_cases():
    X = np.random.RandomState(1).randint(0, 2**31 - 1, (6, 5))
    return {
        "pow_mod": lambda f, rs: f.pow_mod(X, 12345, f.P_DEFAULT),
        "mod_inv": lambda f, rs: f.mod_inv(X + 1),
        "mod_div": lambda f, rs: f.mod_div(X, X[::-1] + 1),
        "prod_mod": lambda f, rs: f.prod_mod(X[0]),
        "lagrange_coeffs": lambda f, rs: f.lagrange_coeffs([3, 9, 11],
                                                           [1, 2, 5, 7]),
        "bgw": lambda f, rs: f.bgw_decode(
            f.bgw_encode(X, 5, 2, rng=rs)[[0, 2, 4]], [0, 2, 4]),
        "bgw_shares": lambda f, rs: f.bgw_encode(X, 5, 2, rng=rs),
        "lcc_encode": lambda f, rs: f.lcc_encode(X, 7, 2, 1, rng=rs),
        "lcc_roundtrip": lambda f, rs: f.lcc_decode(
            f.lcc_encode(X, 7, 3, 2, rng=rs)[[1, 3, 4, 5, 6]], 7, 3, 2,
            [1, 3, 4, 5, 6]),
        "lcc_partial": lambda f, rs: f.lcc_encode(X, 7, 2, 1, rng=rs,
                                                  worker_idx=[0, 4]),
        "lcc_with_points": lambda f, rs: f.lcc_decode_with_points(
            f.lcc_encode_with_points(X[:3], [1, 2, 3], [5, 6, 7, 8]),
            [5, 6, 7], [1, 2, 3]),
        "additive_shares": lambda f, rs: f.additive_shares(X[0], 4, rng=rs),
        "keys": lambda f, rs: np.array([
            f.pk_gen(7), f.pk_gen(7, g=3), f.key_agreement(5, 9),
            f.key_agreement(5, 9, g=2)]),
    }


@pytest.mark.parametrize("name", sorted(_field_cases()))
def test_field_matches_jax_package(name):
    case = _field_cases()[name]
    got = case(field, np.random.RandomState(3))
    want = case(j_field, np.random.RandomState(3))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_field_grids_keep_their_divergences():
    """Disjoint alpha/beta grids; decode at the first K betas."""
    alpha, beta = field._centered_points(7, 3, 2, field.P_DEFAULT)
    assert not set(alpha.tolist()) & set(beta.tolist())
    X = np.arange(12).reshape(6, 2)
    shares = field.lcc_encode(X, 7, 3, 2, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(
        field.lcc_decode(shares[2:], 7, 3, 2, list(range(2, 7))), X)


# ---------------------------------------------------------------------------
# ring budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,clip", [(1, 2.0**14), (4, 2.0**14),
                                    (5, 2.0**14), (10, 1.0), (7, 3.5),
                                    (1000, 2.0**14)])
def test_ring_budget_scale_matches(n, clip):
    assert secagg.ring_budget_scale(n, clip) == \
        j_secagg.ring_budget_scale(n, clip)


@pytest.mark.parametrize("n,clip,scale", [(4, 2.0**14, 2.0**15),
                                          (4, 2.0**14, 2.0**14),
                                          (5, 2.0**14, 2.0**14),
                                          (2, 2.0**15, 2.0**15)])
def test_validate_ring_budget_same_boundary(n, clip, scale):
    def outcome(fn):
        try:
            fn(n, clip, scale)
            return "ok"
        except ValueError as e:
            return "ring budget" in str(e)
    assert outcome(secagg.validate_ring_budget) == \
        outcome(j_secagg.validate_ring_budget)
    for bad in ((0, 1.0), (2**40, 2.0**14)):
        with pytest.raises(ValueError):
            secagg.ring_budget_scale(*bad)
        with pytest.raises(ValueError):
            j_secagg.ring_budget_scale(*bad)


# ---------------------------------------------------------------------------
# K3: fused quantize + mask
# ---------------------------------------------------------------------------

def _stacked(n, seed=0):
    """Odd leaf sizes, two same-shape leaves (a/w and c), a nested path."""
    rs = np.random.RandomState(seed)
    mk = lambda *s: (rs.randn(n, *s) * 3).astype(np.float32)
    return {"a": {"w": mk(33, 7)}, "b": mk(11), "c": mk(33, 7),
            "d": mk(257, 129)}


def _weights(n, seed=0):
    w = np.random.RandomState(seed + 1).rand(n).astype(np.float32) * 40 + 1
    w[-1] = 0.0                                     # a pad slot
    return (w / w.sum()).astype(np.float32)


def _row(stacked, i):
    return jax.tree.map(lambda x: jnp.asarray(x[i]), stacked)


def _assert_ring_equal(got, want):
    def check(a, b):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a.view(np.uint32), np.asarray(b))
    jax.tree.map(check, got, want)


@pytest.mark.parametrize("n", [2, 5, 10])
def test_k3_plain_bit_equal_to_pallas_every_client(n):
    stacked, w = _stacked(n), _weights(n)
    key = jax.random.key(11)
    agg = SecureCohortAggregator(n, clip=CLIP, backend="cuda")
    got = params_to_numpy(agg.mask_rows(params_from_numpy(stacked),
                                        torch.tensor(w), 0, prng.key(11)))
    for i in range(n):
        want = fused_quantize_mask(_row(stacked, i), w[i], i, key, n,
                                   agg.scale, CLIP, interpret=True)
        _assert_ring_equal(jax.tree.map(lambda x: x[i], got), want)
    # same-shape leaves carry distinct masks
    assert not np.array_equal(got["a"]["w"], got["c"])


def test_k3_wrapper_rows_of_one_client():
    """``mask_update`` (one row, first_client = i) is the same kernel call
    as the group's: rows of one client equal the group's row i."""
    n = 5
    stacked, w = _stacked(n), _weights(n)
    agg = SecureCohortAggregator(n, SCALE, CLIP, backend="cuda")
    group = agg.mask_rows(params_from_numpy(stacked), torch.tensor(w), 0,
                          prng.key(2))
    for i in range(n):
        one = agg.mask_update(params_from_numpy(
            jax.tree.map(lambda x: x[i], stacked)), float(w[i]), i,
            prng.key(2))
        for k in one:
            assert torch.equal(one[k], group[k][i])


def test_k3_pair_seeds_match_jax():
    from fedml_tpu.secure.pallas_mask import derive_pair_seeds
    key = jax.random.key(5)
    table = fused_mask.pair_seeds(prng.key(5), 0, 6, 6)
    for i in range(6):
        np.testing.assert_array_equal(
            table[i], np.asarray(derive_pair_seeds(key, jnp.asarray(i), 6)))
    np.testing.assert_array_equal(table[0, 2], table[2, 0])
    # the per-leaf offset wraps around int32
    big = np.array([[[2**31 - 5, -2**31]]], np.int32)
    np.testing.assert_array_equal(
        fused_mask.leaf_seeds(big, 7),
        np.asarray(jnp.asarray(big) + jnp.int32(7 * 31337)))


def test_k3_rounding_is_half_to_even():
    """Values landing exactly on .5 quanta round to even, as jnp.round."""
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.25]]) / SCALE
    q = quantize_mask_plain(x, torch.ones(1), torch.zeros(1, 1, 2,
                                                          dtype=torch.int32),
                            0, SCALE, CLIP)
    assert q.tolist() == [[0, 2, 2, 0, -2, -2, 3]]


def test_masks_cancel_across_packages():
    """Clients 0 and 2 mask in the port, 1 and 3 in the JAX package: the
    ring sum is exactly the sum of the quantized weighted updates."""
    n = 4
    stacked, w = _stacked(n, seed=4), _weights(n, seed=4)
    w[-1] = 0.3
    key = jax.random.key(0)
    agg = SecureCohortAggregator(n, SCALE, CLIP, backend="cuda")
    masked = []
    for i in range(n):
        if i % 2 == 0:
            m = params_to_numpy(agg.mask_update(
                params_from_numpy(jax.tree.map(lambda x: x[i], stacked)),
                float(w[i]), i, prng.key(0)))
            masked.append(jax.tree.map(lambda x: x.view(np.uint32), m))
        else:
            masked.append(jax.tree.map(np.asarray, fused_quantize_mask(
                _row(stacked, i), w[i], i, key, n, SCALE, CLIP,
                interpret=True)))
    ring = jax.tree.map(lambda *xs: sum(xs[1:], xs[0]), *masked)
    plain = jax.tree.map(lambda *xs: sum(xs[1:], xs[0]), *[
        jax.tree.map(np.asarray, j_secagg.quantize(jax.tree.map(
            lambda x: x * jnp.float32(w[i]), _row(stacked, i)), SCALE, CLIP))
        for i in range(n)])
    jax.tree.map(np.testing.assert_array_equal, ring, plain)
    # and a lone masked upload reveals nothing: its words are not q's
    assert np.mean(masked[0]["d"] == np.asarray(j_secagg.quantize(
        jax.tree.map(lambda x: x * jnp.float32(w[0]), _row(stacked, 0)),
        SCALE, CLIP)["d"])) < 0.01


def test_wrapper_uses_plain_only_on_cpu(monkeypatch):
    """CPU tensors take the plain version and count no launch; a tensor on
    another device never falls back to it."""
    fused_mask.reset_launch_counts()
    x, w = torch.randn(3, 10), torch.full((3,), 1 / 3)
    seeds = torch.as_tensor(fused_mask.pair_seeds(prng.key(1), 0, 3, 3))
    assert torch.equal(quantize_mask(x, w, seeds, 0, SCALE, CLIP),
                       quantize_mask_plain(x, w, seeds, 0, SCALE, CLIP))
    assert fused_mask.launch_counts["secagg_mask"] == 0
    monkeypatch.setattr(fused_mask, "quantize_mask_plain", None)
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_mask(x.to("meta"), w.to("meta"), seeds.to("meta"), 0,
                      SCALE, CLIP)


# ---------------------------------------------------------------------------
# the torch backend and the aggregator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 5])
def test_torch_backend_masks_bit_equal_to_xla(n):
    tree = {"a": {"w": np.arange(77, dtype=np.int32).reshape(11, 7)},
            "b": np.zeros(5, np.int32)}
    for i in range(n):
        want = j_secagg.pairwise_masks(jax.random.key(3), jnp.asarray(i), n,
                                       jax.tree.map(jnp.asarray, tree))
        got = params_to_numpy(secagg.pairwise_masks(
            prng.key(3), i, n, params_from_numpy(tree)))
        _assert_ring_equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_mask_update_bit_equal_to_jax(backend):
    n = 5
    stacked = _stacked(n, seed=2)
    agg = SecureCohortAggregator(n, backend=backend)
    jagg = j_secagg.SecureCohortAggregator(n, backend=JAX_BACKEND[backend])
    for i in (0, 3):
        want = jagg.mask_update(_row(stacked, i), 0.37, i, jax.random.key(8))
        got = params_to_numpy(agg.mask_update(params_from_numpy(
            jax.tree.map(lambda x: x[i], stacked)), 0.37, i, prng.key(8)))
        _assert_ring_equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_aggregate_stacked_matches_jax(backend):
    n = 5
    stacked = _stacked(n, seed=6)
    num = np.array([10.0, 30.0, 20.0, 40.0, 0.0], np.float32)
    agg = SecureCohortAggregator(n, backend=backend)
    jagg = j_secagg.SecureCohortAggregator(n, backend=JAX_BACKEND[backend])
    assert agg.scale == jagg.scale
    want = jax.tree.map(np.asarray, jagg.aggregate_stacked(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(num),
        jax.random.key(7)))
    got = params_to_numpy(agg.aggregate_stacked(
        params_from_numpy(stacked), torch.tensor(num), prng.key(7)))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    wn = num / num.sum()
    mean = jax.tree.map(lambda x: np.tensordot(wn, x, axes=1), stacked)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, atol=n / agg.scale * 2, rtol=0), got, mean)


def test_aggregator_refuses_jax_backend_names():
    for name, twin in (("xla", "torch"), ("pallas", "cuda")):
        with pytest.raises(ValueError, match=f"twin of it is '{twin}'"):
            SecureCohortAggregator(4, backend=name)
    with pytest.raises(ValueError, match="ring budget"):
        SecureCohortAggregator(4, scale=2.0**15, clip=2.0**14)
    agg = SecureCohortAggregator(4)
    with pytest.raises(ValueError, match="4-client group"):
        agg.aggregate_stacked({"w": torch.zeros(3, 2)}, torch.ones(3),
                              prng.key(0))


# ---------------------------------------------------------------------------
# K3's one launch per group: the pair salts, each pair once, the leaf table
# ---------------------------------------------------------------------------

def _jax_salts(key, n, leaf_id):
    """The JAX package's salts of every pair: derive_pair_seeds, the leaf
    shift, then fmix(s0) ^ fmix(s1 ^ 0x5BD1E995) as _mask_kernel hashes
    them."""
    from fedml_tpu.secure.pallas_mask import _murmur_fmix, derive_pair_seeds
    out = np.zeros((n, n), np.uint32)
    for i in range(n):
        seeds = derive_pair_seeds(key, jnp.asarray(i), n) + jnp.int32(
            leaf_id * 31337)
        s = seeds.astype(jnp.uint32)
        salts = np.array(_murmur_fmix(s[:, 0])
                           ^ _murmur_fmix(s[:, 1] ^ jnp.uint32(0x5BD1E995)))
        salts[i] = 0
        out[i] = salts
    return out


@pytest.mark.parametrize("n", [2, 5, 10])
def test_pair_salts_plain_bit_equal_to_jax(n):
    """Round key words -> every pair's salt for leaves 0..7, bit-equal to
    the JAX package's derivation; symmetric, 0 on the diagonal."""
    for leaf_id in range(8):
        got = fused_mask.pair_salts_plain(prng.key(13), n, leaf_id)
        want = _jax_salts(jax.random.key(13), n, leaf_id)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        assert torch.equal(got, got.T)
    assert torch.equal(fused_mask.pair_salts(prng.key(13), n, 3, "cpu"),
                       fused_mask.pair_salts_plain(prng.key(13), n, 3))


@pytest.mark.parametrize("n", [2, 5, 10])
def test_pairs_once_bit_equal_to_per_row_walk(n):
    """The kernel's each-pair-once accumulation, rendered in torch, is
    bit-equal to quantize_mask_plain for every client of the group."""
    stacked, w = _stacked(n), _weights(n)
    key = prng.key(17)
    scale = secagg.ring_budget_scale(n, CLIP)
    base = fused_mask.pair_seeds(key, 0, n, n)
    for li, k in enumerate(["b", "d"]):
        x = torch.tensor(stacked[k].reshape(n, -1))
        seeds = torch.as_tensor(fused_mask.leaf_seeds(base, li))
        want = quantize_mask_plain(x, torch.tensor(w), seeds, 0, scale, CLIP)
        got = fused_mask.quantize_mask_pairs_plain(
            x, torch.tensor(w), fused_mask.pair_salts_plain(key, n, li),
            scale, CLIP)
        assert torch.equal(got, want)


def _mask_layout(tree):
    from fedml_tpu_torch.core.pytree import tree_keys
    flat = params_from_numpy(tree)
    keys = tree_keys(flat)
    return keys, fused_mask.mask_layout(keys,
                                        [flat[k][0].numel() for k in keys])


def test_mask_layout_columns_rows_and_views():
    """Columns in leaf order at multiples of 4 (62- and 3-element leaves
    padded), the rows a call passes (x, D, column, leaf id; the kernel
    lays out its grid), and each leaf a column view of the [R, C] buffer
    in its shape."""
    tree = {"a": np.zeros((3, 62), np.float32),
            "b": np.zeros((3, 3), np.float32),
            "c": np.zeros((3, 5, 9), np.float32)}
    keys, lay = _mask_layout(tree)
    assert keys == ["a", "b", "c"]
    assert lay.offsets == [0, 64, 68] and lay.out_numel == 116
    assert lay.rows == [0, 1, 2] and lay.norm_rows == []
    xs = [torch.zeros(3, d) for d in lay.sizes]
    t = fused_mask.mask_table(lay, xs)
    assert t[:, fused_mask.X].tolist() == [x.data_ptr() for x in xs]
    assert t[:, fused_mask.D].tolist() == [62, 3, 45]
    assert t[:, fused_mask.COL].tolist() == lay.offsets
    assert t[:, fused_mask.LEAF_ID].tolist() == [0, 1, 2]
    assert t.shape == (3, 4)
    buf = torch.arange(3 * 116, dtype=torch.int32).reshape(3, 116)
    views = lay.views(buf, [(62,), (3,), (5, 9)])
    assert views[2].shape == (3, 5, 9)
    assert torch.equal(views[2].reshape(3, -1), buf[:, 68:113])
    assert views[1].data_ptr() == buf[:, 64:].data_ptr()
    assert lay.views(buf[0], [(62,), (3,), (5, 9)])[2].shape == (5, 9)


@pytest.mark.parametrize("n", [2, 5, 10])
def test_table_masking_matches_per_leaf_and_row_subsets(n):
    """quantize_mask_table (the plain leaf-by-leaf path on the CPU) is
    per-leaf quantize_mask_plain at each leaf's columns; a subset of rows
    (mask_update's one row, two rows) gives the group's rows; the one-buffer
    ring sum is ring_sum leaf by leaf."""
    stacked, w = _stacked(n), _weights(n)
    keys, lay = _mask_layout(stacked)
    flat = params_from_numpy(stacked)
    xs = [flat[k].reshape(n, -1) for k in keys]
    scale = secagg.ring_budget_scale(n, CLIP)
    key = prng.key(19)
    buf = fused_mask.quantize_mask_table(lay, xs, torch.tensor(w), key, 0,
                                         n, scale, CLIP)
    base = fused_mask.pair_seeds(key, 0, n, n)
    leaves = lay.views(buf, [(d,) for d in lay.sizes])
    for li, x in enumerate(xs):
        seeds = torch.as_tensor(fused_mask.leaf_seeds(base, li))
        assert torch.equal(leaves[li], quantize_mask_plain(
            x, torch.tensor(w), seeds, 0, scale, CLIP))
    for first, rows in ((n - 1, 1), (0, 1), (n // 2, min(2, n - n // 2))):
        part = fused_mask.quantize_mask_table(
            lay, [x[first:first + rows] for x in xs],
            torch.tensor(w[first:first + rows]), key, first, n, scale, CLIP)
        assert torch.equal(part, buf[first:first + rows])
    one = secagg.ring_sum({"": buf})[""]
    per_leaf = secagg.ring_sum(dict(zip(keys, leaves)))
    for k, v in zip(keys, lay.views(one, [(d,) for d in lay.sizes])):
        assert torch.equal(v, per_leaf[k])


def test_table_masking_dispatches_on_the_leaves_device(monkeypatch):
    """The table wrapper takes the plain version for CPU leaves only: a
    leaf on another device gets the kernel or an exception, whatever
    device the weights are on, and never the plain version."""
    keys, lay = _mask_layout({"a": np.zeros((3, 62), np.float32),
                              "b": np.zeros((3, 3), np.float32)})
    xs = [torch.zeros(3, d, device="meta") for d in lay.sizes]
    monkeypatch.setattr(fused_mask, "quantize_mask_plain", None)
    for w in (torch.full((3,), 1 / 3), torch.full((3,), 1 / 3,
                                                  device="meta")):
        with pytest.raises(ValueError, match="unsupported device meta"):
            fused_mask.quantize_mask_table(lay, xs, w, prng.key(1), 0, 3,
                                           SCALE, CLIP)


def test_mask_flat_is_the_cuda_backends_only():
    """mask_flat is the cuda backend's one-buffer masking; the torch
    backend (threefry masks) refuses it rather than mixing streams."""
    stacked = params_from_numpy(_stacked(2))
    w = torch.tensor(_weights(2))
    with pytest.raises(ValueError, match="cuda backend"):
        SecureCohortAggregator(2, backend="torch").mask_flat(
            stacked, w, 0, prng.key(2))
    buf, lay = SecureCohortAggregator(2, backend="cuda").mask_flat(
        stacked, w, 0, prng.key(2))
    assert buf.shape == (2, lay.out_numel) and buf.dtype == torch.int32
