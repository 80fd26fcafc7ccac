"""The port's fused robust aggregate (``fedml_tpu_torch/core/fused_agg.py``)
against the JAX package's Pallas kernel run through the interpreter.

On the CPU the port's wrapper takes the plain PyTorch version of the CUDA
kernel, so these tests hold that arithmetic to the Pallas kernel's:

* sigma = 0: equal to the interpret-mode kernel within 2e-5 (f32 sums in
  another order);
* sigma > 0, same seed words: the noise uniforms are bit-equal to JAX's
  ``_murmur_fmix`` / ``_gaussian_from_index`` internals; the Gaussians
  agree within 1e-5 relative + 1e-6 absolute (a few ulps of log / cos /
  sqrt, which XLA and PyTorch implement differently), and so does the
  aggregate, within 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.pallas_agg import (_gaussian_from_index, _murmur_fmix,
                                       make_fused_robust_aggregate as j_fused)
from fedml_tpu.core.pytree import tree_weighted_mean as j_mean
from fedml_tpu.core.robust import clip_update as j_clip
from fedml_tpu_torch.core import fused_agg
from fedml_tpu_torch.core.fused_agg import (
    MAX_CLIENTS, make_fused_robust_aggregate as t_fused, noise_uniforms,
    robust_agg, robust_agg_plain)
from fedml_tpu_torch.core.pytree import tree_weighted_mean as t_mean
from fedml_tpu_torch.core.robust import (add_gaussian_noise, clip_update,
                                         default_is_weight_param)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

W = np.array([4.0, 1.0, 0.0, 2.5, 3.0, 1.5], np.float32)  # incl. a pad slot


def _stacked_params(rng, n=6):
    """test_pallas_agg.py's tree: a batch_stats branch (never clipped), an
    int leaf, and a ragged mix of leaf shapes."""
    mk = lambda *s: rng.randn(n, *s).astype(np.float32)
    return {
        "params": {"dense": {"kernel": mk(17, 33), "bias": mk(33)},
                   "conv": {"kernel": mk(3, 3, 2, 8)}},
        "batch_stats": {"bn": {"mean": mk(8), "var": np.abs(mk(8)),
                               "num_batches_tracked": rng.randint(
                                   0, 100, (n, 1)).astype(np.int32)}},
    }


def _seed_words(key):
    """The round seed words the JAX fused aggregate derives from its key."""
    data = np.asarray(jax.random.key_data(key)).astype(np.uint32)
    return tuple(int(v) for v in data.view(np.int32)[:2])


def _both(stacked, w, key, **kw):
    g = jax.tree.map(lambda x: x[0] * 0.5, stacked)
    want = j_fused(interpret=True, **kw)(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
        jax.tree.map(jnp.asarray, g), key)
    got = t_fused(**kw)(params_from_numpy(stacked), torch.tensor(w),
                        params_from_numpy(g), _seed_words(key))
    return params_to_numpy(got), jax.tree.map(np.asarray, want)


def _assert_tree_close(got, want, atol):
    def check(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    jax.tree.map(check, got, want)


@pytest.mark.parametrize("norm_bound", [None, 0.7])
def test_plain_matches_pallas_sigma0(rng, norm_bound):
    got, want = _both(_stacked_params(rng), W, jax.random.key(0),
                      norm_bound=norm_bound, noise_std=0.0)
    _assert_tree_close(got, want, atol=2e-5)


@pytest.mark.parametrize("norm_bound", [None, 0.7])
def test_sigma0_matches_unfused_compose(rng, norm_bound):
    """The fused aggregate == per-client clip_update then the weighted
    mean, both in the port (the JAX package's own test, ported)."""
    stacked = params_from_numpy(_stacked_params(rng))
    g = {k: v[0] * 0.5 for k, v in stacked.items()}
    got = t_fused(norm_bound=norm_bound)(stacked, torch.tensor(W), g, (1, 2))
    if norm_bound is None:
        want = t_mean(stacked, torch.tensor(W))
    else:
        rows = [clip_update({k: v[i] for k, v in stacked.items()}, g,
                            norm_bound) for i in range(len(W))]
        want = t_mean(rows, torch.tensor(W))
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=0)


@pytest.mark.parametrize("key_words", [None, (0x7FFFFFF0, 0xFFFFFFF0)])
def test_plain_matches_pallas_with_noise(rng, key_words):
    """sigma > 0 with the same seed words; the second case puts both words
    where ``seed + li * 31337`` wraps around int32."""
    key = (jax.random.key(7) if key_words is None else
           jax.random.wrap_key_data(jnp.asarray(key_words, jnp.uint32)))
    got, want = _both(_stacked_params(rng), W, key, norm_bound=0.7,
                      noise_std=0.5)
    _assert_tree_close(got, want, atol=2e-5)
    # the noise is really there: sigma=0 differs by far more than that
    base, _ = _both(_stacked_params(np.random.RandomState(0)), W, key,
                    norm_bound=0.7, noise_std=0.0)
    assert np.abs(base["params"]["dense"]["kernel"]
                  - got["params"]["dense"]["kernel"]).max() > 0.05


def test_uniforms_bit_equal_and_gaussians_close():
    seed0, seed1 = _seed_words(jax.random.key(11))
    d = 4099
    idx = jnp.arange(d, dtype=jnp.uint32)
    idx_h = _murmur_fmix(idx * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
    s0 = _murmur_fmix(jnp.uint32(np.uint32(seed0 & 0xFFFFFFFF)))
    s1 = _murmur_fmix(jnp.uint32(np.uint32(seed1 & 0xFFFFFFFF))
                      ^ jnp.uint32(0x5BD1E995))
    for i in (0, 1, 9, 511):
        salt = _murmur_fmix(s0 ^ (s1 + jnp.uint32(i) * jnp.uint32(0x85EBCA6B)))
        b1 = _murmur_fmix(idx_h ^ salt)
        b2 = _murmur_fmix(b1 ^ jnp.uint32(0x27D4EB2F))
        j_u1 = np.asarray((b1 >> 8).astype(jnp.int32).astype(jnp.float32)
                          * (2.0 ** -24) + (2.0 ** -25))
        j_u2 = np.asarray((b2 >> 8).astype(jnp.int32).astype(jnp.float32)
                          * (2.0 ** -24))
        t_u1, t_u2 = noise_uniforms(d, seed0, seed1, i, "cpu")
        np.testing.assert_array_equal(t_u1.numpy().view(np.int32),
                                      j_u1.view(np.int32))
        np.testing.assert_array_equal(t_u2.numpy().view(np.int32),
                                      j_u2.view(np.int32))
        j_n = np.asarray(_gaussian_from_index(idx_h, salt))
        t_n = fused_agg._gaussian(t_u1, t_u2).numpy()
        np.testing.assert_allclose(t_n, j_n, rtol=1e-5, atol=1e-6)


def test_noise_statistics():
    """The summed noise of N clients with equal weights has std
    sigma * sqrt(sum r_i^2) = sigma / sqrt(N) (5% sampling tolerance)."""
    n, d, sigma = 4, 64 * 128, 0.5
    x = torch.zeros(n, d)
    ratios = torch.full((n,), 1.0 / n)
    out = robust_agg_plain(x, torch.zeros(d), torch.ones(n), ratios, 3, 4,
                           sigma).numpy()
    assert abs(out.mean()) < 0.01
    np.testing.assert_allclose(out.std(), sigma / np.sqrt(n), rtol=0.05)


def test_cohort_guard_refuses_in_both(rng):
    n = MAX_CLIENTS + 1
    stacked = {"w": rng.randn(n, 3).astype(np.float32)}
    g = {"w": np.zeros(3, np.float32)}
    w = np.ones(n, np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        j_fused(interpret=True)(jax.tree.map(jnp.asarray, stacked),
                                jnp.asarray(w), jax.tree.map(jnp.asarray, g),
                                jax.random.key(0))
    with pytest.raises(ValueError, match="exceeds"):
        t_fused()(params_from_numpy(stacked), torch.tensor(w),
                  params_from_numpy(g), (0, 0))


def test_wrapper_uses_plain_only_on_cpu(monkeypatch):
    """CPU tensors take the plain version and count no launch; a tensor on
    another device never falls back to it."""
    fused_agg.reset_launch_counts()
    x, g = torch.randn(3, 10), torch.randn(10)
    s, r = torch.ones(3), torch.full((3,), 1 / 3)
    torch.testing.assert_close(robust_agg(x, g, s, r, 1, 2, 0.1),
                               robust_agg_plain(x, g, s, r, 1, 2, 0.1))
    assert fused_agg.launch_counts["robust_agg"] == 0
    monkeypatch.setattr(fused_agg, "robust_agg_plain", None)
    with pytest.raises(ValueError, match="unsupported device"):
        robust_agg(x.to("meta"), g.to("meta"), s.to("meta"), r.to("meta"),
                   1, 2, 0.1)


def test_unfused_defense_matches_jax_clip(rng):
    """The torch backend's clip equals JAX's clip_update (1e-6); its noise
    (a torch.Generator stream) has the requested stddev and spares int
    leaves."""
    tree = jax.tree.map(lambda x: x[0], _stacked_params(rng))
    g = jax.tree.map(lambda x: x * 0.5, tree)
    want = jax.tree.map(np.asarray, j_clip(jax.tree.map(jnp.asarray, tree),
                                           jax.tree.map(jnp.asarray, g), 0.7))
    got = params_to_numpy(clip_update(params_from_numpy(tree),
                                      params_from_numpy(g), 0.7))
    _assert_tree_close(got, want, atol=1e-6)
    assert not default_is_weight_param("batch_stats/bn/mean")
    assert default_is_weight_param("params/dense/kernel")

    big = {"w": torch.zeros(100_000), "n": torch.zeros(3, dtype=torch.int32)}
    noised = add_gaussian_noise(big, torch.Generator().manual_seed(0), 0.25)
    np.testing.assert_allclose(float(noised["w"].std()), 0.25, rtol=0.02)
    assert torch.equal(noised["n"], big["n"])


def test_jax_compose_and_port_agree_on_clip_then_mean(rng):
    """Both packages' clip-then-mean agree (2e-5): the reference for the
    fused kernel at sigma = 0 is the same on both sides."""
    stacked = _stacked_params(rng)
    g = jax.tree.map(lambda x: x[0] * 0.5, stacked)
    clipped = jax.vmap(j_clip, in_axes=(0, None, None))(
        jax.tree.map(jnp.asarray, stacked), jax.tree.map(jnp.asarray, g), 0.7)
    want = jax.tree.map(np.asarray, j_mean(clipped, jnp.asarray(W)))
    got = params_to_numpy(t_fused(norm_bound=0.7)(
        params_from_numpy(stacked), torch.tensor(W), params_from_numpy(g),
        (5, 6)))
    _assert_tree_close(got, want, atol=2e-5)


# ---------------------------------------------------------------------------
# the leaf table of the one-launch aggregate
# ---------------------------------------------------------------------------

def _table_tree(rng, n=6):
    """Leaves of 62 and 3 elements beside larger ones, a batch_stats
    branch (not clipped) and an int leaf."""
    mk = lambda *s: rng.randn(n, *s).astype(np.float32)
    return {
        "params": {"out": {"bias": mk(62), "kernel": mk(9, 62)},
                   "tiny": {"w": mk(3)}, "conv": {"kernel": mk(5, 5, 1, 8)}},
        "batch_stats": {"bn": {"mean": mk(8), "var": np.abs(mk(8)),
                               "num_batches_tracked": rng.randint(
                                   0, 100, (n, 1)).astype(np.int32)}},
    }


def _layout_of(tree):
    from fedml_tpu_torch.core.pytree import tree_keys
    flat = params_from_numpy(tree)
    keys = tree_keys(flat)
    fl = [(li, k) for li, k in enumerate(keys)
          if flat[k].dtype.is_floating_point]
    return fused_agg.LeafLayout(
        [k for _, k in fl], [flat[k][0].numel() for _, k in fl],
        [li for li, _ in fl], [default_is_weight_param(k) for _, k in fl])


def test_leaf_layout_offsets_and_splits(rng):
    """Float leaves only, in leaf order, each at an offset that is a
    multiple of 4 floats with no overlap; the norm pass's rows are the
    weight leaves'; a leaf of no element gets no row."""
    lay = _layout_of(_table_tree(rng))
    sizes = dict(zip(lay.keys, lay.sizes))
    assert "batch_stats/bn/num_batches_tracked" not in sizes   # int leaf
    assert sizes["params/out/bias"] == 62 and sizes["params/tiny/w"] == 3
    for j in range(len(lay.keys)):
        assert lay.offsets[j] % 4 == 0
        end = lay.offsets[j] + lay.sizes[j]
        nxt = lay.offsets[j + 1] if j + 1 < len(lay.keys) else lay.out_numel
        assert end <= nxt < end + 4
    assert lay.rows == list(range(len(lay.keys)))
    normed = {lay.keys[j] for j in lay.norm_rows}
    assert normed == {k for k in lay.keys if "batch_stats" not in k}
    empty = fused_agg.LeafLayout(["a", "b", "c"], [5, 0, 3], [0, 1, 2],
                                 [True, True, False])
    assert empty.offsets == [0, 8, 8] and empty.out_numel == 12
    assert empty.rows == [0, 2] and empty.norm_rows == [0]


# The kernels' grid lives in csrc/leaf_table.cuh; its host part builds with
# a host C++ compiler, so the block map the launches use is checked here.
_GRID_SHIM = r"""
#include "leaf_table.cuh"
struct Leaf { int64_t d; int32_t block0; };
extern "C" int threads() { return leaf_table::kThreads; }
extern "C" int max_leaves() { return leaf_table::kMaxLeaves; }
extern "C" long long vec_blocks(long long d) {
  return leaf_table::vec_blocks(d);
}
// thread i's first element of a leaf of d elements and its count (0: none)
extern "C" int owned(long long i, long long d, long long* d0) {
  int64_t first = -1;
  int cnt = 0;
  if (!leaf_table::owned(i, d, &first, &cnt)) return 0;
  *d0 = first;
  return cnt;
}
// the leaf (index into d) of every block of each launch over leaves of d
// elements, kMaxLeaves a launch; chunk 0: the float4 map, else chunk
// elements a block; returns the blocks of all launches, launch by launch
extern "C" long long block_map(const long long* d, int n, long long chunk,
                               int* leaf_of, int* launch_of) {
  long long out = 0;
  for (int first = 0, k = 0; first < n;
       first += leaf_table::kMaxLeaves, ++k) {
    const int m = n - first < leaf_table::kMaxLeaves
                      ? n - first : leaf_table::kMaxLeaves;
    Leaf t[leaf_table::kMaxLeaves];
    for (int l = 0; l < m; ++l) t[l].d = d[first + l];
    const int64_t blocks = leaf_table::assign_blocks(
        t, m, [chunk](int64_t e) {
          return chunk ? (e + chunk - 1) / chunk : leaf_table::vec_blocks(e);
        });
    for (int64_t b = 0; b < blocks; ++b, ++out) {
      leaf_of[out] = first + leaf_table::find_leaf(t, m, static_cast<int>(b));
      launch_of[out] = k;
    }
  }
  return out;
}
"""


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The header's host part, built with the host C++ compiler."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("grid")
    (out / "shim.cpp").write_text(_GRID_SHIM)
    csrc = Path(fused_agg.__file__).resolve().parents[1] / "csrc"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(csrc), "-o", str(out / "grid.so"),
                    str(out / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "grid.so"))
    i64, p = ctypes.c_longlong, ctypes.c_void_p
    lib.vec_blocks.argtypes, lib.vec_blocks.restype = [i64], i64
    lib.owned.argtypes, lib.owned.restype = [i64, i64, p], ctypes.c_int
    lib.block_map.argtypes = [p, ctypes.c_int, i64, p, p]
    lib.block_map.restype = i64
    return lib


def _owners(grid, d):
    """(thread, first element, count) of every thread of a leaf's blocks
    that owns elements."""
    import ctypes
    d0 = ctypes.c_longlong(0)
    out = []
    for i in range(grid.vec_blocks(d) * grid.threads()):
        cnt = grid.owned(i, d, ctypes.byref(d0))
        if cnt:
            out.append((i, d0.value, cnt))
    return out


@pytest.mark.parametrize("d", [1, 3, 4, 5, 32, 62, 64, 800, 1027, 31_744,
                               51_200])
def test_leaf_grid_covers_each_element_once(grid, d):
    """Thread t < D / 4 owns elements 4t..4t+3; the D % 4 tail goes to one
    thread, the first of the warp after the float4 threads, alone in its
    warp; the leaf's blocks hold every owner and no block is idle."""
    owners = _owners(grid, d)
    covered = [e for _, d0, cnt in owners for e in range(d0, d0 + cnt)]
    assert covered == list(range(d))
    n_vec, tail = divmod(d, 4)
    assert [i for i, _, cnt in owners if cnt == 4] == list(range(n_vec))
    if tail:
        i, d0, cnt = owners[-1]
        assert (i, d0, cnt) == ((n_vec + 31) // 32 * 32, 4 * n_vec, tail)
        assert all(j // 32 != i // 32 for j, _, _ in owners[:-1])
    last = owners[-1][0]
    assert grid.vec_blocks(d) == last // grid.threads() + 1


def _block_map(grid, sizes, chunk=0):
    d = np.array(sizes, np.int64)
    cap = sum(-(-x // chunk) if chunk else grid.vec_blocks(int(x))
              for x in sizes)
    leaf_of = np.zeros(cap, np.int32)
    launch_of = np.zeros(cap, np.int32)
    n = grid.block_map(d.ctypes.data, len(sizes), chunk,
                         leaf_of.ctypes.data, launch_of.ctypes.data)
    assert n == cap
    return leaf_of.tolist(), launch_of.tolist()


def test_leaf_layout_block_map_covers_every_block_once(rng, grid):
    """Over the table tree's rows and the CNN's leaf sizes: every block of
    the aggregate maps to one leaf, in leaf order, each leaf taking its
    own blocks (so no block straddles two leaves and the last leaf's tail
    thread has a block); the norm pass's 4096-element chunks likewise over
    the weight rows.  A table of 70 leaves takes two launches (64 + 6),
    each with its own grid."""
    lay = _layout_of(_table_tree(rng))
    cnn = [800, 32, 51_200, 64, 1_605_632, 512, 31_744, 62]
    for sizes in ([lay.sizes[j] for j in lay.rows], cnn,
                  cnn + [1_000_003, 3]):
        leaf_of, launch_of = _block_map(grid, sizes)
        assert leaf_of == [j for j, d in enumerate(sizes)
                           for _ in range(grid.vec_blocks(d))]
        assert set(launch_of) == {0}
        leaf_of, _ = _block_map(grid, sizes, chunk=4096)
        assert leaf_of == [j for j, d in enumerate(sizes)
                           for _ in range(-(-d // 4096))]
    sizes = [3 + (k % 5) * 31 for k in range(70)]
    leaf_of, launch_of = _block_map(grid, sizes)
    assert leaf_of == list(range(70))             # one block each
    assert launch_of == [0] * 64 + [1] * 6


def test_leaf_layout_table_rows_and_alignment(rng):
    """A call's rows carry the pointers, D, each leaf's seed words (int32
    wraparound) and clipped flag, and its output at the padded offset, so
    every leaf's output starts on a 16-byte boundary of the flat buffer;
    the norm rows are the weight leaves'."""
    lay = _layout_of(_table_tree(rng))
    xs = [torch.zeros(6, d) for d in lay.sizes]
    gs = [torch.zeros(d) for d in lay.sizes]
    out = torch.empty(lay.out_numel)
    assert out.data_ptr() % 16 == 0
    t = lay.agg_table(xs, gs, out, 0x7FFFFFF0, -5)
    fa = fused_agg
    assert t.shape == (len(lay.rows), 7)
    for r, j in enumerate(lay.rows):
        assert t[r, fa.X] == xs[j].data_ptr()
        assert t[r, fa.G] == gs[j].data_ptr()
        assert t[r, fa.OUT] == out.data_ptr() + 4 * lay.offsets[j]
        assert t[r, fa.OUT] % 16 == 0
        assert t[r, fa.D] == lay.sizes[j]
        li = lay.leaf_ids[j]
        assert t[r, fa.SEED0] == fa.leaf_seed(0x7FFFFFF0, li)
        assert t[r, fa.SEED1] == fa.leaf_seed(-5, li)
        assert t[r, fa.CLIPPED] == lay.weight[j]
    assert fa.leaf_seed(0x7FFFFFF0, 1) == 0x7FFFFFF0 + 31337 - 2**32
    n = lay.norm_table(xs, gs)
    assert n[:, fa.X].tolist() == [xs[j].data_ptr() for j in lay.norm_rows]
    assert n[:, fa.D].tolist() == [lay.sizes[j] for j in lay.norm_rows]
    none = fused_agg.LeafLayout(["b"], [4], [0], [False])
    assert none.norm_table([torch.zeros(6, 4)], [torch.zeros(4)]).shape \
        == (0, 7)


@pytest.mark.parametrize("norm_bound", [None, 0.7])
@pytest.mark.parametrize("sigma", [0.0, 0.025])
def test_table_aggregate_matches_pallas(rng, norm_bound, sigma):
    """The tree-level aggregate over the table tree (62- and 3-element
    leaves, batch_stats, an int leaf) against the interpret-mode Pallas
    aggregate: 2e-5, as the per-leaf tests."""
    got, want = _both(_table_tree(rng), W, jax.random.key(3),
                      norm_bound=norm_bound, noise_std=sigma)
    _assert_tree_close(got, want, atol=2e-5)


def test_table_outputs_are_views_of_one_buffer(rng):
    """Each float leaf of the result is a view of one flat buffer at its
    padded offset; the int leaf is computed apart; the values equal the
    leaf-by-leaf plain version bit for bit."""
    tree = params_from_numpy(_table_tree(rng))
    g = {k: v[0] * 0.5 for k, v in tree.items()}
    got = t_fused(norm_bound=0.7, noise_std=0.1)(tree, torch.tensor(W), g,
                                                 (7, 8))
    lay = _layout_of(_table_tree(np.random.RandomState(0)))
    base = got[lay.keys[0]].untyped_storage().data_ptr()
    for j, k in enumerate(lay.keys):
        assert got[k].untyped_storage().data_ptr() == base
        assert got[k].storage_offset() == lay.offsets[j]
    ratios = torch.tensor(W) / torch.tensor(W).sum()
    scales = fused_agg.clip_scales_plain(tree, g, 0.7,
                                         default_is_weight_param)
    from fedml_tpu_torch.core.pytree import tree_keys
    for li, k in enumerate(tree_keys(tree)):
        if not tree[k].dtype.is_floating_point:
            continue
        n = tree[k].shape[0]
        s = scales if default_is_weight_param(k) else torch.ones(n)
        want = robust_agg_plain(tree[k].reshape(n, -1), g[k].reshape(-1), s,
                                ratios, fused_agg.leaf_seed(7, li),
                                fused_agg.leaf_seed(8, li), 0.1)
        assert torch.equal(got[k].reshape(-1), want)


def test_clip_norm_plain_is_the_eager_clip_pass(rng):
    """On the CPU the norm pass is the eager clip pass over the weight
    leaves, bit for bit; with no weight leaf every scale is 1."""
    tree = params_from_numpy(_table_tree(rng))
    g = {k: v[0] * 0.5 for k, v in tree.items()}
    lay = _layout_of(_table_tree(np.random.RandomState(0)))
    xs = [tree[k].reshape(6, -1) for k in lay.keys]
    gs = [g[k].reshape(-1) for k in lay.keys]
    got = fused_agg.clip_norm(lay, xs, gs, 0.7)
    want = fused_agg.clip_scales_plain(tree, g, 0.7, default_is_weight_param)
    assert torch.equal(got, want) and (got < 1).all()
    none = fused_agg.LeafLayout(["b"], [4], [0], [False])
    assert torch.equal(fused_agg.clip_norm(
        none, [torch.ones(6, 4)], [torch.zeros(4)], 0.7), torch.ones(6))


def test_noise_probe_on_cpu_is_the_plain_stream():
    u1, u2, gauss = fused_agg.noise_probe(1000, 3, 4, 2, "cpu")
    pu1, pu2 = fused_agg.noise_uniforms_plain(1000, 3, 4, 2)
    assert torch.equal(u1, pu1) and torch.equal(u2, pu2)
    assert torch.equal(gauss, fused_agg._gaussian(pu1, pu2))


def test_fast_gaussian_log_series_near_one():
    """The kernel's -ln(u1) for u1 within 2^-8 of 1: the series t + t^2/2
    in t = 1 - u1 (exact in f32 there), evaluated in f32 as murmur.cuh
    does, is within t^2/3 + 4 ulps (relative) of the f64 log at every u1
    the uniforms can take there, where lg2's ~2^-22 absolute error would
    be up to 2^3 times the result; the Gaussian's error from it stays
    under 3e-7."""
    m = np.arange(2**24 - 2**16 + 1, 2**24, dtype=np.int64)
    u1 = (m.astype(np.float32) * np.float32(2.0**-24)
          + np.float32(2.0**-25)).astype(np.float32)
    t = (np.float32(1.0) - u1).astype(np.float32)
    assert (t < np.float32(2.0**-8)).all()
    series = t * (np.float32(1.0) + np.float32(0.5) * t)
    pos = t > 0
    exact = -np.log(u1.astype(np.float64))
    rel = np.abs(series[pos] - exact[pos]) / exact[pos]
    tf = t[pos].astype(np.float64)
    assert (rel < tf**2 / 3 + 4 * 2.0**-24).all()
    # in the Gaussian: sqrt(2 * -ln u1) moves by at most half of rel
    r = np.sqrt(2 * exact[pos])
    assert (r * rel / 2).max() < 3e-7
    assert (series[~pos] == 0).all()       # u1 rounded to 1: n = 0


def test_table_aggregate_dispatches_on_the_leaves_device(monkeypatch):
    """The table wrappers take the plain versions for CPU leaves only: a
    leaf on another device gets the kernel or an exception, whatever
    device the ratios (or the aggregate's weights) are on, and never the
    plain version."""
    monkeypatch.setattr(fused_agg, "robust_agg_plain", None)
    monkeypatch.setattr(fused_agg, "clip_scales_plain", None)
    lay = fused_agg.LeafLayout(["a", "b"], [62, 3], [0, 1], [True, False])
    xs = [torch.zeros(4, d, device="meta") for d in lay.sizes]
    gs = [torch.zeros(d, device="meta") for d in lay.sizes]
    for ratios in (torch.full((4,), 0.25),
                   torch.full((4,), 0.25, device="meta")):
        with pytest.raises(ValueError, match="unsupported device meta"):
            fused_agg.robust_agg_table(lay, xs, gs, None, ratios, 1, 2, 0.1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fused_agg.clip_norm(lay, xs, gs, 0.7)
    tree = {"params/a": torch.zeros(4, 62, device="meta")}
    glob = {"params/a": torch.zeros(62, device="meta")}
    for norm_bound in (None, 0.7):
        with pytest.raises(ValueError, match="unsupported device meta"):
            t_fused(norm_bound=norm_bound)(tree, [1.0, 2.0, 3.0, 4.0], glob,
                                           (1, 2))


@pytest.mark.parametrize("sigma", [0.0, 0.025])
def test_nan_client_poisons_the_weight_leaves_as_in_jax(rng, sigma):
    """A NaN in one client's update makes its clip scale NaN, so every
    element of every weight leaf of the aggregate is NaN, as in the
    interpret-mode Pallas aggregate; the batch_stats leaves (not clipped)
    and the int leaf stay finite and agree within 2e-5."""
    tree = _table_tree(rng)
    tree["params"]["conv"]["kernel"][2, 1, 3, 0, 5] = np.nan
    got, want = _both(tree, W, jax.random.key(4), norm_bound=0.7,
                      noise_std=sigma)
    _assert_tree_close(got, want, atol=2e-5)
    for branch, leaves in got["params"].items():
        for name, v in leaves.items():
            assert np.isnan(v).all(), (branch, name)
    for name, v in got["batch_stats"]["bn"].items():
        assert np.isfinite(v).all(), name
