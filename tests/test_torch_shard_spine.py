"""The port's sharded spine (``fedml_tpu_torch/shard_spine``) and its shard
finalize kernel K2 (``core/fused_agg.py``) against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX's K2 runs through ``make_fused_shard_finalize(interpret=True)``, as
``tests/test_shard_spine.py`` runs it.  Tolerances:

* the plan's spec (the JSON the sync frame ships) and its crc fingerprint:
  byte-equal / equal;
* unclipped sharded folds at any S, and S = 1 with the clip: bit for bit
  against the port's replicated fold; against JAX, unclipped bit for bit
  and clipped ``atol=2e-6`` (the clip scale's sum of squares runs in
  another order in XLA);
* K2's plain version against JAX's K2: sigma = 0 bit for bit; sigma > 0
  the noise uniforms bit for bit, the outputs within ``rtol=1e-5,
  atol=1e-6`` (precise log/cos of two libraries, as K1's test states);
* admission verdicts: equal.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.pallas_agg import _murmur_fmix
from fedml_tpu.core.pallas_agg import \
    make_fused_shard_finalize as j_make_finalize
from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.shard_spine import ShardAdmission as JShardAdmission
from fedml_tpu.shard_spine import SiloShardAssembler as JAssembler
from fedml_tpu.shard_spine import ShardedStreamingAggregator as JSharded
from fedml_tpu.shard_spine import build_shard_plan as j_build_plan
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core import fused_agg
from fedml_tpu_torch.core.fused_agg import (make_fused_shard_finalize,
                                            shard_finalize,
                                            shard_finalize_plain,
                                            shard_seed_word,
                                            shard_uniforms_plain)
from fedml_tpu_torch.core.pytree import nest, to_host
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.robust import TrustTracker
from fedml_tpu_torch.shard_spine import (ShardAdmission,
                                         ShardedStreamingAggregator,
                                         SiloShardAssembler, SiloShardCodec,
                                         build_shard_plan, build_shard_spine)
from fedml_tpu_torch.shard_spine.admission import ACCEPT, REJECT, WAIT
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


@pytest.fixture(autouse=True)
def no_timer_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and isinstance(t, threading.Timer)]
    assert not leaked, leaked


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(16, 12).astype(np.float32),
                      "bias": rng.randn(12).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
            "step": np.int32(5)}


def _uploads(n, seed=7, tmpl=None):
    rng = np.random.RandomState(seed)
    tmpl = tmpl if tmpl is not None else _params()
    ups, ws = [], []
    for i in range(n):
        ups.append(jax.tree.map(
            lambda v: (np.asarray(v) + rng.randn(*np.shape(v))).astype(
                np.asarray(v).dtype), tmpl))
        ws.append(float(10 * (i + 1)))
    return ups, ws


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb))


def _close(a, b, atol=2e-6):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _cnn_template():
    return jax.tree.map(np.asarray, JCNN(only_digits=False).init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])


# ---------------------------------------------------------------------------
# the plan: the same layout, spec and fingerprint as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4])
def test_cnn_plan_spec_and_fingerprint_equal_jax(S):
    tmpl = _cnn_template()
    want = j_build_plan(tmpl, S)
    got = build_shard_plan(params_from_numpy(tmpl), S)
    assert json.dumps(got.spec()) == json.dumps(want.spec())
    assert got.fingerprint() == want.fingerprint()
    assert [got.slice_numel(s) for s in range(S)] == [
        sum(int(np.prod(want.piece_shape(lp)))
            for lp in want.leaves if lp.index in want.members[s])
        for s in range(S)]
    if S == 4:   # the sizes K2 runs over at full width
        assert [got.slice_numel(s) for s in range(S)] == [
            422238, 422944, 422208, 422656]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_split_join_roundtrip_exact(S):
    tmpl = _params()
    plan = build_shard_plan(params_from_numpy(tmpl), S, min_split_elems=64)
    leaves = _leaves(tmpl)
    back = plan.join_slices(plan.split_leaves(leaves))
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(leaves, back))
    tensors = [torch.as_tensor(x) for x in leaves]
    back_t = plan.join_slices(plan.split_leaves(tensors))
    assert all(torch.equal(a, b) for a, b in zip(tensors, back_t))
    # the slices are the JAX package's, piece for piece
    want = j_build_plan(tmpl, S, min_split_elems=64).split_leaves(leaves)
    assert _bits_equal(plan.split_leaves(leaves), want)


def test_silo_codec_roundtrip_through_the_wire():
    tmpl = _params()
    plan = build_shard_plan(params_from_numpy(tmpl), 2, min_split_elems=64)
    codec = SiloShardCodec(json.loads(json.dumps(plan.spec())))
    assert codec.fingerprint == plan.fingerprint()
    wire = []
    for sl in plan.split_leaves(_leaves(tmpl)):
        msg = Message(2, 0, 1)
        msg.add(Message.ARG_MODEL_PARAMS, sl)
        wire.append(Message.from_bytes(msg.to_bytes())
                    .get(Message.ARG_MODEL_PARAMS))
    tree = codec.join(wire)
    assert _bits_equal(tmpl, tree)
    assert _bits_equal(tmpl, codec.join(codec.split(tree)))


# ---------------------------------------------------------------------------
# the sharded fold
# ---------------------------------------------------------------------------

def _port_pair(S, clip, noise=0.0, fused=False, seed=3, n=5):
    tmpl = _params()
    ups, ws = _uploads(n)
    flat = params_from_numpy(tmpl)
    plain = StreamingAggregator(flat, method="mean", norm_clip=clip,
                                noise_std=noise, seed=seed)
    plan = build_shard_plan(flat, S, min_split_elems=64)
    agg = ShardedStreamingAggregator(plan, flat, norm_clip=clip,
                                     noise_std=noise, seed=seed, fused=fused)
    for a in (plain, agg):
        a.reset(flat)
        for u, w in zip(ups, ws):
            a.fold(params_from_numpy(u), w)
    assert agg.count == plain.count and agg.weight_total == plain.weight_total
    return params_to_numpy(plain.finalize(2)), params_to_numpy(
        agg.finalize(2))


@pytest.mark.parametrize("S,clip,exact", [
    (1, 0.0, True), (2, 0.0, True), (4, 0.0, True), (1, 2.5, True),
    (2, 2.5, False), (4, 2.5, False)])
def test_sharded_fold_matches_replicated(S, clip, exact):
    want, got = _port_pair(S, clip)
    if exact:
        assert _bits_equal(want, got)
    else:
        _close(want, got, atol=1e-5)


@pytest.mark.parametrize("S,clip", [(1, 0.0), (2, 0.0), (1, 2.5), (4, 2.5)])
def test_sharded_fold_matches_jax(S, clip):
    tmpl = _params()
    ups, ws = _uploads(5)
    j = JSharded(j_build_plan(tmpl, S, min_split_elems=64), tmpl,
                 norm_clip=clip)
    flat = params_from_numpy(tmpl)
    t = ShardedStreamingAggregator(build_shard_plan(flat, S,
                                                    min_split_elems=64),
                                   flat, norm_clip=clip)
    j.reset(tmpl)
    t.reset(flat)
    for u, w in zip(ups, ws):
        j.fold(u, w)
        t.fold(params_from_numpy(u), w)
    want, got = j.finalize(1), params_to_numpy(t.finalize(1))
    if clip:
        _close(got, want)
    else:
        assert _bits_equal(got, want)


@pytest.mark.parametrize("S,clip", [(1, 0.0), (2, 0.0), (2, 2.5)])
def test_fused_sigma0_bit_equal_to_compose(S, clip):
    _, compose = _port_pair(S, clip)
    _, fused = _port_pair(S, clip, fused=True)
    assert _bits_equal(compose, fused)


def test_fold_slices_and_fold_wave_equal_fold():
    tmpl = _params()
    ups, ws = _uploads(4)
    flat = params_from_numpy(tmpl)
    plan = build_shard_plan(flat, 2, min_split_elems=64)
    a, b, c = (ShardedStreamingAggregator(plan, flat, norm_clip=2.0)
               for _ in range(3))
    for x in (a, b, c):
        x.reset(flat)
    for u, w in zip(ups, ws):
        a.fold(params_from_numpy(u), w)
        b.fold_slices(plan.split_leaves(_leaves(u)), w)
    stk = params_from_numpy(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *ups))
    c.fold_wave(stk, np.asarray(ws, np.float32))
    want = params_to_numpy(a.finalize(0))
    assert _bits_equal(want, params_to_numpy(b.finalize(0)))
    assert _bits_equal(want, params_to_numpy(c.finalize(0)))


def test_state_dict_roundtrip_and_foreign_snapshot_refused():
    tmpl = _params()
    ups, ws = _uploads(4)
    flat = params_from_numpy(tmpl)
    p2 = build_shard_plan(flat, 2, min_split_elems=64)
    a, b = (ShardedStreamingAggregator(p2, flat, norm_clip=2.0)
            for _ in range(2))
    a.reset(flat)
    b.reset(flat)
    for u, w in zip(ups[:2], ws[:2]):
        a.fold(params_from_numpy(u), w)
    snap = a.state_dict()
    assert snap["shard_fp"] == p2.fingerprint()
    b.load_state_dict(snap)
    for u, w in zip(ups[2:], ws[2:]):
        a.fold(params_from_numpy(u), w)
        b.fold(params_from_numpy(u), w)
    assert _bits_equal(params_to_numpy(a.finalize(0)),
                       params_to_numpy(b.finalize(0)))
    c = ShardedStreamingAggregator(build_shard_plan(flat, 4,
                                                    min_split_elems=64), flat)
    c.reset(flat)
    with pytest.raises(ValueError, match="different shard plan"):
        c.load_state_dict(snap)


def test_model_mesh_is_a_device_list_or_none():
    from fedml_tpu_torch.parallel.mesh import make_model_mesh
    with pytest.raises(ValueError, match="num_shards"):
        make_model_mesh(0)
    assert make_model_mesh(torch.cuda.device_count() + 1) is None
    # on the CPU every shard of the spine lives on the template's device
    flat = params_from_numpy(_params())
    spine = build_shard_spine(flat, num_shards=2, min_split_elems=64)
    assert spine.agg.devices == [torch.device("cpu")] * 2


def test_sharded_spine_refuses_delta_uploads():
    flat = params_from_numpy(_params())
    with pytest.raises(ValueError, match="params"):
        ShardedStreamingAggregator(build_shard_plan(flat, 2), flat,
                                   kind="delta")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        build_shard_spine(flat, num_shards=2, fused="sometimes")


# ---------------------------------------------------------------------------
# K2: the plain version against JAX's interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

def _k2_pieces(seed=0):
    """One shard's pieces, keyed like a slice body: two float pieces (one
    odd-sized, so the TPU layout pads) and an int step counter."""
    rng = np.random.RandomState(seed)
    return {"00000": (rng.randn(37, 129) * 50).astype(np.float32),
            "00001": (rng.randn(1001) * 50).astype(np.float32),
            "00002": np.asarray(rng.randint(0, 500), np.int32)}


@pytest.mark.parametrize("sigma,seed,salt,step", [
    (0.0, 0, 0, 0), (0.0, 5, 3, 7),
    (0.025, 9, 0, 1), (0.5, 2**31 + 5, 3, 2**31 - 1)])
def test_k2_plain_matches_jax_kernel(sigma, seed, salt, step):
    acc = _k2_pieces()
    wsum = np.float32(37.5)
    want = j_make_finalize(noise_std=sigma, seed=seed, shard_salt=salt,
                           interpret=True)(
        {k: jnp.asarray(v) for k, v in acc.items()}, wsum, acc,
        np.int32(np.uint32(step).view(np.int32)))
    got = make_fused_shard_finalize(noise_std=sigma, seed=seed,
                                    shard_salt=salt)(
        {k: torch.as_tensor(v) for k, v in acc.items()}, float(wsum),
        {k: torch.as_tensor(v) for k, v in acc.items()}, step)
    assert sorted(got) == sorted(want)
    for k in acc:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape
        if sigma == 0 or g.dtype.kind != "f":
            assert g.tobytes() == w.tobytes(), k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    if sigma:   # the noise is really there
        clean = np.asarray(acc["00001"]) / wsum
        assert np.abs(got["00001"].numpy() - clean).std() > sigma / 2


@pytest.mark.parametrize("seed,salt,step", [(9, 0, 1), (2**31 + 5, 3,
                                                       2**31 - 1)])
def test_k2_uniforms_bit_equal_jax(seed, salt, step):
    """The stream K2 draws: d runs over the shard's concatenated float
    pieces; the salt mixes the shard into the seed word and the step into
    the second word."""
    d = 5003
    seed_word = shard_seed_word(seed, salt)
    j_word = ((seed & 0xFFFFFFFF)
              ^ (((salt & 0xFFFFFFFF) * 0x9E3779B9) & 0xFFFFFFFF))
    assert seed_word & 0xFFFFFFFF == j_word
    idx = jnp.arange(d, dtype=jnp.uint32)
    idx_h = _murmur_fmix(idx * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
    s0 = _murmur_fmix(jnp.uint32(j_word))
    s1 = _murmur_fmix(jnp.uint32(step & 0xFFFFFFFF) ^ jnp.uint32(0x5BD1E995))
    b1 = _murmur_fmix(idx_h ^ _murmur_fmix(s0 ^ s1))
    b2 = _murmur_fmix(b1 ^ jnp.uint32(0x27D4EB2F))
    j_u1 = np.asarray((b1 >> 8).astype(jnp.int32).astype(jnp.float32)
                      * (2.0 ** -24) + (2.0 ** -25))
    j_u2 = np.asarray((b2 >> 8).astype(jnp.int32).astype(jnp.float32)
                      * (2.0 ** -24))
    u1, u2 = shard_uniforms_plain(d, seed_word, step)
    np.testing.assert_array_equal(u1.numpy().view(np.int32),
                                  j_u1.view(np.int32))
    np.testing.assert_array_equal(u2.numpy().view(np.int32),
                                  j_u2.view(np.int32))


def test_k2_sigma0_is_the_ieee_division():
    acc = torch.randn(10_001) * 100
    assert torch.equal(shard_finalize_plain(acc, 3.0, 7, 1, 0.0),
                       acc / torch.tensor(3.0))


def test_k2_wrapper_uses_plain_only_on_cpu(monkeypatch):
    fused_agg.reset_launch_counts()
    acc = torch.randn(1000)
    assert torch.equal(shard_finalize(acc, 2.0, 5, 1, 0.1),
                       shard_finalize_plain(acc, 2.0, 5, 1, 0.1))
    assert fused_agg.launch_counts["shard_finalize"] == 0
    monkeypatch.setattr(fused_agg, "shard_finalize_plain", None)
    with pytest.raises(ValueError, match="unsupported device"):
        shard_finalize(acc.to("meta"), 2.0, 5, 1, 0.1)


def test_fused_noise_statistics_and_step_keying():
    tmpl = {"w": np.zeros((64, 128), np.float32)}
    ups = [{"w": np.random.RandomState(i).randn(64, 128).astype(np.float32)}
           for i in range(3)]
    flat = params_from_numpy(tmpl)
    plan = build_shard_plan(flat, 2, min_split_elems=64)

    def run(noise, step):
        agg = ShardedStreamingAggregator(plan, flat, noise_std=noise,
                                         fused=True, seed=9)
        agg.reset(flat)
        for u in ups:
            agg.fold(params_from_numpy(u), 1.0)
        return agg.finalize(step)["w"].numpy()

    delta = (run(0.5, 1) - run(0.0, 1)).ravel()
    assert abs(delta.mean()) < 0.02
    np.testing.assert_allclose(delta.std(), 0.5, rtol=0.1)
    np.testing.assert_array_equal(run(0.5, 1), run(0.5, 1))
    assert not np.allclose(run(0.5, 1), run(0.5, 2))


# ---------------------------------------------------------------------------
# per-shard admission: the JAX package's verdicts
# ---------------------------------------------------------------------------

def _adm_pair(**kw):
    tmpl = _params()
    jplan = j_build_plan(tmpl, 2, min_split_elems=64)
    j = JShardAdmission(jplan, tmpl, **kw)
    j.round_start(tmpl)
    flat = params_from_numpy(tmpl)
    plan = build_shard_plan(flat, 2, min_split_elems=64)
    t = ShardAdmission(plan, flat, **kw)
    t.round_start(to_host(nest(flat)))
    return plan, j, t


def _offer_both(j, t, *args):
    (js, ji), (ts, ti) = j.offer(*args), t.offer(*args)
    assert js == ts
    assert ji.get("reason") == ti.get("reason")
    if ji.get("norm") is not None:
        assert ti["norm"] == pytest.approx(ji["norm"], rel=1e-12)
    return ts, ti


def _slices(plan, tree):
    return plan.split_leaves(_leaves(tree))


def test_admission_accepts_with_combined_norm():
    plan, j, t = _adm_pair()
    sl = _slices(plan, _uploads(1)[0][0])
    assert _offer_both(j, t, 1, 0, 2, sl[0], 10, 0)[0] == WAIT
    status, info = _offer_both(j, t, 1, 1, 2, sl[1], 10, 0)
    assert status == ACCEPT and info["num_samples"] == 10.0
    assert [f"s{s}" in x for s, x in enumerate(info["slices"])] == [True] * 2


@pytest.mark.parametrize("case", ["wrong_shard", "shard_out_of_range",
                                  "wrong_count", "nonfinite",
                                  "inconsistent_num_samples"])
def test_admission_rejections_match_jax(case):
    plan, j, t = _adm_pair()
    sl = _slices(plan, _uploads(1)[0][0])
    if case == "wrong_shard":
        args = [(1, 0, 2, sl[1], 10, 0)]
    elif case == "shard_out_of_range":
        args = [(1, 5, 2, sl[0], 10, 0)]
    elif case == "wrong_count":
        args = [(1, 0, 3, sl[0], 10, 0)]
    elif case == "nonfinite":
        bad = {k: {kk: np.full_like(vv, np.nan) if vv.dtype.kind == "f"
                   else vv for kk, vv in v.items()} for k, v in sl[1].items()}
        args = [(1, 0, 2, sl[0], 10, 0), (1, 1, 2, bad, 10, 0)]
    else:
        args = [(1, 0, 2, sl[0], 10, 0), (1, 1, 2, sl[1], 999, 0)]
    for a in args[:-1]:
        assert _offer_both(j, t, *a)[0] == WAIT
    status, _ = _offer_both(j, t, *args[-1])
    assert status == REJECT
    assert t.rejected == j.rejected
    assert not t.pending_silos()     # one bad slice drops the whole silo


def test_admission_duplicate_slice_is_banked_once():
    plan, j, t = _adm_pair()
    sl = _slices(plan, _uploads(1)[0][0])
    assert _offer_both(j, t, 1, 0, 2, sl[0], 10, 0)[0] == WAIT
    assert _offer_both(j, t, 1, 0, 2, sl[0], 10, 0)[0] == WAIT
    assert _offer_both(j, t, 1, 1, 2, sl[1], 10, 0)[0] == ACCEPT


def test_admission_norm_outlier_screen_matches_jax():
    plan, j, t = _adm_pair(norm_min_history=4, norm_k=6.0)
    ups, _ = _uploads(6)
    for silo, up in enumerate(ups[:4], start=1):
        sl = _slices(plan, up)
        assert _offer_both(j, t, silo, 0, 2, sl[0], 10, 0)[0] == WAIT
        assert _offer_both(j, t, silo, 1, 2, sl[1], 10, 0)[0] == ACCEPT
    assert t.norm_threshold() == pytest.approx(j.norm_threshold(),
                                               rel=1e-12)
    big = jax.tree.map(lambda v: (np.asarray(v) * 1000).astype(
        np.asarray(v).dtype), ups[4])
    sl = _slices(plan, big)
    assert _offer_both(j, t, 5, 0, 2, sl[0], 10, 0)[0] == WAIT
    status, info = _offer_both(j, t, 5, 1, 2, sl[1], 10, 0)
    assert status == REJECT and info["reason"] == "norm_outlier"


def test_admission_strikes_quarantine_through_the_tracker():
    trust = TrustTracker(strikes_to_quarantine=2)
    plan, _, t = _adm_pair(trust=trust)
    sl = _slices(plan, _uploads(1)[0][0])
    t.offer(1, 0, 2, sl[1], 10, 0)          # wrong shard: strike 1
    t.offer(1, 0, 2, sl[1], 10, 1)          # strike 2: quarantined
    assert trust.state(1, 2) == TrustTracker.QUARANTINED
    assert t.offer(1, 0, 2, sl[0], 10, 2)[0] == REJECT
    assert t.rejected["quarantined"] == 1


def test_assembler_matches_jax_and_drops_stale_frames():
    """The silo side: a stale older-round slice never wipes the current
    assembly, an out-of-range shard index is dropped, and the joined tree
    equals the JAX assembler's."""
    tmpl = _params()
    plan = build_shard_plan(params_from_numpy(tmpl), 2, min_split_elems=64)
    spec = plan.spec()
    slices = plan.split_leaves(_leaves(tmpl))
    got = []
    for rx in (SiloShardAssembler(), JAssembler()):
        assert rx.offer(5, 0, 2, slices[0], spec,
                        meta={"client_idx": 1}) is False
        assert rx.offer(4, 1, 2, slices[1], None) is False
        assert rx.offer(5, 7, 2, slices[1], None) is False
        assert rx.offer(5, 1, 2, slices[1], None) is True
        params, meta = rx.take()
        assert meta["client_idx"] == 1
        got.append(params)
    assert _bits_equal(got[0], tmpl) and _bits_equal(got[1], tmpl)
