"""The port's live secure aggregation (``secure/protocol.py`` and the
actors' SecAgg stages) against the JAX package — the port twin of
``tests/test_secagg_live.py``.

Tolerances:

* with the same injected ``np.random.RandomState`` per silo, the port's
  ADVERT payloads equal the JAX client's, and its masked upload frames
  are byte-equal (the wire codec's bytes);
* mixed federations (a JAX server with port silos, a port server with JAX
  silos) cancel their masks: the ring sums are exact, so every global is
  bit-equal to the all-JAX run's;
* the unmasked ring sum equals the ring sum of the unmasked quantized
  uploads, bit for bit; the published mean is within ``atol=1e-3`` of the
  plaintext weighted mean (the JAX test's quantization limit);
* the sum-level clip and noise within ``1e-6`` of the JAX server's (the
  port's Gaussian is within one f32 ulp of ``jax.random.normal``).
"""

import functools
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.robust.admission import AdmissionPipeline as JAdmission
from fedml_tpu.secure import protocol as jp
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor,
                                                   MsgType)
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.experiments.main import check_config, main
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.robust import AdmissionPipeline
from fedml_tpu_torch.robust.admission import params_fingerprint
from fedml_tpu_torch.secure import protocol as tp
from fedml_tpu_torch.secure.protocol import (MSG_SECAGG_UNMASK, SecAggClient,
                                             SecAggError, SecAggServer,
                                             dequantize_np, masked_template,
                                             quantize_np)

CLIP = 64.0


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and isinstance(t, threading.Timer)]
    assert not leaked, leaked


# ---------------------------------------------------------------------------
# protocol-level helpers (both packages have the same API)
# ---------------------------------------------------------------------------

def _run_agreement(server, clients, round_idx, ids):
    server.round_start(round_idx, ids)
    info = server.sync_info()
    adverts = {i: clients[i].begin_round(round_idx, info) for i in ids}
    for i in ids:
        server.note_advert(i, adverts[i])
    rosters = server.flush_roster()
    for i in ids:
        assert clients[i].on_roster(round_idx, rosters[i])
    return adverts, rosters


def _mk(ids, threshold=0, weight_cap=10.0, seed=0, pkg=tp, **kw):
    server = pkg.SecAggServer(threshold=threshold, clip=CLIP,
                              weight_cap=weight_cap, **kw)
    clients = {i: pkg.SecAggClient(i, rng=np.random.RandomState(seed + i))
               for i in ids}
    return server, clients


def _updates(ids, shape=(7,), seed=3):
    rng = np.random.RandomState(seed)
    return {i: {"w": rng.randn(*shape).astype(np.float32),
                "b": {"x": rng.randn(3).astype(np.float32)}} for i in ids}


def _unmask(server, clients, round_idx=0):
    survivors, dead = server.unmask_request()
    for i in survivors:
        server.note_reveal(i, clients[i].reveal(round_idx, survivors, dead))
    return survivors, dead


def _protocol_round(pkg, ids, alive, threshold=0, reference=None, **kw):
    server, clients = _mk(ids, threshold=threshold, pkg=pkg, **kw)
    adverts, rosters = _run_agreement(server, clients, 0, ids)
    ups = _updates(ids)
    masked = {i: clients[i].mask(0, ups[i], 4.0 + i) for i in ids}
    for i in alive:
        server.fold(i, masked[i], 4.0 + i)
    _unmask(server, clients)
    mean, den = server.finalize(reference=reference)
    return adverts, rosters, masked, mean, den


class TestAgainstJax:
    def test_adverts_and_masked_frames_byte_equal(self):
        """Same injected RandomState: the same adverts and rosters, and
        masked upload frames byte-equal through each package's codec."""
        ids = [1, 2, 3, 4, 5]
        j = _protocol_round(jp, ids, ids)
        t = _protocol_round(tp, ids, ids)
        assert t[0] == j[0] and t[1] == j[1]
        for i in ids:
            jm = JMessage(MsgType.C2S_MODEL, i, 0)
            jm.add(JMessage.ARG_MODEL_PARAMS, j[2][i])
            tm = Message(MsgType.C2S_MODEL, i, 0)
            tm.add(Message.ARG_MODEL_PARAMS, t[2][i])
            assert tm.to_bytes() == jm.to_bytes()
        assert t[4] == j[4]
        for a, b in zip(jax.tree.leaves(t[3]), jax.tree.leaves(j[3])):
            assert np.array_equal(a, b)

    def test_dropout_recovery_equals_jax_bit_for_bit(self):
        ids = [1, 2, 3, 4, 5]
        j = _protocol_round(jp, ids, [1, 3, 5], threshold=3)
        t = _protocol_round(tp, ids, [1, 3, 5], threshold=3)
        for a, b in zip(jax.tree.leaves(t[3]), jax.tree.leaves(j[3])):
            assert np.array_equal(a, b)

    def test_sum_level_clip_and_noise_match_jax(self):
        ids = [1, 2, 3]
        ref = {"w": np.zeros(7, np.float32),
               "b": {"x": np.zeros(3, np.float32)}}
        kw = dict(norm_clip=0.5, noise_std=0.1, seed=5)
        j = _protocol_round(jp, ids, ids, reference=ref, **kw)
        t = _protocol_round(tp, ids, ids, reference=ref, **kw)
        for a, b in zip(jax.tree.leaves(t[3]), jax.tree.leaves(j[3])):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)

    def test_prg_mask_is_the_jax_threefry_stream(self):
        shapes = [(3, 4), (1,), (17,)]
        for seed in (5, 2**31 - 2):
            for a, b in zip(tp.prg_mask(seed, 7, shapes),
                            jp.prg_mask(seed, 7, shapes)):
                assert a.dtype == np.uint32 and np.array_equal(a, b)
        layout = tp._Layout(shapes, "cpu")
        flat = layout.stream(9, 2).numpy().astype(np.uint32)
        want = np.concatenate([m.reshape(-1)
                               for m in jp.prg_mask(9, 2, shapes)])
        assert np.array_equal(flat, want)

    def test_quantize_tensor_equals_numpy(self):
        rng = np.random.RandomState(0)
        x = np.concatenate([rng.uniform(-2 * CLIP, 2 * CLIP, 300),
                            [0.5, 1.5, 2.5, -0.5, -1.5] / np.float64(8.0)])
        for scale in (8.0, 2.0**20):
            want = quantize_np(x, scale, CLIP)
            got = tp.quantize_tensor(torch.tensor(x), scale, CLIP).numpy()
            assert np.array_equal(got.astype(np.uint32), want)
            back = tp.dequantize_tensor(torch.tensor(want.astype(np.int64)),
                                        scale).numpy()
            assert np.array_equal(back, dequantize_np(want, scale))


class TestProtocolCore:
    def test_mask_cancellation_bit_exact_uint32(self):
        ids = [1, 2, 3, 4, 5]
        server, clients = _mk(ids)
        _run_agreement(server, clients, 0, ids)
        zero = {"w": np.zeros(11, np.float32)}
        for i in ids:
            server.fold(i, clients[i].mask(0, zero, 5.0), 5.0)
        _, dead = _unmask(server, clients)
        assert dead == []
        mean, den = server.finalize()
        assert den > 0 and np.all(np.asarray(mean["w"]) == 0.0)

    def test_unmasked_ring_sum_equals_sum_of_quantized_uploads(self):
        """The unmasked ring sum is the ring sum of the unmasked quantized
        uploads, word for word (one dropout recovered)."""
        ids = [1, 2, 3, 4]
        server, clients = _mk(ids, threshold=3)
        _run_agreement(server, clients, 0, ids)
        ups = _updates(ids)
        scale = tp.payload_scale(len(ids), CLIP)
        alive = [1, 2, 4]
        want = 0
        for i in alive:
            server.fold(i, clients[i].mask(0, ups[i], 4.0 + i), 4.0 + i)
            u = min((4.0 + i) / 10.0, 1.0)
            q = [quantize_np(l.astype(np.float64) * u, scale, CLIP)
                 for l in tp._canon_leaves(ups[i])]
            q.append(quantize_np(np.asarray([u]), scale, 1.0))
            want = want + np.concatenate(q).astype(np.uint64)
        _unmask(server, clients)
        got = server.unmasked_ring_sum().numpy().astype(np.uint32)
        assert np.array_equal(got, (want % 2**32).astype(np.uint32))

    def test_weighted_mean_within_quantization_tolerance(self):
        ids = [1, 2, 3]
        _, _, _, mean, _ = _protocol_round(tp, ids, ids)
        ups = _updates(ids)
        ns = {i: 4.0 + i for i in ids}
        tot = sum(ns.values())
        want = sum(np.asarray(ups[i]["w"], np.float64) * ns[i]
                   for i in ids) / tot
        np.testing.assert_allclose(mean["w"], want, atol=1e-3)

    def test_beyond_tolerance_fails_loudly(self):
        ids = [1, 2, 3, 4]
        server, clients = _mk(ids, threshold=3)
        _run_agreement(server, clients, 0, ids)
        ups = _updates(ids)
        for i in (1, 2):   # 2 survivors < t=3
            server.fold(i, clients[i].mask(0, ups[i], 5.0), 5.0)
        _unmask(server, clients)
        assert not server.can_finalize()
        with pytest.raises(SecAggError, match="threshold"):
            server.finalize()

    def test_reveal_refusals(self):
        ids = [1, 2, 3]
        server, clients = _mk(ids)
        _run_agreement(server, clients, 0, ids)
        with pytest.raises(SecAggError, match="BOTH"):
            clients[1].reveal(0, survivors=[1, 2], dead=[2, 3])
        first = clients[1].reveal(0, survivors=[1, 2], dead=[3])
        assert clients[1].reveal(0, survivors=[1, 2], dead=[3]) == first
        with pytest.raises(SecAggError, match="flips"):
            clients[1].reveal(0, survivors=[1, 3], dead=[2])

    def test_roster_below_threshold_refused(self):
        ids = [1, 2, 3, 4]
        server, clients = _mk(ids, threshold=3)
        server.round_start(0, ids)
        info = server.sync_info()
        for i in (1, 2):
            server.note_advert(i, clients[i].begin_round(0, info))
        with pytest.raises(SecAggError, match="threshold"):
            server.flush_roster()

    def test_duplicate_sync_does_not_rekey(self):
        server, clients = _mk([1, 2])
        server.round_start(0, [1, 2])
        info = server.sync_info()
        assert clients[1].begin_round(0, info) is \
            clients[1].begin_round(0, info)

    def test_stream_fold_of_masked_uploads_equals_stack(self):
        ids = [1, 2, 3, 4]
        server, clients = _mk(ids)
        _run_agreement(server, clients, 0, ids)
        ups = _updates(ids)
        payloads = [clients[i].mask(0, ups[i], 5.0) for i in ids]
        for i, p in zip(ids, payloads):
            server.fold(i, p, 5.0)
        flat = [np.concatenate([np.asarray(l, np.uint32).reshape(-1)
                                for l in tp._canon_leaves(p)])
                for p in payloads]
        want = functools.reduce(np.add, flat)          # uint32 ring sum
        got = server._round.acc.numpy().astype(np.uint32)
        assert np.array_equal(got, want)

    def test_client_masks_tensors_on_its_device(self):
        """The silo's update may be tensors (the trainer's output); the
        frame is the same as from host arrays."""
        ids = [1, 2]
        frames = []
        for as_tensor in (False, True):
            server, clients = _mk(ids)
            _run_agreement(server, clients, 0, ids)
            up = _updates(ids)[1]
            if as_tensor:
                up = {"w": torch.tensor(up["w"]),
                      "b": {"x": torch.tensor(up["b"]["x"])}}
            frames.append(clients[1].mask(0, up, 5.0))
            assert clients[1].mask_s > 0
        for a, b in zip(jax.tree.leaves(frames[0]),
                        jax.tree.leaves(frames[1])):
            assert np.array_equal(a, b)


class TestQuantization:
    def test_sub_one_clip_keeps_weight_channel_in_budget(self):
        n = 8
        assert n * tp.payload_scale(n, 0.5) < 2.0**31
        ids = list(range(1, n + 1))
        server = SecAggServer(threshold=0, clip=0.5, weight_cap=10.0)
        clients = {i: SecAggClient(i, rng=np.random.RandomState(i))
                   for i in ids}
        _run_agreement(server, clients, 0, ids)
        upd = {"w": np.full(4, 0.25, np.float32)}
        for i in ids:
            server.fold(i, clients[i].mask(0, upd, 10.0), 10.0)
        _unmask(server, clients)
        mean, den = server.finalize()
        assert den > 0
        np.testing.assert_allclose(mean["w"], 0.25, atol=1e-3)

    def test_round_trip_clip_and_twos_complement(self):
        x = np.random.RandomState(0).uniform(-CLIP, CLIP, 500)
        scale = 2.0**20
        assert np.max(np.abs(dequantize_np(quantize_np(x, scale, CLIP),
                                           scale) - x)) <= 0.5 / scale + 1e-12
        np.testing.assert_allclose(dequantize_np(quantize_np(
            np.asarray([CLIP * 3, -CLIP * 3]), 2.0**16, CLIP), 2.0**16),
            [CLIP, -CLIP])
        q = quantize_np(np.asarray([-1.0]), 2.0**10, CLIP)
        assert q.dtype == np.uint32 and q[0] > 2**31
        assert dequantize_np(q, 2.0**10)[0] == -1.0


class TestMaskedAdmission:
    def test_fingerprint_screens_pre_mask_removal(self):
        params = {"w": np.zeros(5, np.float32)}
        pipe = AdmissionPipeline(masked_template(params), kind="masked")
        server, clients = _mk([1, 2])
        _run_agreement(server, clients, 0, [1, 2])
        masked = clients[1].mask(0, {"w": np.ones(5, np.float32)}, 5.0)
        v = pipe.admit(1, masked, 5.0, None, 0)
        assert v.ok and v.norm is None
        v2 = pipe.admit(2, params, 5.0, None, 0)
        assert not v2.ok and v2.reason == "fingerprint"
        assert pipe.rejected["fingerprint"] == 1

    def test_num_samples_screen_and_template_fingerprint(self):
        params = {"a": {"w": np.zeros((2, 3), np.float32)},
                  "b": np.zeros(4, np.float32)}
        pipe = AdmissionPipeline(masked_template(params), kind="masked",
                                 max_num_samples=10)
        server, clients = _mk([1, 2])
        _run_agreement(server, clients, 0, [1, 2])
        masked = clients[1].mask(0, params, 3.0)
        assert params_fingerprint(masked_template(params)) == \
            params_fingerprint(masked)
        assert not pipe.admit(1, masked, 1e9, None, 0).ok
        assert pipe.rejected["bad_num_samples"] == 1

    def test_masked_kind_agrees_with_jax(self):
        params = {"w": np.zeros(5, np.float32)}
        server, clients = _mk([1, 2])
        _run_agreement(server, clients, 0, [1, 2])
        masked = clients[1].mask(0, {"w": np.ones(5, np.float32)}, 5.0)
        for upload, n in ((masked, 5.0), (params, 5.0), (masked, -1.0)):
            a = AdmissionPipeline(masked_template(params), kind="masked")
            b = JAdmission(jp.masked_template(params), kind="masked")
            va, vb = a.admit(1, upload, n, None, 0), b.admit(1, upload, n,
                                                              None, 0)
            assert (va.ok, va.reason, va.norm) == (vb.ok, vb.reason,
                                                   vb.norm)


# ---------------------------------------------------------------------------
# live federations over the hub (pump mode, deterministic)
# ---------------------------------------------------------------------------

def _train_fn(silo_id):
    def fn(params, client_idx, round_idx):
        return {k: np.asarray(v, np.float32) + np.float32(0.1 * silo_id)
                for k, v in params.items()}, 4.0 + silo_id
    return fn


class _Spy:
    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def send_message(self, msg):
        self._log.append(msg)
        self._inner.send_message(msg)

    def send_many(self, messages):
        self._log.extend(messages)
        self._inner.send_many(messages)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _SwallowUploads:
    def __init__(self, inner, held=None):
        self._inner, self._held = inner, held

    def send_message(self, msg):
        if msg.type == MsgType.C2S_MODEL:
            if self._held is not None:
                self._held.append(msg)
            return
        self._inner.send_message(msg)

    def __getattr__(self, name):
        return getattr(self._inner, name)


INIT = {"w": np.zeros(6, np.float32), "v": np.zeros(2, np.float32)}


def _federation(server_pkg="torch", silo_pkg="torch", n=4, rounds=1,
                swallow=(), spy=None, straggler_policy="wait", held=None,
                seeded=False):
    hub = (JHub if server_pkg == "jax" else LocalHub)(codec_roundtrip=True)

    def wrap(t, i):
        if i in swallow:
            t = _SwallowUploads(t, held=held)
        return _Spy(t, spy) if spy is not None else t

    timeout = 120.0 if straggler_policy == "drop" else None
    if server_pkg == "jax":
        server = jcs.FedAvgServerActor(
            wrap(hub.transport(0), 0), INIT, client_num_in_total=n,
            client_num_per_round=n, num_rounds=rounds,
            straggler_policy=straggler_policy, round_timeout_s=timeout,
            admission=JAdmission(jp.masked_template(INIT), kind="masked"),
            secagg=jp.SecAggServer(threshold=0, clip=CLIP, weight_cap=10.0))
    else:
        server = FedAvgServerActor(
            wrap(hub.transport(0), 0),
            {k: torch.tensor(v) for k, v in INIT.items()}, n, n, rounds,
            straggler_policy=straggler_policy, round_timeout_s=timeout,
            admission=AdmissionPipeline(masked_template(INIT),
                                        kind="masked"),
            secagg=SecAggServer(threshold=0, clip=CLIP, weight_cap=10.0))
    server.register_handlers()
    silos = []
    for i in range(1, n + 1):
        rng = np.random.RandomState(i) if seeded else None
        if silo_pkg == "jax":
            c = jcs.FedAvgClientActor(i, wrap(hub.transport(i), i),
                                      _train_fn(i),
                                      secagg=jp.SecAggClient(i, rng=rng))
        else:
            c = FedAvgClientActor(i, wrap(hub.transport(i), i), _train_fn(i),
                                  secagg=SecAggClient(i, rng=rng))
        c.register_handlers()
        silos.append(c)
    return hub, server, silos


def _expected_mean(ids):
    w = {i: 4.0 + i for i in ids}
    tot = sum(w.values())
    return {k: sum((v.astype(np.float64) + 0.1 * i) * w[i]
                   for i in ids) / tot for k, v in INIT.items()}


def _global(server):
    return {k: np.asarray(v) for k, v in server.params.items()}


class TestLiveRounds:
    def test_clean_round_matches_plaintext_mean(self):
        hub, server, _ = _federation()
        server.start()
        hub.pump()
        want = _expected_mean([1, 2, 3, 4])
        for k in INIT:
            np.testing.assert_allclose(_global(server)[k], want[k],
                                       atol=1e-3)

    @pytest.mark.parametrize("server_pkg,silo_pkg",
                             [("jax", "torch"), ("torch", "jax")])
    def test_mixed_federation_matches_the_jax_run(self, server_pkg,
                                                  silo_pkg):
        """A JAX server with port silos and a port server with JAX silos:
        the masks cancel, and after two rounds the global is bit-equal to
        the all-JAX federation's; every masked upload frame is byte-equal
        to the JAX silo's under the same injected RandomState."""
        frames = {}
        globs = {}
        for combo in (("jax", "jax"), (server_pkg, silo_pkg)):
            spy = []
            hub, server, _ = _federation(*combo, rounds=2, spy=spy,
                                         seeded=True)
            server.start()
            hub.pump()
            assert server.round_idx == 2
            globs[combo] = _global(server)
            frames[combo] = sorted(
                (m.get(Message.ARG_ROUND), m.sender_id, m.to_bytes())
                for m in spy if m.type == MsgType.C2S_MODEL)
        assert frames[("jax", "jax")] == frames[(server_pkg, silo_pkg)]
        for k in INIT:
            assert np.array_equal(globs[("jax", "jax")][k],
                                  globs[(server_pkg, silo_pkg)][k])

    def test_dropout_mid_round_recovers_via_shares(self):
        reg = telemetry.enable()
        try:
            hub, server, _ = _federation(swallow={3},
                                         straggler_policy="drop")
            server.start()
            hub.pump()
            assert server._secagg_stage == "upload"
            server.send(MsgType.ROUND_TIMEOUT, 0,
                        **{Message.ARG_ROUND: server.round_idx})
            hub.pump()
            want = _expected_mean([1, 2, 4])
            for k in INIT:
                np.testing.assert_allclose(_global(server)[k], want[k],
                                           atol=1e-3)
            snap = reg.snapshot()["counters"]
            assert any("pair_key" in k and v >= 1 for k, v in snap.items()
                       if k.startswith(
                           "fedml_secagg_unmask_reconstructions")), snap
        finally:
            telemetry.disable()

    def test_straggler_landing_mid_unmask_is_discarded(self):
        held = []
        hub, server, _ = _federation(swallow={3}, straggler_policy="drop",
                                     held=held)
        server.start()
        hub.pump()
        assert len(held) == 1 and server._secagg_stage == "upload"
        tmo = Message(MsgType.ROUND_TIMEOUT, 0, 0)
        tmo.add(Message.ARG_ROUND, server.round_idx)
        server.receive_message(MsgType.ROUND_TIMEOUT, tmo)
        assert server._secagg_stage == "unmask"
        server.receive_message(MsgType.C2S_MODEL, held[0])
        assert 3 not in server.secagg.folded_silos()
        hub.pump()
        want = _expected_mean([1, 2, 4])
        for k in INIT:
            np.testing.assert_allclose(_global(server)[k], want[k],
                                       atol=1e-3)

    def test_privacy_probe_no_plaintext_update_on_any_frame(self):
        spy = []
        hub, server, _ = _federation(spy=spy)
        server.start()
        hub.pump()
        true = {i: {k: v.astype(np.float64) + 0.1 * i
                    for k, v in INIT.items()} for i in range(1, 5)}
        uploads = [m for m in spy if m.type == MsgType.C2S_MODEL]
        assert len(uploads) == 4
        for m in uploads:
            payload = m.get(Message.ARG_MODEL_PARAMS)
            assert set(payload) == {"q", "w"}
            for leaf in (payload["q"]["v"], payload["q"]["w"], payload["w"]):
                assert np.asarray(leaf).dtype == np.uint32
            for k in ("w", "v"):
                deq = dequantize_np(np.asarray(payload["q"][k]), 2.0**20)
                assert not np.allclose(deq, true[m.sender_id][k], atol=0.5)
        for m in spy:
            payload = m.get(Message.ARG_MODEL_PARAMS)
            if not isinstance(payload, dict):
                continue
            inner = payload.get("q", payload)
            for upd in true.values():
                for k in ("w", "v"):
                    leaf = inner.get(k)
                    if leaf is None or np.asarray(leaf).dtype == np.uint32:
                        continue
                    assert not np.allclose(np.asarray(leaf, np.float64),
                                           upd[k], atol=1e-6)
        for m in spy:
            if m.type == MSG_SECAGG_UNMASK:
                info = m.get(Message.ARG_SECAGG)
                assert not set(info["survivors"]) & set(info["dead"])

    def test_sync_without_masking_params_never_uploads_plaintext(self):
        spy = []
        hub = LocalHub(codec_roundtrip=True)
        c = FedAvgClientActor(1, _Spy(hub.transport(1), spy), _train_fn(1),
                              secagg=SecAggClient(1))
        c.register_handlers()
        msg = Message(MsgType.S2C_SYNC, 0, 1)
        msg.add(Message.ARG_MODEL_PARAMS, dict(INIT))
        msg.add(Message.ARG_CLIENT_INDEX, 0)
        msg.add(Message.ARG_ROUND, 3)
        c.receive_message(MsgType.S2C_SYNC, msg)
        assert not any(m.type == MsgType.C2S_MODEL for m in spy)

    def test_actor_gates(self):
        from fedml_tpu_torch.core.stream_agg import StreamingAggregator
        from fedml_tpu_torch.server_opt import ServerOptimizer
        init = {k: torch.tensor(v) for k, v in INIT.items()}
        with pytest.raises(ValueError, match="exclusive"):
            FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                              stream_agg=StreamingAggregator(init),
                              secagg=SecAggServer())
        with pytest.raises(ValueError, match="server_opt and secagg"):
            FedAvgServerActor(LocalHub().transport(0), init, 2, 2, 1,
                              secagg=SecAggServer(),
                              server_opt=ServerOptimizer("adam", init))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_BASE = ["--algo", "cross_silo", "--model", "lr", "--dataset", "mnist",
         "--client_num_in_total", "4", "--client_num_per_round", "4",
         "--comm_round", "2", "--frequency_of_the_test", "2",
         "--batch_size", "4", "--log_stdout", "false", "--platform", "cpu"]


def _cli(*extra):
    return main(_BASE + list(extra))


class TestCli:
    def test_pairwise_and_plaintext_agree(self):
        plain = _cli("--agg_mode", "stream")
        pairwise = _cli("--secagg", "pairwise", "--agg_mode", "stream")
        assert abs(pairwise["test_loss"] - plain["test_loss"]) < 1e-3
        assert abs(pairwise["train_acc"] - plain["train_acc"]) < 1e-6
        assert pairwise["params_finite"]

    @pytest.mark.parametrize("flags,exc,match", [
        (["--algo", "fedavg"], ValueError, "cross_silo only"),
        (["--robust_agg", "krum"], ValueError, "order-statistic"),
        ([], ValueError, "agg_mode stream"),
        (["--model_shards", "2"], ValueError, "mutually exclusive"),
        (["--silo_backend", "grpc"], ValueError, "local hub only"),
        (["--secagg_threshold", "5"], ValueError, "exceeds the smallest"),
        (["--secagg_threshold", "1"], ValueError, "privacy"),
        (["--server_opt", "adam"], ValueError, "mutually exclusive"),
        (["--client_num_per_round", "1"], ValueError, ">= 2 silos"),
    ])
    def test_incompatible_combos_fail_at_config_time(self, flags, exc,
                                                     match):
        agg = [] if flags == [] else ["--agg_mode", "stream"]
        if flags[:2] == ["--model_shards", "2"]:
            agg = ["--agg_mode", "stream"]
        cfg = config_from_argv(_BASE + ["--secagg", "pairwise"] + agg
                               + flags)
        with pytest.raises(exc, match=match):
            check_config(cfg)

    def test_grouped_is_refused_naming_its_item(self):
        # grouped masking is ported: without the edge tier it names the
        # flag it needs, as the JAX package's gate does
        with pytest.raises(ValueError, match="needs --edge_aggregators"):
            check_config(config_from_argv(
                _BASE + ["--secagg", "grouped", "--agg_mode", "stream"]))
