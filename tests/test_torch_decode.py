"""Incremental decode and the continuous-batching scheduler of the port,
against the JAX package on carried weights.

The decode step's logits and KV cache after N steps equal the flax
model's within 1e-5 x max|ref| (f32 sums in another order), for the dense
and the MoE transformer; slots are isolated and a reused slot reads none
of its previous occupant's rows; the refusals are JAX's.  The port's
`DecodeScheduler` decodes the same tokens as JAX's on the same requests,
in continuous and drain mode, with joins in mid-flight; the swap barrier
keeps a sequence on one version; the step is built once (the eager build
here, the CUDA-graph capture on the card) and the sentry and the compile
ledger see it; truncation, shedding, the tier gate, drain on stop and the
queue gauge behave as JAX's."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as JLM
from fedml_tpu.models.transformer import init_decode_cache as j_init_cache
from fedml_tpu.serve.decode import DecodeScheduler as JDecodeScheduler
from fedml_tpu.serve.registry import ModelRegistry as JModelRegistry
from fedml_tpu_torch.models.transformer import TransformerLM, init_decode_cache
from fedml_tpu_torch.serve.batcher import ShedError
from fedml_tpu_torch.serve.decode import DecodeScheduler
from fedml_tpu_torch.serve.registry import ModelRegistry
from fedml_tpu_torch.trainer.workload import apply_model
from fedml_tpu_torch.utils.jax_params import params_from_numpy

VOCAB = 61
TOL = 1e-5          # x max|ref|


def _kw(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2,
               d_ff=64, max_len=64)
    cfg.update(kw)
    return cfg


def _pair(seed=0, **kw):
    """(JAX model, its variables, the port's model, the carried flat
    params)."""
    jm = JLM(**_kw(**kw))
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    flat = params_from_numpy(jax.tree.map(np.asarray, jp["params"]))
    return jm, jp, TransformerLM(**_kw(**kw)), flat


def _loaded(model, flat):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(flat[name.replace(".", "/")])
    return model


def _step(model, tokens, positions, cache):
    with torch.no_grad():
        return model(torch.tensor(tokens), positions=torch.tensor(
            positions).long(), cache=cache)


def _registry(params, version=0):
    reg = ModelRegistry(lambda p, x: x, history=8, device="cpu")
    reg.publish(params, version)
    return reg


def _ref_greedy(model, params, prompt, max_new):
    """Greedy decode by the FULL forward every step: the oracle."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        with torch.no_grad():
            logits = apply_model(model, params, torch.tensor([toks]))
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return out


# -- the decode step against flax ---------------------------------------------

@pytest.mark.parametrize("moe", [0, 2])
def test_decode_logits_and_cache_match_jax(moe):
    """N steps, three slots at different positions each step (slots 1
    and 2 rewrite rows they already wrote): logits and the cache after
    the last step equal flax's; slot 0's last logits also equal the
    port's own full forward."""
    jm, jp, tm, flat = _pair(moe_experts=moe)
    _loaded(tm, flat)
    b, steps, tc = 3, 12, 16
    seq = np.random.RandomState(2).randint(0, VOCAB, (b, steps))
    jc, tc_ = j_init_cache(jm, b, tc), init_decode_cache(tm, b, tc)
    for t in range(steps):
        pos = np.array([t, max(t - 2, 0), t // 2], np.int64)
        want, jc = jm.apply(jp, jnp.asarray(seq[:, t], jnp.int32),
                            positions=jnp.asarray(pos, jnp.int32), cache=jc)
        got, tc_ = _step(tm, seq[:, t], pos, tc_)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    for i in range(2):
        for kv in ("k", "v"):
            ref = np.asarray(jc[f"attn_{i}"][kv])
            err = np.abs(tc_[f"attn_{i}"][kv].numpy() - ref).max()
            assert err <= TOL * np.abs(ref).max(), (i, kv, err)
    if not moe:
        # slot 0 walked the whole sequence: the full forward's last row
        with torch.no_grad():
            full = apply_model(tm, flat, torch.tensor(seq[:1]))[0, -1]
        assert (got[0] - full).abs().max() <= TOL * full.abs().max()


def test_decode_slots_are_isolated_and_positions_independent():
    """Two sequences in one batch at DIFFERENT positions match each
    decoded alone."""
    _, _, tm, flat = _pair()
    _loaded(tm, flat)
    rng = np.random.RandomState(0)
    seq_a, seq_b = rng.randint(0, VOCAB, 8), rng.randint(0, VOCAB, 8)

    def alone(seq, upto):
        cache = init_decode_cache(tm, 1, 16)
        for t in range(upto + 1):
            logits, cache = _step(tm, [seq[t]], [t], cache)
        return logits[0]

    cache = init_decode_cache(tm, 2, 16)
    for t in range(3):
        logits, cache = _step(tm, [seq_a[t], 0], [t, 0], cache)
    for i in range(4):
        logits, cache = _step(tm, [seq_a[3 + i], seq_b[i]], [3 + i, i],
                              cache)
    torch.testing.assert_close(logits[0], alone(seq_a, 6), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(logits[1], alone(seq_b, 3), atol=1e-5,
                               rtol=1e-5)


def test_slot_reuse_masks_previous_occupant():
    """A slot restarting at position 0 over a dirty cache decodes exactly
    like a fresh cache."""
    _, _, tm, flat = _pair()
    _loaded(tm, flat)
    rng = np.random.RandomState(1)
    first, second = rng.randint(0, VOCAB, 10), rng.randint(0, VOCAB, 5)
    dirty = init_decode_cache(tm, 1, 16)
    for t, tok in enumerate(first):
        _, dirty = _step(tm, [tok], [t], dirty)
    fresh = init_decode_cache(tm, 1, 16)
    for t, tok in enumerate(second):
        out_d, dirty = _step(tm, [tok], [t], dirty)
        out_f, fresh = _step(tm, [tok], [t], fresh)
        torch.testing.assert_close(out_d, out_f, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["positions", "ring_axis", "max_len"])
def test_decode_refusals_match_jax(case):
    """The refusals are JAX's, in JAX's words."""
    jm, jp, tm, _ = _pair(max_len=32)
    if case == "max_len":
        for init, model in ((j_init_cache, jm), (init_decode_cache, tm)):
            with pytest.raises(ValueError, match="max_len"):
                init(model, 2, 64)
        return
    jc, tc = j_init_cache(jm, 1, 8), init_decode_cache(tm, 1, 8)
    kw = ({} if case == "positions" else
          {"ring_axis": "seq"})
    jpos = {} if case == "positions" else {"positions": jnp.asarray([0])}
    tpos = {} if case == "positions" else {"positions": torch.tensor([0])}
    with pytest.raises(ValueError, match=case):
        jm.apply(jp, jnp.asarray([1]), cache=jc, **jpos, **kw)
    with pytest.raises(ValueError, match=case):
        tm(torch.tensor([1]), cache=tc, **tpos, **kw)


# -- the scheduler -------------------------------------------------------------

def _prompts(n=7, seed=3):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, VOCAB, size=rng.randint(1, 6)))
            for _ in range(n)]


@pytest.mark.parametrize("continuous", [True, False])
def test_scheduler_tokens_equal_jax_with_mid_flight_joins(continuous):
    """More requests than slots: later requests join as earlier ones
    finish, and the port's scheduler decodes the same tokens as JAX's on
    the same requests, each equal to the full-forward oracle."""
    jm, jp, tm, flat = _pair()
    prompts = _prompts()
    max_news = [5 if i % 3 else 9 for i in range(len(prompts))]
    jreg = JModelRegistry(lambda p, x: x, history=8)
    jreg.publish(jp, 0)
    jsched = JDecodeScheduler(jreg, jm, slots=2, cache_len=32,
                              continuous=continuous).start()
    want = [f.result(120).tokens for f in
            [jsched.submit(p, max_new=m) for p, m in zip(prompts, max_news)]]
    jsched.stop()
    sched = DecodeScheduler(_registry(flat), tm, slots=2, cache_len=32,
                            continuous=continuous).start()
    assert sched.warmup()
    res = [f.result(60) for f in
           [sched.submit(p, max_new=m) for p, m in zip(prompts, max_news)]]
    sched.stop()
    assert [r.tokens for r in res] == want
    assert all(r.version == 0 and not r.truncated for r in res)
    for p, m, r in zip(prompts[:3], max_news, res):
        assert r.tokens == _ref_greedy(tm, flat, p, m)
    assert sched._cache_size() == 1, "mid-flight joins rebuilt the step"


def test_drain_mode_admits_only_when_all_slots_free():
    """The drain baseline's occupancy sits well below continuous, with
    the same tokens."""
    _, _, tm, flat = _pair()
    reg = _registry(flat)
    results = {}
    for continuous in (False, True):
        sched = DecodeScheduler(reg, tm, slots=4, cache_len=32,
                                continuous=continuous).start()
        assert sched.warmup()
        futs = [sched.submit([1 + i], max_new=20 if i % 4 == 0 else 3)
                for i in range(16)]
        toks = [f.result(60).tokens for f in futs]
        results[continuous] = (sched.occupancy(), toks)
        sched.stop()
    assert results[False][1] == results[True][1]
    assert results[True][0] > results[False][0] * 1.5, results


def test_swap_barrier_pins_version_for_in_flight_sequences():
    """A publish mid-generation never touches live sequences: they finish
    on the pinned version, admission pauses, and the next request gets
    the new one — each version's tokens its own oracle's, one build."""
    _, _, tm, params0 = _pair(seed=0)
    params1 = {k: v - 0.02 for k, v in params0.items()}
    reg = _registry(params0)
    sched = DecodeScheduler(reg, tm, slots=2, cache_len=32,
                            max_new=24).start()
    assert sched.warmup()
    futs = [sched.submit([5, 6], max_new=24) for _ in range(2)]
    deadline = time.monotonic() + 10
    while sched.steps < 3 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert sched.steps >= 3, "sequences never started"
    reg.publish(params1, 1)
    late = sched.submit([7, 8], max_new=4)
    for f in futs:
        r = f.result(60)
        assert r.version == 0, "swap landed mid-sequence"
        assert r.tokens == _ref_greedy(tm, params0, [5, 6], 24)
    r = late.result(60)
    assert r.version == 1, "post-drain admission kept the stale snapshot"
    assert r.tokens == _ref_greedy(tm, params1, [7, 8], 4)
    assert sched._cache_size() == 1
    sched.stop()


def test_scheduler_builds_once_registered_with_sentry_and_ledger():
    from fedml_tpu_torch.obs.device import DeviceRecorder
    from fedml_tpu_torch.obs.perf import RecompileSentry
    _, _, tm, flat = _pair()
    sched = DecodeScheduler(_registry(flat), tm, slots=2, cache_len=16)
    recorder = DeviceRecorder(cost_analysis=False)
    sentry = RecompileSentry(strict=True)
    name = sched.register_obs(recorder, sentry)
    assert name == "decode_step[s2,c16]"
    assert sentry.names() == [name]
    recorder.round_start()
    assert sched.warmup()
    compiles = recorder.round_snapshot(None)["compiles"]
    assert any(c["fn"] == name for c in compiles), compiles
    sentry.check(0)
    sched.start()
    recorder.round_start()
    for f in [sched.submit([1, 2], max_new=4) for _ in range(5)]:
        f.result(60)
    assert sentry.check(1) == {}, "decode step rebuilt under load"
    assert recorder.round_snapshot(None)["compiles"] == []
    assert sched._cache_size() == 1
    # the step's FLOPs come from its formula, never a counter around it
    assert sched._step.flops() > 0
    sched.stop()


def test_truncation_at_cache_bucket_is_flagged():
    _, _, tm, flat = _pair()
    sched = DecodeScheduler(_registry(flat), tm, slots=1, cache_len=8,
                            max_new=32).start()
    assert sched.warmup()
    r = sched.generate([1, 2, 3], max_new=32)
    assert len(r.tokens) == 5 and r.truncated
    r2 = sched.generate([1, 2, 3], max_new=5)
    assert len(r2.tokens) == 5 and not r2.truncated
    with pytest.raises(ValueError, match="does not fit"):
        sched.submit(list(range(1, 9)))
    sched.stop()


def test_decode_shedding_queue_full_deadline_shutdown_no_model():
    _, _, tm, flat = _pair()
    empty = ModelRegistry(lambda p, x: x, history=4, device="cpu")
    sched = DecodeScheduler(empty, tm, slots=1, cache_len=16,
                            queue_depth=2).start()
    with pytest.raises(ShedError, match="no_model"):
        sched.submit([1], max_new=2).result(30)
    sched.stop()

    reg = _registry(flat)
    sched2 = DecodeScheduler(reg, tm, slots=1, cache_len=16, queue_depth=2)
    sched2.submit([1])
    sched2.submit([1])
    with pytest.raises(ShedError, match="queue_full"):
        sched2.submit([1])
    sched2.stop(drain=False)
    with pytest.raises(ShedError, match="shutdown"):
        sched2.submit([1])

    sched3 = DecodeScheduler(reg, tm, slots=1, cache_len=16)
    doomed = sched3.submit([1], deadline_s=0.0)
    time.sleep(0.01)
    sched3.start()
    with pytest.raises(ShedError, match="deadline"):
        doomed.result(30)
    sched3.stop()


def test_decode_tier_gate_sheds_best_effort_on_breach():
    class _Gate:
        bad = False

        def degraded(self):
            return self.bad

    _, _, tm, flat = _pair()
    gate = _Gate()
    sched = DecodeScheduler(_registry(flat), tm, slots=1, cache_len=16,
                            slo=gate).start()
    assert sched.warmup()
    assert sched.generate([1], max_new=2, tier="best_effort").tokens
    gate.bad = True
    with pytest.raises(ShedError, match="slo_degraded"):
        sched.submit([1], tier="best_effort")
    assert sched.generate([1], max_new=2).tokens
    with pytest.raises(ValueError, match="unknown tier"):
        sched.submit([1], tier="bulk")
    sched.stop()


def test_drain_on_stop_answers_queued_sequences():
    _, _, tm, flat = _pair()
    reg = _registry(flat)
    sched = DecodeScheduler(reg, tm, slots=2, cache_len=16, max_new=3)
    futs = [sched.submit([1 + i], max_new=3) for i in range(5)]
    sched.start()
    sched.stop(drain=True)
    for f in futs:
        assert len(f.result(0).tokens) == 3
    sched2 = DecodeScheduler(reg, tm, slots=2, cache_len=16, max_new=3)
    futs2 = [sched2.submit([2 + i], max_new=3) for i in range(3)]
    sched2.stop(drain=True)
    for f in futs2:
        assert len(f.result(0).tokens) == 3


def test_queue_utilization_gauge_recovers_after_burst():
    from fedml_tpu_torch.obs import telemetry
    telemetry.enable()
    try:
        _, _, tm, flat = _pair()
        sched = DecodeScheduler(_registry(flat), tm, slots=2, cache_len=16,
                                max_new=2, queue_depth=8)
        futs = [sched.submit([1 + i], max_new=2) for i in range(8)]

        def gauges():
            snap = telemetry.get_registry().snapshot()
            return [v for k, v in snap["gauges"].items()
                    if k.startswith("fedml_serve_queue_utilization_ratio")]

        assert max(gauges()) == 1.0, "burst never registered"
        sched.start()
        for f in futs:
            f.result(60)
        deadline = time.monotonic() + 10
        while max(gauges()) != 0.0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert max(gauges()) == 0.0, "gauge latched after the drain"
        sched.stop()
    finally:
        telemetry.disable()


def test_scheduler_threads_end_on_stop():
    _, _, tm, flat = _pair()
    sched = DecodeScheduler(_registry(flat), tm, slots=1, cache_len=8)
    sched.start()
    sched.stop()
    assert not [t for t in threading.enumerate()
                if t.name == "serve-decode"]
