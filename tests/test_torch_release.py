"""The port's release gate (`fedml_tpu_torch.serve.release`) and the
registry's canary states: the twins of the JAX package's release tests,
and the poisoned cross-device fixture run through both packages.

A canary never occupies the live slot: promotion is the only way in.
`_divergence` equals JAX's on the same arrays.  On the JAX package's
poisoned fixture (``--wave_adversary 3:0:scale:1000000``, 4 rounds, 64
shadow rows, budget 0.1) the port's verdicts and shadow divergences equal
JAX's from JAX's init, the poisoned version 4 is never live and fails on
the shadow signal alone.  (The clean versions 2 and 3 roll back too, in
both packages: their first globals move about half the argmaxes, so the
budget does not separate them from the poison on this fixture — the JAX
package's own test of promotions there fails for that reason.)"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from fedml_tpu.serve.release import _divergence as j_divergence
from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                              DiskFaultInjector,
                                              DiskFaultSpec, Faultline)
from fedml_tpu_torch.serve.batcher import MicroBatcher
from fedml_tpu_torch.serve.registry import ModelRegistry
from fedml_tpu_torch.serve.release import (ReleaseController, ShadowSampler,
                                           _divergence)
from fedml_tpu_torch.utils.journal import tree_crc

DIM, CLASSES = 6, 4


def _registry(*promoted, history=8):
    reg = ModelRegistry(
        lambda p, x: x.reshape(x.shape[0], -1) @ p["w"] + p["b"],
        history=history, device="cpu")
    for v in promoted:
        reg.publish(_params(v), v)
    return reg


def _params(version: int):
    w = np.zeros((DIM, CLASSES), np.float32)
    w[0, :] = float(version)
    b = np.zeros(CLASSES, np.float32)
    b[version % CLASSES] = 1.0
    return {"w": w, "b": b}


def _controller(reg, **kw):
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("max_cooldown_s", 0.0)
    return ReleaseController(reg, **kw)


# -- the registry's canary states ---------------------------------------------

class TestRegistryCanaryStates:
    def test_canary_publish_never_swaps_live(self):
        reg = _registry(1)
        assert reg.publish(_params(2), 2, canary=True)
        assert reg.version == 1 and reg.state(2) == "canary"
        assert reg.canaries() == [2] and reg.get(2).version == 2

    def test_promote_swaps_live_pins_and_is_idempotent(self):
        reg = _registry(1)
        reg.publish(_params(2), 2, canary=True)
        assert reg.promote(2) == 2
        assert reg.version == 2 and reg.pinned == 2
        assert reg.state(2) == "promoted" and reg.promote(2) == 2

    def test_promote_promoted_but_not_live_refuses(self):
        reg = _registry(1, 2)
        reg.pin(1)
        with pytest.raises(RuntimeError, match="promoted but not live"):
            reg.promote(2)

    def test_discard_removes_canary_only_and_number_is_reusable(self):
        reg = _registry(1)
        reg.publish(_params(2), 2, canary=True)
        reg.discard(2)
        assert reg.versions() == [1] and reg.canaries() == []
        with pytest.raises(RuntimeError, match="promoted"):
            reg.discard(1)
        with pytest.raises(KeyError):
            reg.discard(99)
        assert reg.publish(_params(2), 2, canary=True)

    def test_rollback_skips_canaries_and_stops_at_the_horizon(self):
        reg = _registry(1, 2)
        reg.publish(_params(3), 3, canary=True)
        reg.publish(_params(4), 4)
        assert reg.rollback() == 2 and reg.version == 2
        lone = _registry()
        lone.publish(_params(1), 1, canary=True)
        lone.publish(_params(2), 2)
        with pytest.raises(RuntimeError, match="promoted horizon"):
            lone.rollback()
        assert lone.version == 2

    def test_pin_refuses_canary_and_unpin_skips_it(self):
        reg = _registry(1, 2)
        reg.publish(_params(3), 3, canary=True)
        with pytest.raises(RuntimeError, match="unvetted canary"):
            reg.pin(3)
        reg.pin(1)
        reg.unpin()
        assert reg.version == 2

    def test_eviction_protects_pending_canaries(self):
        reg = _registry(history=2)
        reg.publish(_params(1), 1, canary=True)
        for v in (2, 3, 4, 5):
            reg.publish(_params(v), v)
        assert 1 in reg.versions()
        reg.discard(1)
        reg.publish(_params(6), 6)
        assert 1 not in reg.versions()


# -- the shadow sampler ----------------------------------------------------------

class TestShadowSampler:
    @pytest.mark.parametrize("kw", [dict(every=0), dict(slots=0)])
    def test_validates(self, kw):
        with pytest.raises(ValueError):
            ShadowSampler(**kw)

    def test_every_nth_and_determinism(self):
        def run():
            s = ShadowSampler(every=3, slots=4)
            for i in range(20):
                s.offer(np.full(2, float(i), np.float32))
            return [r[0] for r in s.snapshot()]
        a, b = run(), run()
        assert a == b and sorted(a) == [9.0, 12.0, 15.0, 18.0]

    def test_snapshot_copies_are_owned(self):
        s = ShadowSampler(every=1, slots=2)
        x = np.zeros(2, np.float32)
        s.offer(x)
        x[:] = 7.0
        assert s.snapshot()[0][0] == 0.0

    def test_batcher_taps_admitted_traffic(self):
        reg = _registry(1)
        shadow = ShadowSampler(every=2, slots=8)
        b = MicroBatcher(reg, buckets=(1, 2, 4), shadow=shadow,
                         max_delay_s=0.01).start()
        try:
            for f in [b.submit(np.full(DIM, float(i), np.float32))
                      for i in range(6)]:
                f.result(10)
        finally:
            b.stop()
        assert len(shadow.snapshot()) == 3


# -- the divergence ------------------------------------------------------------------

def _divergence_cases():
    rng = np.random.RandomState(0)
    eye = np.eye(4, dtype=np.float32)
    flip = eye.copy()
    flip[0] = [0, 9, 0, 0]
    ones = np.ones((8, 1), np.float32) * 100
    nan = np.ones((4, 1), np.float32)
    nan_c = nan.copy()
    nan_c[1] = np.nan
    logits = rng.randn(64, 10).astype(np.float32)
    return {"argmax_same": (eye, eye, 0.0), "argmax_flip": (eye, flip, 0.25),
            "scalar_tol": (ones, ones * (1 + 1e-6), 0.0),
            "scalar_far": (ones, ones * 1.5, 1.0),
            "nonfinite": (nan, nan_c, 0.25),
            "logits": (logits, logits + 0.3 * rng.randn(64, 10).astype(
                np.float32), None)}


@pytest.mark.parametrize("case", list(_divergence_cases()))
def test_divergence_equals_jax(case):
    a, b, want = _divergence_cases()[case]
    got = _divergence(a, b)
    assert got == j_divergence(a, b)
    if want is not None:
        assert got == want


# -- the verdict matrix: each signal failing alone --------------------------------

class _FakeHealth:
    def __init__(self, round_idx, ok):
        self._h = {"round": round_idx,
                   "alarms": {"drift": {"value": 1.0, "threshold": 2.0,
                                        "ok": ok}}}

    def healthz(self):
        return self._h


def _shadowed(rows=8):
    shadow = ShadowSampler(every=1, slots=rows)
    for i in range(rows):
        x = np.zeros(DIM, np.float32)
        x[0] = float(i + 1)
        shadow.offer(x)
    return shadow


class TestVerdictMatrix:
    def test_all_pass_promotes(self):
        reg = _registry(1)
        rc = _controller(reg, shadow=_shadowed(),
                         health=_FakeHealth(2, ok=True),
                         eval_fn=lambda p: 0.9)
        v = rc.offer(_params(1), 2, round_idx=2)
        assert v["decision"] == "promote" and reg.version == 2
        assert not any(s["vacuous"] for s in v["signals"].values())
        assert v["signals"]["shadow"]["divergence"] == 0.0

    def test_shadow_fails_alone(self):
        reg = _registry(1)
        rc = _controller(reg, shadow=_shadowed(),
                         health=_FakeHealth(2, ok=True),
                         eval_fn=lambda p: 0.9, divergence_budget=0.0)
        v = rc.offer(_params(2), 2, round_idx=2)
        assert v["decision"] == "rollback"
        assert v["failed_signals"] == ["shadow"]
        assert v["signals"]["shadow"]["divergence"] == 1.0
        assert reg.version == 1 and 2 not in reg.versions()

    def test_health_fails_alone(self):
        reg = _registry(1)
        rc = _controller(reg, health=_FakeHealth(2, ok=False),
                         eval_fn=lambda p: 0.9)
        v = rc.offer(_params(2), 2, round_idx=2)
        assert v["failed_signals"] == ["health"] and reg.version == 1

    def test_eval_fails_alone_and_within_tolerance_promotes(self):
        reg = _registry(1)
        scores = iter([0.9, 0.5, 0.89])
        rc = _controller(reg, health=_FakeHealth(2, ok=True),
                         eval_fn=lambda p: next(scores))
        rc.offer(_params(2), 2, round_idx=2)
        v = rc.offer(_params(3), 3, round_idx=3)
        assert v["failed_signals"] == ["eval"]
        assert v["signals"]["eval"]["baseline"] == 0.9
        assert reg.version == 2
        assert rc.offer(_params(4), 4, round_idx=4)["decision"] == "promote"

    def test_nonfinite_eval_fails(self):
        rc = _controller(_registry(1), eval_fn=lambda p: float("nan"))
        v = rc.offer(_params(2), 2, round_idx=2)
        assert v["failed_signals"] == ["eval"]

    def test_vacuous_passes_are_named(self):
        rc = _controller(_registry(1))
        v = rc.offer(_params(2), 2, round_idx=2)
        assert v["decision"] == "promote"
        assert all(s["vacuous"] for s in v["signals"].values())

    def test_health_round_mismatch_is_vacuous_and_named(self):
        rc = _controller(_registry(1), health=_FakeHealth(7, ok=False))
        v = rc.offer(_params(2), 2, round_idx=2)
        assert v["decision"] == "promote"
        assert v["signals"]["health"]["vacuous"]
        assert v["signals"]["health"]["expected_round"] == 2

    def test_first_release_has_no_live_model_shadow_vacuous(self):
        shadow = ShadowSampler(every=1, slots=4)
        shadow.offer(np.ones(DIM, np.float32))
        rc = _controller(_registry(), shadow=shadow)
        v = rc.offer(_params(1), 1, round_idx=1)
        assert v["decision"] == "promote"
        assert v["signals"]["shadow"]["vacuous"]

    def test_stale_version_is_refused(self):
        reg = _registry(1, 2)
        v = _controller(reg).offer(_params(2), 2, round_idx=2)
        assert v["decision"] == "stale" and reg.version == 2


# -- cooldown and backoff --------------------------------------------------------------

class TestCooldownBackoff:
    def test_exponential_backoff_caps_and_resets(self):
        reg = _registry(1)
        clock = [0.0]
        rc = ReleaseController(reg, eval_fn=lambda p: float("nan"),
                               cooldown_s=5.0, backoff=2.0,
                               max_cooldown_s=15.0, clock=lambda: clock[0])
        cooldowns = []
        for v in range(2, 6):
            verdict = rc.offer(_params(v), v, round_idx=v)
            assert verdict["decision"] == "rollback"
            cooldowns.append(verdict["cooldown_s"])
            clock[0] += 100.0
        assert cooldowns == [5.0, 10.0, 15.0, 15.0]
        rc.eval_fn = lambda p: 0.9
        clock[0] += 100.0
        assert rc.offer(_params(9), 9, round_idx=9)["decision"] == "promote"
        rc.eval_fn = lambda p: float("nan")
        assert rc.offer(_params(10), 10,
                        round_idx=10)["cooldown_s"] == 5.0

    def test_cooldown_refuses_offers_without_publishing(self):
        reg = _registry(1)
        clock = [0.0]
        rc = ReleaseController(reg, eval_fn=lambda p: float("nan"),
                               cooldown_s=30.0, backoff=2.0,
                               max_cooldown_s=60.0, clock=lambda: clock[0])
        rc.offer(_params(2), 2, round_idx=2)
        rc.eval_fn = lambda p: 0.9
        assert rc.offer(_params(3), 3, round_idx=3)["decision"] == "cooldown"
        assert 3 not in reg.versions()
        clock[0] = 31.0
        assert rc.offer(_params(3), 3, round_idx=3)["decision"] == "promote"

    @pytest.mark.parametrize("kw", [dict(divergence_budget=1.5),
                                    dict(backoff=0.5),
                                    dict(cooldown_s=10.0,
                                         max_cooldown_s=1.0)])
    def test_invalid_config_refused(self, kw):
        with pytest.raises(ValueError):
            ReleaseController(_registry(1), **kw)


# -- crash consistency ------------------------------------------------------------------

def _crc(reg):
    return tree_crc(reg.current().params)


class TestCrashConsistency:
    def test_kill_pre_promote_recovers_to_pre_state(self):
        reg = _registry(1)
        pre = _crc(reg)
        fl = Faultline([CrashSpec("canary_promote", hit=1)])
        with pytest.raises(ActorKilled):
            _controller(reg, faultline=fl).offer(_params(2), 2, round_idx=2)
        assert _crc(reg) == pre and reg.canaries() == [2]
        fl.respawn()
        rc2 = _controller(reg, faultline=fl)
        assert rc2.recover()["discarded"] == [2] and reg.canaries() == []
        assert _crc(reg) == pre
        assert rc2.offer(_params(2), 2,
                         round_idx=2)["decision"] == "promote"

    def test_kill_post_promote_recovers_to_post_state(self):
        reg = _registry(1)
        fl = Faultline([CrashSpec("canary_promote", hit=2)])
        with pytest.raises(ActorKilled):
            _controller(reg, faultline=fl).offer(_params(2), 2, round_idx=2)
        assert reg.version == 2 and _crc(reg) == tree_crc(_params(2))
        fl.respawn()
        rc2 = _controller(reg, faultline=fl)
        assert rc2.recover()["discarded"] == []
        assert rc2.offer(_params(2), 2, round_idx=2)["decision"] == "stale"

    @pytest.mark.parametrize("hit", [1, 2])
    def test_kill_around_rollback_never_serves_canary(self, hit):
        reg = _registry(1)
        pre = _crc(reg)
        fl = Faultline([CrashSpec("canary_rollback", hit=hit)])
        with pytest.raises(ActorKilled):
            _controller(reg, eval_fn=lambda p: float("nan"),
                        faultline=fl).offer(_params(2), 2, round_idx=2)
        assert _crc(reg) == pre
        fl.respawn()
        _controller(reg).recover()
        assert reg.canaries() == []

    def test_release_journal_survives_disk_fault(self, tmp_path):
        reg = _registry(1)
        path = str(tmp_path / "release.jsonl")
        inj = DiskFaultInjector(
            [DiskFaultSpec("release_journal", hit=2, torn=True)]).install()
        try:
            rc = _controller(reg, journal_path=path)
            for v in (2, 3, 4):
                rc.offer(_params(v), v, round_idx=v)
        finally:
            inj.remove()
        assert [v["decision"] for v in rc.verdicts] == ["promote"] * 3
        lines = open(path).read().splitlines()
        assert json.loads(lines[0])["version"] == 2 and len(lines) == 2
        with pytest.raises(json.JSONDecodeError):
            json.loads(lines[1])


# -- the poisoned cross-device fixture, both packages --------------------------------

def _gate_run(pkg: str, p0):
    """The JAX package's poisoned fixture (LR on the mnist twin, 24
    clients, 12 a round in waves of 6, 4 rounds, round 3's wave 0 scaled
    by 1e6, admission off) gated by a ReleaseController over 64 test rows
    as shadow traffic, budget 0.1, no cooldown; from the init ``p0``."""
    kw = dict(comm_round=4, client_num_per_round=12, epochs=1, batch_size=4,
              wave_size=6, seed=0, frequency_of_the_test=10,
              wave_adversary="3:0:scale:1000000", admission="off")
    if pkg == "jax":
        from fedml_tpu.algorithms.cross_device import (CrossDevice,
                                                       CrossDeviceConfig)
        from fedml_tpu.data import load_data
        from fedml_tpu.experiments.models import (create_workload,
                                                  sample_shape_of)
        from fedml_tpu.serve.registry import ModelRegistry as Registry
        from fedml_tpu.serve.release import (
            ReleaseController as Controller, ShadowSampler as Sampler)
        data = load_data("mnist", data_dir=None, batch_size=4,
                         num_clients=24, seed=0)
        wl = create_workload("lr", "mnist", data.class_num,
                             sample_shape_of(data))
        reg = Registry(jax.jit(lambda p, x: wl.apply(p, x)), history=8)
        engine_kw, params = {}, p0
        host = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    else:
        from fedml_tpu_torch.algorithms.cross_device import (
            CrossDevice, CrossDeviceConfig)
        from fedml_tpu_torch.data import load_data
        from fedml_tpu_torch.experiments.models import (create_workload,
                                                        sample_shape_of)
        from fedml_tpu_torch.serve.registry import module_apply
        from fedml_tpu_torch.utils.jax_params import params_from_numpy
        Controller, Sampler = ReleaseController, ShadowSampler
        data = load_data("mnist", batch_size=4, num_clients=24, seed=0)
        wl = create_workload("lr", "mnist", data.class_num,
                             sample_shape_of(data))
        reg = ModelRegistry(module_apply(wl.model), history=8,
                            device="cpu")
        engine_kw = {"device": "cpu"}
        params = params_from_numpy(jax.tree.map(np.asarray, p0))
        host = lambda p: p  # noqa: E731
    shadow = Sampler(every=1, slots=64)
    xt = np.asarray(data.test["x"])
    for row in xt.reshape(-1, xt.shape[-1])[:64]:
        shadow.offer(row)
    rc = Controller(reg, shadow=shadow, divergence_budget=0.1,
                    cooldown_s=0.0, max_cooldown_s=0.0)
    engine = CrossDevice(wl, data, CrossDeviceConfig(**kw),
                         publish=lambda p, v: rc.offer(host(p), v,
                                                       round_idx=v - 1),
                         **engine_kw)
    engine.run(params=params)
    return rc, reg


# JAX's init of the fixture as flat host arrays: chip_smoke.py's phase 8q
# (b) runs the fixture from it on the card, so its verdicts are JAX's on
# any host; ``python tests/test_torch_release.py`` writes it
FIXTURE_INIT = Path(__file__).resolve().parent / "data" / \
    "release_fixture_init.npz"


def _jax_fixture_init():
    """The JAX engine's own init of the fixture (seed 0's second key)."""
    from fedml_tpu.data import load_data
    from fedml_tpu.experiments.models import create_workload, sample_shape_of
    jdata = load_data("mnist", data_dir=None, batch_size=4, num_clients=24,
                      seed=0)
    jwl = create_workload("lr", "mnist", jdata.class_num,
                          sample_shape_of(jdata))
    _, init_key = jax.random.split(jax.random.key(0))
    return jwl.init(init_key, jax.tree.map(
        lambda v: v[0, 0], {k: jdata.train[k] for k in ("x", "y", "mask")}))


def _flat_numpy(p0):
    from fedml_tpu_torch.utils.jax_params import params_from_numpy
    return {k: v.numpy() for k, v in
            params_from_numpy(jax.tree.map(np.asarray, p0)).items()}


def test_fixture_init_file_is_jax_init():
    """The committed init is bit for bit the JAX engine's init."""
    want = _flat_numpy(_jax_fixture_init())
    with np.load(FIXTURE_INIT) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_poisoned_round_contained_with_jax_verdicts():
    """Both packages from JAX's init: the same verdicts and divergences,
    the poisoned version 4 rolled back on the shadow signal alone, never
    live, serving left on the last promoted version."""
    p0 = _jax_fixture_init()
    want, _ = _gate_run("jax", p0)
    got, reg = _gate_run("torch", p0)

    def summary(rc):
        return [(v["version"], v["decision"], v.get("failed_signals"),
                 v["signals"]["shadow"]["divergence"],
                 v.get("live_version")) for v in rc.verdicts]

    assert summary(got) == summary(want)
    decisions = {v["version"]: v["decision"] for v in got.verdicts}
    assert decisions[4] == "rollback"
    poisoned = got.verdicts[-1]
    assert poisoned["version"] == 4
    assert poisoned["failed_signals"] == ["shadow"]
    assert poisoned["signals"]["shadow"]["divergence"] > 0.1
    assert 4 not in reg.versions()
    assert reg.version == max(v for v, d in decisions.items()
                              if d == "promote")
    assert all(v.get("live_version") != 4 for v in got.verdicts)


if __name__ == "__main__":
    FIXTURE_INIT.parent.mkdir(exist_ok=True)
    np.savez(FIXTURE_INIT, **_flat_numpy(_jax_fixture_init()))
