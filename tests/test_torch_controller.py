"""The port's adaptive round controller (``server_opt/controller.py``)
against the JAX package's, and its checkpointed state.

* Over the same sequence of health lines (alarms firing and calm, with
  and without participation debt and a quorum floor) both controllers
  take identical decisions and hold identical ``state_dict``s (exact);
  a state dict loads across the packages.
* Kill→resume: the cross-device engine with ``--adaptive --health`` and
  a misalignment threshold that fires every round (so the cohort widens
  round over round) stopped after round 1 and resumed to round 3 from
  its checkpoint ends bit-equal to the straight 3-round run, with the
  controller's state restored from the checkpoint's ``adapt`` entry.
  This covers the wave engine's ``adapt`` entry only.  The health
  accumulator's state (its starvation clock) is in no checkpoint, on the
  wave engine or on the cross-silo actor, as in the JAX package: a
  resume whose decisions hang on a starvation alarm is not covered, and
  can differ from the straight run (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from fedml_tpu.server_opt import AdaptiveController as JController
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.experiments.main import (cross_device_algo,
                                              load_experiment_data,
                                              make_checkpointer)
from fedml_tpu_torch.server_opt import AdaptiveController


def _line(rng):
    def alarm(fire, thr):
        value = thr * (1.0 + rng.rand()) if fire else thr * rng.rand()
        return {"value": value, "threshold": thr, "ok": not fire}

    return {"alarms": {
        "alignment_collapse": alarm(rng.rand() < 0.3, 1.5),
        "norm_variance_blowup": alarm(rng.rand() < 0.2, 1.0),
        "participation_starvation": alarm(rng.rand() < 0.15, 0.5)}}


@pytest.mark.parametrize("kw", [
    dict(cohort=10, epochs=3, wave_size=0, min_cohort=2, max_cohort=10),
    dict(cohort=12, epochs=2, wave_size=4, min_cohort=3, max_cohort=400,
         patience=3, epochs_live=True)])
def test_decisions_and_state_equal_jax(kw):
    rng = np.random.RandomState(7)
    got, want = AdaptiveController(**kw), JController(**kw)
    for r in range(60):
        line = _line(rng) if r % 9 else None
        extra = {}
        if r % 5 == 0:
            extra["debt"] = int(rng.randint(0, 3))
        if r % 7 == 0:
            extra["quorum_floor"] = int(rng.randint(1, 12))
        a = got.decide(r, line, **extra)
        b = want.decide(r, line, **extra)
        assert a.as_ledger() == b.as_ledger()
        sa, sb = got.state_dict(), want.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and sa[k] == sb[k]
    crossed = AdaptiveController(**kw)
    crossed.load_state_dict(want.state_dict())
    assert crossed.state_dict() == got.state_dict()


_CD = ["--algo", "cross_device", "--model", "lr", "--dataset", "mnist",
       "--client_num_in_total", "40", "--client_num_per_round", "6",
       "--wave_size", "4", "--batch_size", "4", "--lr", "0.1",
       "--frequency_of_the_test", "100", "--platform", "cpu",
       "--log_stdout", "false", "--adaptive", "true", "--health", "true",
       "--slo", "health_misalignment_ratio=0.0001", "--adapt_patience", "9",
       "--checkpoint_every", "1"]


def _run(tmp_path, name, rounds, ckpt):
    cfg = config_from_argv(_CD + [
        "--comm_round", str(rounds), "--run_dir", str(tmp_path / name),
        "--checkpoint_dir", str(tmp_path / ckpt)])
    data = load_experiment_data(cfg)
    algo = cross_device_algo(cfg, data)
    ck = make_checkpointer(cfg)
    try:
        params = algo.run(checkpointer=ck)
    finally:
        ck.close()
    return params, algo


def test_adaptive_kill_resume_is_bit_equal(tmp_path):
    straight, s_algo = _run(tmp_path, "straight", 3, "ck_straight")
    _run(tmp_path, "first", 1, "ck_resumed")           # killed after 1
    resumed, r_algo = _run(tmp_path, "second", 3, "ck_resumed")
    assert s_algo.controller.cohort > 6    # the lever moved every round
    assert r_algo.controller.state_dict() == s_algo.controller.state_dict()
    assert all(torch.equal(straight[k], resumed[k]) for k in straight)
