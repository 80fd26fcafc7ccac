"""The port's round checkpoints (``fedml_tpu_torch/utils/checkpoint.py``)
and FedAvg's checkpoint hooks.

The contract is the JAX package's (``tests/test_checkpoint.py``): a run
stopped after round k and resumed from its checkpoint continues bit for
bit as the uninterrupted run; ``save_every`` gates the saves (the last
round always saves); ``keep_last_n`` bounds the steps kept; a save
written on the background thread is on disk after ``flush``.  The
manifest's crc32 per top-level key equals the JAX package's
``tree_crc`` over the same state in its layout (nested params, the key's
uint32 words, the round), exactly.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.utils.journal import tree_crc as j_tree_crc
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import nest
from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import LogisticRegression
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer, manifest_path
from fedml_tpu_torch.utils.journal import atomic_write, tree_crc


def _setup():
    data = synthetic_federated_dataset(num_clients=8, samples_per_client=12,
                                       sample_shape=(6,), class_num=3,
                                       batch_size=4)
    wl = ClassificationWorkload(LogisticRegression(6, 3), num_classes=3,
                                grad_clip_norm=None)
    return wl, data


def _kwargs(rounds, **kw):
    return dict(comm_round=rounds, client_num_per_round=4, epochs=1,
                batch_size=4, lr=0.1, frequency_of_the_test=100, seed=0,
                **kw)


def _bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


def _resume_run(tmp_path, ck_kw, run_kw=None):
    wl, data = _setup()
    run_kw = run_kw or {}
    straight = FedAvg(wl, data, FedAvgConfig(**_kwargs(4)),
                      device="cpu").run()
    ck = RoundCheckpointer(str(tmp_path / "ck"), **ck_kw)
    FedAvg(wl, data, FedAvgConfig(**_kwargs(2, **run_kw)),
           device="cpu").run(checkpointer=ck)
    assert ck.latest_round() == 1
    resumed_algo = FedAvg(wl, data, FedAvgConfig(**_kwargs(4, **run_kw)),
                          device="cpu")
    resumed = resumed_algo.run(checkpointer=RoundCheckpointer(
        str(tmp_path / "ck"), **ck_kw))
    _bits(straight, resumed)
    assert len(resumed_algo.round_times) == 2     # rounds 2 and 3 only
    return ck


def test_fedavg_kill_and_resume_bit_identical(tmp_path):
    _resume_run(tmp_path, dict(save_every=1))


def test_async_save_resumes_bit_identical(tmp_path):
    ck = _resume_run(tmp_path, dict(save_every=1, async_save=True))
    ck.close()


def test_scanned_config_with_a_checkpointer_runs_the_loop(tmp_path):
    """rounds_per_dispatch > 1 with a checkpointer falls back to the
    per-round loop (its save cadence is per round), and resumes the
    same."""
    _resume_run(tmp_path, dict(save_every=1),
                run_kw=dict(rounds_per_dispatch=3))


def test_save_every_gating(tmp_path):
    wl, data = _setup()
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=3)
    FedAvg(wl, data, FedAvgConfig(**_kwargs(4)), device="cpu").run(
        checkpointer=ck)
    # rounds saved: idx 2 (every 3rd) and 3 (the last round)
    assert ck.latest_round() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "manifests"]
    assert not ck.maybe_save(0, lambda: pytest.fail("built a skipped state"))


@pytest.mark.parametrize("keep", [1, 2])
def test_keep_last_n_retention(tmp_path, keep):
    wl, data = _setup()
    ck = RoundCheckpointer(str(tmp_path / "ck"), save_every=1,
                           keep_last_n=keep)
    FedAvg(wl, data, FedAvgConfig(**_kwargs(6)), device="cpu").run(
        checkpointer=ck)
    steps = [str(s) for s in range(6 - keep, 6)]
    assert sorted(n for n in os.listdir(tmp_path / "ck")
                  if n.isdigit()) == steps
    assert sorted(os.listdir(tmp_path / "ck" / "manifests")) == \
        [f"{s}.json" for s in steps]


def test_default_keeps_three(tmp_path):
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    for step in range(5):
        ck.save(step, {"x": np.arange(3) + step})
    assert ck.latest_round() == 4
    assert sorted(n for n in os.listdir(tmp_path / "ck")
                  if n.isdigit()) == ["2", "3", "4"]
    np.testing.assert_array_equal(ck.restore(3)["x"], np.arange(3) + 3)


def test_manifest_crcs_equal_the_jax_tree_crc(tmp_path):
    """A FedAvg state's manifest: crc32 per top-level key, equal to the
    JAX package's `tree_crc` over the same values in its layout."""
    rng = np.random.RandomState(0)
    params = {"Dense_0/kernel": torch.tensor(rng.randn(6, 3), dtype=torch.float32),
              "Dense_0/bias": torch.tensor(rng.randn(3), dtype=torch.float32),
              "Conv_0/kernel": torch.tensor(rng.randn(2, 2),
                                            dtype=torch.float32)}
    key = prng.split(prng.key(42))[1]
    state = {"params": params, "rng": np.asarray(key, np.uint32),
             "round": 7}
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    ck.save(7, state)
    with open(manifest_path(ck.ckpt_dir, 7)) as f:
        manifest = json.load(f)
    j_params = jax.tree.map(lambda t: t.numpy(), nest(params))
    j_key = jax.random.key_data(jax.random.split(jax.random.key(42))[1])
    assert manifest["algo"] == "crc32" and manifest["step"] == 7
    assert manifest["crc"] == {"params": j_tree_crc(j_params),
                               "rng": j_tree_crc(np.asarray(j_key)),
                               "round": j_tree_crc(7)}
    assert manifest["crc"]["params"] == tree_crc(params)


def test_restore_types_and_template_checks(tmp_path):
    ck = RoundCheckpointer(str(tmp_path / "ck"))
    state = {"params": {"w": torch.arange(4.0)}, "rng": np.asarray(
        [1, 2], np.uint32), "round": 3, "lr": 0.5}
    ck.save(3, state)
    plain = ck.restore()
    assert torch.equal(plain["params"]["w"], torch.arange(4.0))
    assert plain["rng"].dtype == np.uint32 and plain["round"] == 3
    assert isinstance(plain["round"], int) and plain["lr"] == 0.5
    like = ck.restore(like={"params": {"w": torch.zeros(4,
                                                        dtype=torch.float64)},
                            "rng": np.zeros(2, np.uint32), "round": 0,
                            "lr": 0.0})
    assert like["params"]["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="structure"):
        ck.restore(like={"params": {"v": torch.zeros(4)}, "rng": 0,
                         "round": 0, "lr": 0.0})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(like={"params": {"w": torch.zeros(5)},
                         "rng": np.zeros(2, np.uint32), "round": 0,
                         "lr": 0.0})
    with pytest.raises(FileNotFoundError):
        RoundCheckpointer(str(tmp_path / "empty")).restore()


def test_async_save_is_durable_after_flush(tmp_path):
    ck = RoundCheckpointer(str(tmp_path / "ck"), async_save=True)
    w = torch.arange(6.0)
    ck.save(0, {"w": w})
    w.add_(100.0)          # the caller's buffer moves on; the save does not
    ck.flush()
    fresh = RoundCheckpointer(str(tmp_path / "ck"))
    assert fresh.latest_round() == 0
    assert torch.equal(fresh.restore()["w"], torch.arange(6.0))
    ck.close()


def test_a_failed_async_save_raises_at_flush(tmp_path):
    ck = RoundCheckpointer(str(tmp_path / "ck"), async_save=True)
    os.rmdir(ck.ckpt_dir)
    open(ck.ckpt_dir, "w").close()     # the directory is now a file
    ck.save(0, {"w": np.zeros(2)})
    with pytest.raises(OSError):
        ck.flush()
    ck.close()


def test_atomic_write(tmp_path):
    path = str(tmp_path / "f.json")
    atomic_write(path, b"one")
    atomic_write(path, b"two")
    assert open(path, "rb").read() == b"two"
    assert os.listdir(tmp_path) == ["f.json"]


def test_cli_checkpoint_flag(tmp_path):
    argv = ["--algo", "fedavg", "--model", "lr", "--dataset", "mnist",
            "--client_num_in_total", "8", "--client_num_per_round", "4",
            "--batch_size", "4", "--comm_round", "2", "--log_stdout",
            "false", "--checkpoint_dir", str(tmp_path / "ck"),
            "--checkpoint_every", "1", "--checkpoint_async", "true",
            "--checkpoint_keep_last_n", "5", "--platform", "cpu"]
    main(argv)
    assert RoundCheckpointer(str(tmp_path / "ck")).latest_round() == 1
    main([a if a != "2" else "4" for a in argv])
    assert RoundCheckpointer(str(tmp_path / "ck")).latest_round() == 3
    with pytest.raises(NotImplementedError, match="turboaggregate"):
        main(["--algo", "turboaggregate", "--checkpoint_dir",
              str(tmp_path / "t"), "--platform", "cpu"])
