"""Next-word prediction on the transformer: the port's NWP workload, its
FedAvg round and its CLI against the JAX package.

The loss and metrics equal ``fedml_tpu.trainer.workload.NWPWorkload``'s
within 1e-5 (pad targets and padded rows masked); one FedAvg round of a
small transformer from the same weights and cohort equals the JAX
package's within 1e-4 on the new global (the bound the earlier slices'
round tests use), dense at T=16 and through the flash path (its plain
version on the CPU) at T=128; the NWP twins are byte-equal to the JAX
registry's; the CLI runs the Shakespeare twin on the CPU and refuses what
the JAX library refuses."""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.data import registry as j_registry
from fedml_tpu.data.synthetic import (
    synthetic_federated_dataset as j_synthetic)
from fedml_tpu.models import TransformerLM as JTransformerLM
from fedml_tpu.trainer.workload import NWPWorkload as JNWPWorkload
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import TransformerLM
from fedml_tpu_torch.trainer.workload import NWPWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

VOCAB = 30
SMALL = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, max_len=128)


def _pair(n_layers=1, **tkw):
    return (JNWPWorkload(JTransformerLM(n_layers=n_layers, **SMALL)),
            NWPWorkload(TransformerLM(n_layers=n_layers, **SMALL, **tkw)))


def _init(jwl, t):
    p0 = jwl.init(jax.random.key(3), {"x": np.zeros((1, t), np.int32)})
    return p0, params_from_numpy(jax.tree.map(np.asarray, p0))


def test_nwp_loss_and_metrics_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, (4, 16)).astype(np.int32)
    y = rng.randint(1, VOCAB, (4, 16)).astype(np.int32)
    y[:, -3:] = 0                                   # pad targets
    mask = np.array([1, 1, 1, 0], np.float32)       # one padded row
    batch = {"x": x, "y": y, "mask": mask}
    jwl, twl = _pair(n_layers=2)
    p0, tp0 = _init(jwl, 16)
    want_loss, _ = jwl.loss_fn(p0, batch, None, True)
    want = jwl.metric_fn(p0, batch)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got_loss, aux = twl.loss_fn(tp0, tb)
    with torch.no_grad():
        got = twl.metric_fn(tp0, tb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=1e-5)
    assert float(aux["loss"]) == float(got_loss)
    assert set(got) == set(want) == {"correct", "loss_sum", "total"}
    assert float(got["total"]) == 3 * 13
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4,
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("t,n_layers,tkw", [
    (16, 2, {}),
    (128, 1, dict(use_flash=True)),
])
def test_fedavg_round_matches_jax(t, n_layers, tkw):
    """One FedAvg round (3 of 6 clients, B=2, SGD lr 0.5) from the JAX
    package's init: the port's new global within 1e-4 of JAX's, the JAX
    model running its dense path, and it moved from the init."""
    kw = dict(num_clients=6, samples_per_client=4, sample_shape=(t,),
              sequence_vocab=VOCAB, class_num=VOCAB, batch_size=2, seed=1)
    j_data, t_data = j_synthetic(**kw), synthetic_federated_dataset(**kw)
    jwl, twl = _pair(n_layers, **tkw)
    p0, tp0 = _init(jwl, t)
    common = dict(comm_round=1, client_num_per_round=3, batch_size=2,
                  lr=0.5, frequency_of_the_test=1000)
    want = JFedAvg(jwl, j_data, JFedAvgConfig(**common)).run(params=p0)
    got = FedAvg(twl, t_data, FedAvgConfig(**common), device="cpu").run(
        params=tp0)
    got = params_to_numpy(got)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-4, rtol=0), got, want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 1e-3


@pytest.mark.parametrize("name", ["shakespeare", "fed_shakespeare",
                                  "stackoverflow_nwp"])
def test_nwp_twins_equal_jax_registry(name):
    kw = dict(num_clients=3, batch_size=4, seed=2)
    got, want = load_data(name, **kw), j_registry.load_data(name, **kw)
    assert got.class_num == want.class_num
    for split in ("train", "test"):
        for k, v in want.__dict__[split].items():
            np.testing.assert_array_equal(got.__dict__[split][k], v)


def _cli(*extra, tmp_path=None):
    args = ["--algo", "fedavg", "--model", "transformer", "--dataset",
            "shakespeare", "--client_num_in_total", "6",
            "--client_num_per_round", "3", "--batch_size", "4", "--lr",
            "1.0", "--comm_round", "2", "--platform", "cpu", "--log_stdout",
            "false", *extra]
    if tmp_path is not None:
        args += ["--run_dir", str(tmp_path)]
    return main(args)


def test_cli_runs_the_shakespeare_transformer_on_cpu(tmp_path):
    out = _cli(tmp_path=tmp_path)
    assert out["params_finite"] is True and out["rounds_per_s"] > 0
    assert out["round"] == 1 and np.isfinite(out["train_loss"])
    assert 0.0 <= out["test_acc"] <= 1.0
    assert (tmp_path / "metrics.jsonl").exists()


def test_cli_attn_flash_at_t80_is_refused_like_the_library():
    with pytest.raises(ValueError, match="block_q=128 should be smaller or "
                                         "equal to q_seq_len=80"):
        _cli("--attn_flash", "true")


def test_gates_and_refusals_are_named():
    with pytest.raises(ValueError, match="mutually exclusive"):
        create_workload("transformer", "shakespeare", 90, (80,),
                        attn_block_size=16, attn_flash=True)
    with pytest.raises(ValueError, match="only apply to --model transformer"):
        create_workload("cnn_fedavg", "femnist", 62, (28, 28, 1),
                        attn_flash=True)
    # every other model name trains the LSTM there, as in the JAX package
    from fedml_tpu_torch.models import RNNOriginalFedAvg
    assert isinstance(create_workload("rnn", "shakespeare", 90,
                                      (80,)).model, RNNOriginalFedAvg)
    wl = create_workload("transformer", "stackoverflow_nwp", 10004, (20,),
                         attn_block_size=10)
    assert wl.model.attn_0.block_size == 10
    assert create_workload("transformer", "shakespeare", 90, (80,),
                           moe_experts=4).model.moe_experts == 4
    # sequence and pipeline parallelism are ported: on one CPU rank the
    # [clients, sequence] mesh cannot be built, and the pipeline is the
    # cross-silo silos' (JAX's gates)
    for flag, match in ((["--mesh_sequence", "2"], r"mesh 1x2 != 1 dev"),
                        (["--mesh_stages", "2"], "only applies to --algo "
                                                 "cross_silo")):
        with pytest.raises(ValueError, match=match):
            _cli(*flag)
