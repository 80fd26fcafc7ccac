"""The LSTM language models (config 5) against the JAX package.

The port's ``OptimizedLSTMCell`` stacks carry flax's weights by renaming
alone: the leaf paths, shapes and order equal flax's, and the logits of
both models at narrow widths equal flax's ``nn.RNN(OptimizedLSTMCell)``
within 1e-5 x max|logit| (f32 matmuls summed in another order); one
local-SGD call of the NWP workload equals JAX's ``make_local_trainer``
within 1e-5; two FedAvg rounds of the CLI factory's ``--model rnn`` on
the Shakespeare twin equal JAX's within 1e-4 (the round limit of the
earlier slices), and the port's CLI runs it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.experiments.models import create_workload as j_create_workload
from fedml_tpu.models.rnn import RNNOriginalFedAvg as JRNNOriginal
from fedml_tpu.models.rnn import RNNStackOverflow as JRNNStackOverflow
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local_trainer
from fedml_tpu.trainer.workload import NWPWorkload as JNWPWorkload
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.experiments.models import create_workload
from fedml_tpu_torch.models import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import NWPWorkload, make_client_optimizer
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

LOGIT_TOL = 1e-5      # x max|logit|
STEP_TOL = 1e-5       # one local-SGD call
ROUND_TOL = 1e-4      # two FedAvg rounds
T = 6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: many small ops, on which torch's thread pool
    spins when the workers of a parallel test run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NARROW = {
    "original": (lambda: JRNNOriginal(vocab_size=20, embedding_dim=8,
                                      hidden_size=16),
                 lambda: RNNOriginalFedAvg(vocab_size=20, embedding_dim=8,
                                           hidden_size=16), 20),
    "stackoverflow": (lambda: JRNNStackOverflow(vocab_size=16,
                                                embedding_size=8,
                                                latent_size=16),
                      lambda: RNNStackOverflow(vocab_size=16,
                                               embedding_size=8,
                                               latent_size=16), 20),
}


@pytest.fixture(scope="module")
def narrow():
    """Each narrow pair with flax's init carried across."""
    out = {}
    for name, (jm, tm, vocab) in NARROW.items():
        jmodel, tmodel = jm(), tm()
        p0 = jmodel.init(jax.random.key(1), jnp.zeros((1, T), jnp.int32))
        out[name] = (jmodel, tmodel, vocab, p0["params"],
                     params_from_numpy(jax.tree.map(np.asarray,
                                                    p0["params"])))
    return out


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.shape(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", sorted(NARROW))
def test_lstm_logits_match_flax(narrow, name):
    jmodel, tmodel, vocab, jp, tp = narrow[name]
    ids = np.random.RandomState(0).randint(0, vocab, (3, T)).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": jp}, jnp.asarray(ids)))
    wl = NWPWorkload(tmodel)
    # the port's own init has flax's leaf paths, shapes and order
    mine = wl.init(torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape)) for k, v in mine.items()] == \
        [(k, tuple(v.shape)) for k, v in tp.items()]
    assert list(tp) == ["/".join(k.strip("[]'").split("']['"))
                        for k, _ in _leaves(jp)]
    with torch.no_grad():
        from fedml_tpu_torch.trainer.workload import apply_model
        got = apply_model(tmodel, tp, torch.tensor(ids)).numpy()
    assert got.shape == want.shape == (3, T, vocab)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))


def test_full_width_parameter_counts():
    """820,522 parameters at vocab 90 (Shakespeare) and 4,050,748 for the
    StackOverflow model, as flax's."""
    for model, n in ((RNNOriginalFedAvg(vocab_size=90), 820_522),
                     (RNNStackOverflow(), 4_050_748)):
        assert sum(p.numel() for p in model.parameters()) == n


def test_one_local_sgd_call_matches_jax(narrow):
    """E=2 over 3 batches of 2 sequences (one batch fully padded, pad
    targets in another), SGD lr 0.5: the port's trainer equals JAX's."""
    jmodel, tmodel, vocab, jp, tp = narrow["original"]
    rng = np.random.RandomState(2)
    x = rng.randint(0, vocab, (3, 2, T)).astype(np.int32)
    y = rng.randint(1, vocab, (3, 2, T)).astype(np.int32)
    y[1, :, -2:] = 0
    mask = np.array([[1, 1], [1, 0], [0, 0]], np.float32)
    data = {"x": x, "y": y, "mask": mask}
    jtrain = j_local_trainer(JNWPWorkload(jmodel), j_opt("sgd", 0.5), 2)
    want, _ = jax.jit(jtrain)(jp, jax.tree.map(jnp.asarray, data),
                              jax.random.key(0))
    ttrain = make_local_trainer(NWPWorkload(tmodel),
                                make_client_optimizer("sgd", 0.5), 2)
    got, metrics = ttrain(tp, {k: torch.tensor(v) for k, v in data.items()})
    assert metrics["train_loss_per_step"].shape == (6,)
    got = params_to_numpy(got)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=STEP_TOL, rtol=0), got, want)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(jp)))
    assert moved > 1e-3


def test_cli_rnn_fedavg_two_rounds_match_jax(tmp_path):
    """The factories' ``--model rnn`` on the Shakespeare twin (the full
    LSTM, 80 tokens, vocab 90): two FedAvg rounds of 2 of 3 clients, B=16,
    lr 1, from JAX's init, within 1e-4; then the port's CLI runs it."""
    kw = dict(num_clients=3, batch_size=16, seed=1)
    from fedml_tpu.data import registry as j_registry
    j_data = j_registry.load_data("shakespeare", **kw)
    t_data = load_data("shakespeare", **kw)
    jwl = j_create_workload("rnn", "shakespeare", 90, (80,))
    twl = create_workload("rnn", "shakespeare", 90, (80,))
    assert isinstance(twl.model, RNNOriginalFedAvg)
    assert isinstance(create_workload("lr", "stackoverflow_nwp", 10004,
                                      (20,)).model, RNNStackOverflow)
    p0 = jwl.init(jax.random.key(5), {"x": np.zeros((1, 80), np.int32)})
    common = dict(comm_round=2, client_num_per_round=2, batch_size=16,
                  lr=1.0, frequency_of_the_test=1000)
    want = JFedAvg(jwl, j_data, JFedAvgConfig(**common)).run(params=p0)
    got = FedAvg(twl, t_data, FedAvgConfig(**common), device="cpu").run(
        params=params_from_numpy(jax.tree.map(np.asarray, p0)))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=ROUND_TOL, rtol=0), params_to_numpy(got),
        want)
    out = main(["--algo", "fedavg", "--model", "rnn", "--dataset",
                "shakespeare", "--client_num_in_total", "3",
                "--client_num_per_round", "2", "--batch_size", "16",
                "--lr", "1.0", "--comm_round", "2", "--platform", "cpu",
                "--log_stdout", "false", "--run_dir", str(tmp_path)])
    assert out["params_finite"] and out["round"] == 1
    assert np.isfinite(out["train_loss"])
