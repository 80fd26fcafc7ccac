"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's, mirroring ``tests/test_pipeline.py``.

The port's stages are devices of one process (here every stage is the
CPU); JAX's are the conftest's CPU devices.  Weights are JAX's init,
carried with `utils/jax_params.py`, including the stacked ``blocks``
leaves.  Limits, JAX's own test's:

* the forward for (S, M) = (4, 4), (2, 8), (4, 2), (1, 4) against JAX's
  ``apply_seq`` and ``make_pp_apply``: rtol 1e-4, atol 1e-5;
* the gradients of embed, blocks and head: rtol 1e-4, atol 1e-5;
* the MoE forward and its balance loss (rtol 1e-5, atol 1e-7), its
  gradients (rtol 2e-3, atol 1e-5; the router's nonzero);
* one workload's local training (1e-4) against JAX's trainer over the
  sequential twin;
* the shape errors, and the CLI's gates with JAX's messages; a
  ``--mesh_stages 2`` cross-silo CLI run, dense and with ``--moe_experts
  2``, finishes with a finite loss (``tests/test_experiments.py:144``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.data.stacking import stack_client_data
from fedml_tpu.parallel.pipeline import PipelineLM as JPipelineLM
from fedml_tpu.parallel.pipeline import make_seq_nwp_workload as j_seq_wl
from fedml_tpu.parallel.pipeline import make_stage_mesh as j_stage_mesh
from fedml_tpu.trainer.local_sgd import make_evaluator as j_evaluator
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.core.pytree import flatten_nested
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.parallel.pipeline import (PipelineLM,
                                               make_pp_nwp_workload,
                                               make_seq_nwp_workload,
                                               make_stage_mesh)
from fedml_tpu_torch.trainer.local_sgd import make_evaluator, make_local_trainer
from fedml_tpu_torch.trainer.workload import make_client_optimizer
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

RTOL, ATOL = 1e-4, 1e-5
MODEL = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=4, d_ff=64,
             max_len=16)
CPU_STAGES = lambda n: make_stage_mesh(n, device="cpu")  # noqa: E731


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: small ops, on which torch's thread pool spins
    when the workers of a parallel test run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _port(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _flat_np(tree):
    return flatten_nested(jax.tree.map(np.asarray, tree))


def _grads_np(g):
    return {k: v.detach().numpy() for k, v in g.items()}


@pytest.fixture(scope="module")
def setup():
    jlm = JPipelineLM(**MODEL)
    toks = np.random.RandomState(0).randint(1, 32, (8, 16)).astype(np.int32)
    jp = jax.jit(jlm.init)(jax.random.key(0), jnp.asarray(toks))
    return jlm, PipelineLM(**MODEL), toks, jp


@pytest.fixture(scope="module")
def seq_logits(setup):
    """JAX's sequential forward of the dense setup, once."""
    jlm, _, toks, jp = setup
    return np.asarray(jax.jit(jlm.apply_seq)(jp, jnp.asarray(toks)))


@pytest.fixture(scope="module")
def moe_setup():
    jlm = JPipelineLM(**MODEL, moe_experts=4)
    toks = np.random.RandomState(3).randint(1, 32, (8, 16)).astype(np.int32)
    toks[-1, 10:] = 0  # a pad tail: routing must exclude it at every stage
    jp = jax.jit(jlm.init)(jax.random.key(0), jnp.asarray(toks))
    return jlm, PipelineLM(**MODEL, moe_experts=4), toks, jp


def _ce(logits, y):
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           y.reshape(-1).long())


def _j_ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), y).mean()


def test_params_tree_carries_both_ways(setup):
    """The stacked tree (``blocks`` leaves [L, ...]) carries from JAX's
    numpy params to the port's and back, and the port's own init draws
    the same keys and shapes in JAX's leaf order."""
    jlm, lm, toks, jp = setup
    p = _port(jp)
    assert list(p) == list(lm.init(torch.Generator().manual_seed(0)))
    assert p["blocks/attn/query/kernel"].shape == (4, 32, 2, 16)
    back = params_to_numpy(p)
    want = _flat_np(jp)
    got = flatten_nested(back)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (2, 8), (4, 2), (1, 4)])
def test_pp_forward_matches_jax(setup, seq_logits, devices, n_stages,
                                n_micro):
    """Every stage/microbatch split, the bubble-heavy M < S and the
    one-stage pipeline, against JAX's sequential and pipelined forward."""
    jlm, lm, toks, jp = setup
    p = lm.pp_shard_params(_port(jp), CPU_STAGES(n_stages))
    got = lm.make_pp_apply(CPU_STAGES(n_stages), n_micro)(
        p, torch.tensor(toks)).detach().numpy()
    mesh = j_stage_mesh(n_stages, devices=devices)
    want_pp = jax.jit(jlm.make_pp_apply(mesh, n_micro=n_micro))(
        jlm.pp_shard_params(jp, mesh, n_stages), jnp.asarray(toks))
    for want in (seq_logits, want_pp):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(
        got, lm.apply_seq(p, torch.tensor(toks)).detach().numpy(),
        rtol=RTOL, atol=ATOL)


def test_pp_gradients_match_jax(setup, devices):
    """Autograd through the stages gives JAX's sequential gradients for
    the blocks, the embeddings and the head."""
    jlm, lm, toks, jp = setup
    y = np.roll(toks, -1, axis=1)
    g_seq = _flat_np(jax.jit(jax.grad(lambda q: _j_ce(
        jlm.apply_seq(q, jnp.asarray(toks)), jnp.asarray(y))))(jp))
    fn = lm.make_pp_apply(CPU_STAGES(4), 4)
    g_pp = torch.func.grad(lambda q: _ce(fn(q, torch.tensor(toks)),
                                         torch.tensor(y)))(_port(jp))
    _close(_grads_np(g_pp), g_seq)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (2, 8)])
def test_pp_moe_forward_and_balance_match_jax(moe_setup, devices, n_stages,
                                              n_micro):
    """ep x pp: the Switch-MoE stack pipelined over the stages gives
    JAX's logits and balance loss (per-microbatch routing, the mean over
    microbatches), and the loss is real pressure, not dropped."""
    jlm, lm, toks, jp = moe_setup
    mesh = j_stage_mesh(n_stages, devices=devices)
    out_pp, bal_pp = jax.jit(jlm.make_pp_apply(mesh, n_micro=n_micro,
                                               with_aux=True))(
        jlm.pp_shard_params(jp, mesh, n_stages), jnp.asarray(toks))
    out_seq, bal_seq = jax.jit(jlm.apply_seq_with_aux, static_argnums=2)(
        jp, jnp.asarray(toks), n_micro)
    got, bal = lm.make_pp_apply(CPU_STAGES(n_stages), n_micro,
                                with_aux=True)(_port(jp), torch.tensor(toks))
    for want, want_bal in ((out_pp, bal_pp), (out_seq, bal_seq)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(bal), float(want_bal), rtol=1e-5,
                                   atol=1e-7)
    assert float(bal) > 0.0


def test_pp_moe_gradients_carry_balance_loss(moe_setup, devices):
    """The balance term reaches the router's gradient through the
    pipeline: JAX's sequential gradients, the router's nonzero."""
    jlm, lm, toks, jp = moe_setup
    y = np.roll(toks, -1, axis=1)

    def j_loss(q):
        logits, bal = jlm.apply_seq_with_aux(q, jnp.asarray(toks), n_micro=4)
        return _j_ce(logits, jnp.asarray(y)) + jlm.moe_aux_weight * bal

    fn = lm.make_pp_apply(CPU_STAGES(4), 4, with_aux=True)

    def loss(q):
        logits, bal = fn(q, torch.tensor(toks))
        return _ce(logits, torch.tensor(y)) + lm.moe_aux_weight * bal

    g_pp = _grads_np(torch.func.grad(loss)(_port(jp)))
    _close(g_pp, _flat_np(jax.jit(jax.grad(j_loss))(jp)), rtol=2e-3,
           atol=1e-5)
    assert float(np.abs(g_pp["blocks/moe/router/kernel"]).max()) > 0.0


def _silo_data(seed, n, batch):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 32, (n, 16)).astype(np.int32)
    y = np.concatenate([x[:, 1:], x[:, :1]], axis=1)
    stacked = stack_client_data([x], [y], batch_size=batch)
    return {k: np.asarray(stacked[k][0]) for k in ("x", "y", "mask")}


def test_pp_workload_local_training_matches_jax(setup, devices):
    """The pipelined workload rides the plain local trainer: two epochs
    of SGD through the GPipe forward over 4 stages land on the params of
    JAX's trainer over its sequential twin (JAX's own test holds its
    pipelined trainer to that twin), and the evaluator's sums agree."""
    jlm, lm, _, jp = setup
    data = _silo_data(1, 16, 8)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    j_wl_seq = j_seq_wl(jlm)
    want_seq, _ = jax.jit(j_local(j_wl_seq, j_opt("sgd", 0.3), epochs=2))(
        jp, jdata, jax.random.key(2))
    wl = make_pp_nwp_workload(lm, CPU_STAGES(4), n_micro=4)
    tdata = {k: torch.tensor(v) for k, v in data.items()}
    got, _ = make_local_trainer(wl, make_client_optimizer("sgd", 0.3),
                                epochs=2)(_port(jp), tdata)
    got = _grads_np(got)
    _close(got, _flat_np(want_seq), rtol=RTOL, atol=1e-4)
    m_pp = make_evaluator(wl)({k: torch.tensor(v) for k, v in got.items()},
                              tdata)
    m_seq = make_evaluator(make_seq_nwp_workload(lm))(
        {k: torch.tensor(v) for k, v in got.items()}, tdata)
    m_jax = j_evaluator(j_wl_seq)(want_seq, jdata)
    for m in (m_seq, m_jax):
        assert float(m_pp["total"]) == float(m["total"])
        np.testing.assert_allclose(float(m_pp["loss_sum"]),
                                   float(m["loss_sum"]), rtol=1e-3)
        assert abs(float(m_pp["correct"]) - float(m["correct"])) <= 2


def test_pp_shape_errors(setup):
    jlm, lm, toks, jp = setup
    with pytest.raises(ValueError, match="not divisible"):
        lm.pp_shard_params(_port(jp), CPU_STAGES(3))   # 4 layers / 3
    with pytest.raises(ValueError, match="not divisible"):
        lm.make_pp_apply(CPU_STAGES(3), n_micro=2)
    with pytest.raises(ValueError, match="microbatches"):
        lm.make_pp_apply(CPU_STAGES(4), n_micro=3)(
            _port(jp), torch.tensor(toks))              # 8 % 3 != 0
    with pytest.raises(ValueError, match="pad_id"):
        make_seq_nwp_workload(PipelineLM(**MODEL, moe_experts=2), pad_id=3)
    with pytest.raises(ValueError, match="n_stages must be"):
        make_stage_mesh(0, device="cpu")
    # fewer devices than stages: round robin, where JAX refuses
    assert make_stage_mesh(3, devices=["cpu"]) == [torch.device("cpu")] * 3


_SILO = ["--algo", "cross_silo", "--silo_backend", "local", "--model",
         "transformer", "--dataset", "shakespeare", "--client_num_in_total",
         "4", "--client_num_per_round", "2", "--batch_size", "8",
         "--comm_round", "1", "--lr", "1.0", "--platform", "cpu",
         "--log_stdout", "false"]


@pytest.mark.parametrize("extra", [[], ["--moe_experts", "2"]])
def test_pp_cli_cross_silo_runs(extra):
    """``--mesh_stages 2`` cross-silo on the Shakespeare twin, dense and
    MoE, finishes with a finite loss; the stages share the CPU."""
    out = main(_SILO + ["--mesh_stages", "2"] + extra)
    assert np.isfinite(out["train_loss"]) and out["params_finite"]
    assert out["stage_devices"] == "cpu,cpu"


@pytest.mark.parametrize("flags", [
    ["--algo", "fedavg", "--mesh_stages", "2"],
    ["--algo", "cross_silo", "--pp_microbatches", "2"],
    ["--algo", "cross_silo", "--mesh_stages", "2", "--attn_block_size",
     "8"],
    ["--algo", "cross_silo", "--mesh_stages", "2", "--model", "cnn_fedavg",
     "--dataset", "femnist"],
    ["--algo", "cross_silo", "--mesh_stages", "2", "--pp_microbatches",
     "3"],
    ["--algo", "fedavg", "--mesh_sequence", "2", "--model", "lr",
     "--dataset", "mnist"],
    ["--algo", "fedavg", "--mesh_sequence", "2", "--moe_experts", "2"],
])
def test_gates_raise_jax_errors(flags):
    """The gates on ``--mesh_stages``, ``--pp_microbatches`` and
    ``--mesh_sequence`` raise the JAX package's errors, word for word."""
    from fedml_tpu.experiments.main import main as j_main
    base = ["--model", "transformer", "--dataset", "shakespeare",
            "--client_num_in_total", "4", "--client_num_per_round", "2",
            "--batch_size", "8", "--comm_round", "1"]
    with pytest.raises(ValueError) as want:
        j_main(base + ["--platform", "cpu"] + flags)
    with pytest.raises(ValueError) as got:
        main(base + ["--platform", "cpu", "--log_stdout", "false"] + flags)
    assert str(got.value) == str(want.value)
