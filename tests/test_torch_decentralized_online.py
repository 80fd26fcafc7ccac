"""Online DSGD / PushSum against the JAX package.

* ``make_topology`` and ``_topology_bank`` (static and time-varying) bit
  for bit, and the bank's refusal of ``time_varying`` with
  ``b_symmetric`` in JAX's words.
* ``init_lr_params``, ``lr_predict`` and ``bce_with_logits`` (optax's
  ``sigmoid_binary_cross_entropy``, values and gradients): 1e-6.
* ``make_online_run`` through ``run_decentralized_online`` in DOL, PUSHSUM
  and LOCAL, static and time-varying, on the same stream with padded
  steps: the final z, every iteration's loss sum and the regret within
  1e-6 relative (1e-7 absolute near 0); node 0's accuracy equal.
* PushSum's de-biasing from distinct starts (lr 0) against JAX's.
* The ``decentralized_online`` runner on ``--platform cpu`` against the
  JAX runner: final regret 1e-6 relative, accuracy equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import decentralized_online as jdol
from fedml_tpu.data.uci import synthetic_stream
from fedml_tpu.experiments.main import main as jmain
from fedml_tpu_torch.algorithms import decentralized_online as dol
from fedml_tpu_torch.experiments.main import main

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the suite runs files side by side, and torch's
    CPU convs and GroupNorm slow by tens of times when their thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, **kw):
    base = dict(iteration_number=12, epochs=2, learning_rate=0.05,
                weight_decay=0.001, b_symmetric=False, seed=3,
                topology_neighbors_num_undirected=2,
                topology_neighbors_num_directed=2)
    base.update(kw)
    return mod.DecentralizedOnlineConfig(**base)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("n", [3, 7, 16])
def test_topologies_bit_equal(n, sym):
    for tv in ((False, True) if not sym else (False,)):
        kw = dict(b_symmetric=sym, time_varying=tv)
        got = dol._topology_bank(_cfg(dol, **kw), n, 9)
        want = jdol._topology_bank(_cfg(jdol, **kw), n, 9)
        assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(dol.make_topology(_cfg(dol, b_symmetric=sym), n,
                                            seed=5),
                          jdol.make_topology(_cfg(jdol, b_symmetric=sym), n,
                                             seed=5))


def test_time_varying_symmetric_bank_is_refused_as_in_jax():
    with pytest.raises(ValueError) as mine:
        dol._topology_bank(_cfg(dol, b_symmetric=True, time_varying=True),
                           4, 3)
    with pytest.raises(ValueError) as ref:
        jdol._topology_bank(_cfg(jdol, b_symmetric=True, time_varying=True),
                            4, 3)
    assert str(mine.value) == str(ref.value)


def test_lr_model_and_bce_match_jax():
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(5).astype(np.float32),
         "b": np.float32(rng.randn())}
    x = rng.randn(5).astype(np.float32)
    z0 = dol.init_lr_params(5)
    jz0 = jdol.init_lr_params(5)
    assert all(np.array_equal(z0[k].numpy(), np.asarray(jz0[k]))
               for k in ("w", "b"))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    np.testing.assert_allclose(
        float(dol.lr_predict(tp, torch.tensor(x))),
        float(jdol.lr_predict({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))), rtol=RTOL)
    logits = np.array([-30.0, -2.5, -1e-3, 0.0, 1e-3, 0.7, 4.0, 30.0],
                      np.float32)
    for y in (0.0, 1.0):
        t = torch.tensor(logits, requires_grad=True)
        got = dol.bce_with_logits(t, torch.tensor(y))
        (g,) = torch.autograd.grad(got.sum(), t)
        want = optax.sigmoid_binary_cross_entropy(jnp.asarray(logits), y)
        jg = jax.grad(lambda v: optax.sigmoid_binary_cross_entropy(
            v, y).sum())(jnp.asarray(logits))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode,tv", [("DOL", False), ("PUSHSUM", False),
                                     ("LOCAL", False), ("DOL", True),
                                     ("PUSHSUM", True)])
def test_online_run_matches_jax(mode, tv):
    """A stream whose clients hold 9-12 samples of T = 12 (padded steps
    masked), two epochs."""
    stream = synthetic_stream(num_clients=5, total=53, dim=6, beta=0.3,
                              seed=1)
    got = dol.run_decentralized_online(
        stream, _cfg(dol, mode=mode, time_varying=tv), device="cpu")
    want = jdol.run_decentralized_online(
        stream, _cfg(jdol, mode=mode, time_varying=tv))
    for k in ("w", "b"):
        np.testing.assert_allclose(got["params_z"][k].numpy(),
                                   np.asarray(want["params_z"][k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["losses"], np.asarray(want["losses"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["regret"], want["regret"], rtol=RTOL)
    assert got["accuracy"] == want["accuracy"]
    assert [h["iteration"] for h in got["history"]] == \
        [h["iteration"] for h in want["history"]]


def test_pushsum_debiasing_from_distinct_starts_matches_jax():
    n, d = 6, 3
    rng = np.random.RandomState(0)
    stream = synthetic_stream(num_clients=n, total=n * 20, dim=d, seed=0)
    w0 = rng.randn(n, d).astype(np.float32)
    b0 = rng.randn(n).astype(np.float32)
    kw = dict(mode="PUSHSUM", iteration_number=20, epochs=1,
              learning_rate=0.0, weight_decay=0.0, seed=7)
    algo = dol.DecentralizedOnline(stream, _cfg(dol, **kw), device="cpu")
    algo.x0 = {"w": torch.tensor(w0), "b": torch.tensor(b0)}
    ref = jdol.DecentralizedOnline(stream, _cfg(jdol, **kw))
    ref.x0 = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    got, want = algo.run(), ref.run()
    for k in ("w", "b"):
        np.testing.assert_allclose(got["params_z"][k].numpy(),
                                   np.asarray(want["params_z"][k]),
                                   rtol=RTOL, atol=ATOL)


def test_unknown_mode_is_refused_as_in_jax():
    with pytest.raises(ValueError) as mine:
        dol.make_online_run(dol.lr_predict, _cfg(dol, mode="GOSSIP"))
    with pytest.raises(ValueError) as ref:
        jdol.make_online_run(jdol.lr_predict, _cfg(jdol, mode="GOSSIP"))
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("extra", [[], ["--mode", "PUSHSUM",
                                        "--time_varying", "true"]])
def test_runner_matches_the_jax_runner(extra):
    argv = ["--algo", "decentralized_online", "--client_num_in_total", "6",
            "--iteration_number", "10", "--lr", "0.05", "--beta", "0.2",
            "--log_stdout", "false", *extra]
    got = main(argv + ["--platform", "cpu"])
    want = jmain(argv)
    np.testing.assert_allclose(got["final_regret"], want["final_regret"],
                               rtol=RTOL)
    assert got["accuracy"] == want["accuracy"]
    assert got["steps_per_s"] > 0
