"""Dropout keys through the eight runners that train a dropout model:
``ditto``, ``feddyn``, ``fedac``, ``dp_fedavg``, ``hierarchical``,
``turboaggregate``, ``cross_silo`` and ``async_fl``.

The port's masks are hashed from threefry keys (`models.layers.dropout`)
and differ from flax's by design, so parity with the JAX package is held
on the key words: every client key a runner hands its keyed trainer
(`core.prng.step_keys`, where each trainer's ``rng, drop = split(rng)``
chain starts) equals, word for word, the key the JAX package's runner
derives at that place:

* FedAvg's chain and ``fold_in(round_key, slot)`` for ``feddyn``,
  ``fedac``, ``dp_fedavg`` and the global stream of ``ditto``;
* ``fold_in(fold_in(round_key, "DITT"), slot)`` for Ditto's personal pass
  (JAX ``algorithms/ditto.py:196``);
* ``fold_in(split(fold_in(rr, g))[1], slot)`` for ``hierarchical``'s group
  rounds (JAX ``hierarchical.py:244-250``);
* ``fold_in(fold_in(fold_in(key(seed), r), g), slot)`` for
  ``turboaggregate`` (JAX ``turboaggregate.py:119``, :140);
* the live servers' ``fold_in(_round_rng(r), silo - 1)`` (JAX
  ``experiments/main.py:760-790``) for ``cross_silo`` and ``async_fl``,
  and its chain alone for rounds 0-3 with a resume's backward jump and
  two threads asking at once.

Each runner runs ``--model cnn --dataset femnist`` for one round on the
CPU: the same seed twice is bit-equal, and the keyed trainers move the
global more than 1e-4 away from the same run with every trainer keyless
(``rng_inputs = None``), the pattern of
``tests/test_torch_centralized.py:118``.  ``check_config`` refuses none of
the eight with any dropout model."""

import importlib
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.experiments.main import (RoundKeyChain, check_config,
                                              main)

RUNNERS = ("ditto", "feddyn", "fedac", "dp_fedavg", "hierarchical",
           "turboaggregate", "cross_silo", "async_fl")
SEED = 3
GROUPS = 2
ARGS = ["--model", "cnn", "--dataset", "femnist", "--client_num_in_total",
        "4", "--client_num_per_round", "2", "--batch_size", "16",
        "--comm_round", "1", "--platform", "cpu", "--seed", str(SEED),
        "--group_num", str(GROUPS), "--group_comm_round", "1"]
DITT = 0x44495454


def _words(key) -> tuple:
    return tuple(int(w) for w in jax.random.key_data(key))


def _slots(key, n):
    return [_words(jax.random.fold_in(key, i)) for i in range(n)]


def _round0():
    """FedAvg.run's first round key when the run draws its own init."""
    rng, _ = jax.random.split(jax.random.key(SEED))
    return jax.random.split(rng)[1]


def _live_round(r):
    """JAX ``_round_rng(r)``: the chain from ``split(key(seed))[0]``."""
    rng = jax.random.split(jax.random.key(SEED))[0]
    for _ in range(r + 1):
        rng, last = jax.random.split(rng)
    return last


def _expected_calls(algo, rows):
    """The JAX runner's client keys per trainer call, in call order (the
    live servers' as one call a silo, in any order); ``rows`` the clients
    of each group of ``turboaggregate`` (its ``--clients_per_group``)."""
    r0 = _round0()
    if algo in ("feddyn", "fedac", "dp_fedavg"):
        return [_slots(r0, 2)]
    if algo == "ditto":
        return [_slots(r0, 2), _slots(jax.random.fold_in(r0, DITT), 2)]
    if algo == "hierarchical":
        return [_slots(jax.random.split(jax.random.fold_in(r0, g))[1], 2)
                for g in range(GROUPS)]
    if algo == "turboaggregate":
        rk = jax.random.fold_in(jax.random.key(SEED), 0)
        return [_slots(jax.random.fold_in(rk, g), rows)
                for g in range(GROUPS)]
    return [[_words(jax.random.fold_in(_live_round(r), s - 1))]
            for r in (0, 1) for s in (1, 2)]


def _run(algo, monkeypatch, keyed=True):
    """One CLI run: its final global and the client keys each trainer
    call got (`prng.step_keys`, where every keyed trainer's chain
    starts)."""
    mesh_mod = importlib.import_module("fedml_tpu_torch.parallel.mesh")
    wl_mod = importlib.import_module("fedml_tpu_torch.trainer.workload")
    seen, final = [], {}
    real_steps, real_sha = prng.step_keys, mesh_mod.params_sha256

    def steps(keys, n):
        out = real_steps(keys, n)
        seen.append((keys.clone(), out.clone(), n))
        return out

    def sha(params):
        final.update({k: v.detach().clone() for k, v in params.items()})
        return real_sha(params)

    with monkeypatch.context() as m:
        m.setattr(prng, "step_keys", steps)
        m.setattr(mesh_mod, "params_sha256", sha)
        if not keyed:
            m.setattr(wl_mod, "is_stochastic", lambda model: False)
        out = main(["--algo", algo] + ARGS)
    assert out["params_finite"]
    return final, seen


@pytest.mark.parametrize("algo", RUNNERS)
def test_runner_keys_its_dropout_model_as_jax(algo, monkeypatch):
    """Each runner's client keys equal the JAX runner's word for word, and
    every client's per-step chain too; one seed twice is bit-equal;
    keyless training lands elsewhere."""
    p1, seen = _run(algo, monkeypatch)
    got = [[tuple(int(w) for w in row) for row in keys.tolist()]
           for keys, _, _ in seen]
    want = _expected_calls(algo, len(got[0]))
    if algo == "hierarchical":
        # the groups the round's two clients fall in, in sorted order
        assert got and all(c in want for c in got)
        assert got == sorted(got, key=want.index)
    elif algo in ("cross_silo", "async_fl"):
        assert got and all(c in want for c in got)
        assert want[0] in got and want[1] in got   # round 0, both silos
    else:
        assert got == want
    # every client's per-step keys: the JAX trainer's chain
    # ``rng, drop = split(rng)`` from its client key
    for keys, steps, n in seen:
        for key, got_steps in zip(keys, steps):
            chain = jax.random.wrap_key_data(np.asarray(key, np.uint32))
            drops = []
            for _ in range(n):
                chain, d = jax.random.split(chain)
                drops.append(np.asarray(jax.random.key_data(d)))
            np.testing.assert_array_equal(got_steps.numpy(),
                                          np.stack(drops))

    p2, _ = _run(algo, monkeypatch)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    plain, none = _run(algo, monkeypatch, keyed=False)
    assert not none
    assert max(float((p1[k] - plain[k]).abs().max()) for k in p1) > 1e-4


@pytest.mark.parametrize("model", ["cnn", "mobilenet_v3", "efficientnet",
                                   "vgg11", "vgg13", "vgg16"])
def test_check_config_refuses_no_runner_a_dropout_model(model):
    for algo in RUNNERS:
        check_config(config_from_argv(["--algo", algo, "--model", model,
                                       "--dataset", "cifar10",
                                       "--platform", "cpu"]))


def test_live_round_keys_follow_jax_chain():
    """The live servers' chain: rounds 0-3, the same round asked twice, a
    resume's backward jump, and threads asking at once."""
    chain = RoundKeyChain(SEED)
    want = {r: _words(_live_round(r)) for r in range(4)}
    for r in range(4):
        assert tuple(chain(r)) == want[r]
        assert tuple(chain(r)) == want[r]
    assert tuple(chain(1)) == want[1]          # a resume restarts the chain
    assert tuple(chain(3)) == want[3]
    for r in range(4):
        for silo in (1, 2, 3):
            assert tuple(chain.silo_key(r, silo)) == _words(
                jax.random.fold_in(_live_round(r), silo - 1))
    # threads sharing one chain (chaos mode's silos), more of them than
    # cores, each asking rounds in its own order with a short switch
    # interval: every answer is its round's key
    fresh = RoundKeyChain(SEED)
    rng = np.random.RandomState(0)
    orders = [rng.randint(0, 4, 40) for _ in range(16)]
    bad, barrier = [], threading.Barrier(len(orders))

    def ask(order):
        barrier.wait()
        bad.extend(r for r in order if tuple(fresh(int(r))) != want[r])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(o,)) for o in orders]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
