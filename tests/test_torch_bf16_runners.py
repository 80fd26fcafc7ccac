"""bf16 through every runner that takes ``--compute_dtype`` (the port's
``DTYPE_RUNNERS``), against the JAX package.

One parametrised case per runner: two rounds of LR on the ``mnist`` twin
from JAX's init, through each package's algorithm class, in bf16 — and,
for FedAvg and FedNova, of ``cnn_fedavg`` on the ``femnist`` twin.  An
absolute limit says little here: a bf16 round of the CNN moves the
weights ~4e-3, and JAX's own bf16 round sits a quarter of that from its
f32 round.  So each case holds the port's bf16 global to JAX's within
JAX's own gap between its bf16 and its f32 global, plus a margin of
``MARGIN`` x the round's move (the same 5% the chip check allows a bf16
step on the card against the CPU): the two packages round at other
places, never by more than bf16 itself moves a result.

FedOpt with Adam is the exception Queue 3 of the ROADMAP records: Adam's
first step is ``server_lr * sign(delta)``, so a coordinate whose bf16
delta sits near 0 flips by ``2 * server_lr`` between the packages.  Its
case holds every coordinate either within the gap rule or within one
flip, and the same run in f32 within 1e-4.

The runs skip their held-out evaluation (`_no_eval`): it reads the
global and never changes it, and compiling it would double JAX's share of
the file's time.  A module-scoped fixture builds each model's JAX init
once and runs JAX's bf16 and f32 rounds of every case in worker threads
(its compiles release the interpreter) while the cases run the port."""

import concurrent.futures
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.data import load_data as j_load_data
from fedml_tpu.experiments.models import create_workload as j_workload
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.experiments.models import create_workload, sample_shape_of
from fedml_tpu_torch.utils.jax_params import params_from_numpy

MARGIN = 0.05          # x the round's move
ROUNDS = 2
LR_DATA = dict(name="mnist", batch_size=4, num_clients=8)
CNN_DATA = dict(name="femnist", batch_size=10, num_clients=4)
SERVER_LR = 0.01


def _fed_kw(lr):
    return dict(comm_round=ROUNDS, client_num_per_round=4, epochs=1,
                batch_size=4, lr=lr, client_optimizer="sgd", wd=0.001,
                frequency_of_the_test=10, seed=0)


# runner -> (module, class, config class, extra config kwargs per package)
CLASSES = {
    "fedavg": ("fedavg", "FedAvg", "FedAvgConfig", {}),
    "fedprox": ("fedprox", "FedProx", "FedProxConfig", {"mu": 0.1}),
    "fedopt": ("fedopt", "FedOpt", "FedOptConfig",
               {"server_optimizer": "sgd", "server_lr": 1.0,
                "server_momentum": 0.9}),
    "fedopt_adam": ("fedopt", "FedOpt", "FedOptConfig",
                    {"server_optimizer": "adam", "server_lr": SERVER_LR}),
    "fednova": ("fednova", "FedNova", "FedNovaConfig",
                {"mu": 0.0, "gmf": 0.0}),
    "ditto": ("ditto", "Ditto", "DittoConfig", {"ditto_lambda": 0.1}),
    "feddyn": ("feddyn", "FedDyn", "FedDynConfig", {"feddyn_alpha": 0.01}),
    "fedac": ("fedac", "FedAC", "FedACConfig", {}),
    "dp_fedavg": ("dp_fedavg", "DPFedAvg", "DPFedAvgConfig",
                  {"dp_clip": 1.0, "dp_noise_multiplier": 0.0}),
    "fedavg_robust": ("fedavg_robust", "FedAvgRobust", "FedAvgRobustConfig",
                      {"defense": "norm_diff_clipping", "norm_bound": 5.0}),
    "hierarchical": ("hierarchical", "HierarchicalFedAvg",
                     "HierarchicalConfig",
                     {"group_num": 2, "group_comm_round": 2}),
    "cross_device": ("cross_device", "CrossDevice", "CrossDeviceConfig",
                     {"wave_size": 2}),
}


def _dataset(model):
    return "mnist" if model == "lr" else "femnist"


@functools.lru_cache(maxsize=None)
def _data(model):
    kw = dict(LR_DATA if model == "lr" else CNN_DATA)
    name = kw.pop("name")
    return (j_load_data(name, data_dir=None, seed=0, **kw),
            load_data(name, seed=0, **kw))


def _no_eval(algo):
    """``algo`` with its per-round held-out evaluation a no-op."""
    algo.evaluate_global = lambda params: {}
    return algo


def _run_jax(runner, model, jdata, p0, dtype):
    jwl = j_workload(model, _dataset(model), jdata.class_num,
                     sample_shape_of(jdata), compute_dtype=dtype)
    lr = 0.1
    if runner == "centralized":
        from fedml_tpu.algorithms.centralized import CentralizedTrainer
        trainer = CentralizedTrainer(jwl, lr=lr, client_optimizer="sgd",
                                     wd=0.001, epochs_per_call=1)
        train = {k: jnp.asarray(v) for k, v in jdata.train_global.items()}
        params, rng = p0, jax.random.key(0)
        for _ in range(ROUNDS):
            rng, rr = jax.random.split(rng)
            params = trainer.train_rounds(params, train, 1, rr)
        return params
    if runner == "turboaggregate":
        from fedml_tpu.algorithms.turboaggregate import (
            TurboAggregate, TurboAggregateConfig)
        return _no_eval(TurboAggregate(jwl, jdata, TurboAggregateConfig(
            comm_round=ROUNDS, group_num=2, clients_per_group=2,
            drop_tolerance=1, epochs=1, lr=lr, client_optimizer="sgd",
            seed=0, secagg_backend="xla"))).run(p0)
    mod, cls, cfg_cls, extra = CLASSES[runner]
    m = importlib.import_module(f"fedml_tpu.algorithms.{mod}")
    extra = dict(extra)
    if runner == "fedavg_robust":
        extra["defense_backend"] = "xla"
    algo = getattr(m, cls)(jwl, jdata, getattr(m, cfg_cls)(
        **extra, **_fed_kw(lr)))
    return _no_eval(algo).run(params=p0)


def _run_port(runner, model, data, p0, dtype):
    wl = create_workload(model, _dataset(model), data.class_num,
                         sample_shape_of(data), compute_dtype=dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, p0))
    lr = 0.1
    if runner == "centralized":
        from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
        trainer = CentralizedTrainer(wl, lr=lr, client_optimizer="sgd",
                                     wd=0.001, epochs_per_call=1)
        rng = prng.key(0)
        for _ in range(ROUNDS):
            rng, rr = prng.split(rng)
            params = trainer.train_rounds(params, data.train_global, 1, rr)
        return params
    if runner == "turboaggregate":
        from fedml_tpu_torch.algorithms.turboaggregate import (
            TurboAggregate, TurboAggregateConfig)
        return _no_eval(TurboAggregate(wl, data, TurboAggregateConfig(
            comm_round=ROUNDS, group_num=2, clients_per_group=2,
            drop_tolerance=1, epochs=1, lr=lr, client_optimizer="sgd",
            seed=0, secagg_backend="torch"), device="cpu")).run(params)
    mod, cls, cfg_cls, extra = CLASSES[runner]
    m = importlib.import_module(f"fedml_tpu_torch.algorithms.{mod}")
    algo = getattr(m, cls)(wl, data, getattr(m, cfg_cls)(
        **extra, **_fed_kw(lr)), device="cpu")
    return _no_eval(algo).run(params=params)


def _flat(tree):
    """A JAX tree or the port's flat dict -> flat dict of f32 arrays."""
    if not isinstance(next(iter(tree.values())), torch.Tensor):
        tree = params_from_numpy(jax.tree.map(np.asarray, tree))
    return {k: v.float().numpy() for k, v in tree.items()}


def _max_abs(a, b):
    return max(float(np.abs(a[k].astype(np.float64)
                            - b[k].astype(np.float64)).max()) for k in a)


CASES = ([("lr", r) for r in sorted(set(CLASSES) | {"centralized",
                                                    "turboaggregate"})]
         + [("cnn_fedavg", "fedavg"), ("cnn_fedavg", "fednova")])


@functools.lru_cache(maxsize=None)
def _init(model):
    """JAX's init of ``model`` (key 1), once per model."""
    jdata, _ = _data(model)
    jwl = j_workload(model, _dataset(model), jdata.class_num,
                     sample_shape_of(jdata))
    sample = jax.tree.map(lambda v: jnp.asarray(v[0, 0]),
                          {k: jdata.train[k] for k in ("x", "y", "mask")})
    return jwl.init(jax.random.key(1), sample)


@pytest.fixture(scope="module")
def jax_rounds():
    """Every case's JAX bf16 and f32 globals, as futures, computed in
    worker threads from the start of the module."""
    for model in {m for m, _ in CASES}:
        _init(model)

    def rounds(model, runner, dtype):
        return _flat(_run_jax(runner, model, _data(model)[0], _init(model),
                              dtype))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {(model, runner, dtype): pool.submit(rounds, model, runner,
                                                   dtype)
               for model, runner in CASES for dtype in ("bfloat16", "")}


@pytest.mark.parametrize("model, runner", CASES,
                         ids=[f"{m}-{r}" for m, r in CASES])
def test_bf16_round_within_jax_own_bf16_gap(jax_rounds, model, runner):
    _, data = _data(model)
    p0 = _init(model)
    init = _flat(p0)
    t16 = _flat(_run_port(runner, model, data, p0, "bfloat16"))
    j16 = jax_rounds[model, runner, "bfloat16"].result()
    j32 = jax_rounds[model, runner, ""].result()
    assert list(t16) == list(j16)
    move = _max_abs(j32, init)
    gap = _max_abs(j16, j32)
    diff = _max_abs(t16, j16)
    assert move > 0, "the rounds did not train"
    if runner != "fedopt_adam":
        assert diff <= gap + MARGIN * move, (diff, gap, move)
        return
    # Adam: within the gap rule, or one sign flip of 2 x server_lr a round
    assert diff <= max(gap, ROUNDS * 2 * SERVER_LR) + MARGIN * move, (
        diff, gap, move)
    t32 = _flat(_run_port(runner, model, data, p0, ""))
    assert _max_abs(t32, j32) <= 1e-4
