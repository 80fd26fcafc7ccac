"""The port's tensor and expert parallelism (``parallel/mesh.py::
tp_shard_params``, ``parallel/expert.py``, the layers that compute on
shards) against the JAX package's placements and unsharded functions.

Placements (no ranks): the port's `Placement.spec` of every leaf equals
JAX's ``.sharding.spec`` on the conftest's 8 CPU devices: LR at
``min_size=8``, the 3-D gate tree, the transformer at ``min_size=512``,
the MoE LM under ``ep_shard_params`` with 8 and 4 experts; 12 experts on
8 is refused by both.  A sharded leaf outside the ported layers raises
``NotImplementedError`` by name.

Computations: ONE `spawn_ranks` of 4 gloo CPU ranks runs every case
(`tests/torch_tp_ep_jobs.py`, which imports no JAX) while this process
computes JAX's references with the plain, unsharded functions.  The ranks
return whole trees (gathered globals, gathered gradients, logits), held
at JAX's own tests' tolerances (``tests/test_fedavg_oracle.py:416``,
``test_ring_attention.py:108``, ``test_moe.py:114-181``):

* the dp x tp ``[2, 2]`` LR cohort step from one init and key: rtol 1e-4,
  atol 1e-5 (and with the clip, whose global norm sums the shards over
  the model axis);
* the head-parallel transformer's forward (atol 1e-5) and its NWP loss's
  gradients (rtol 1e-4, atol 2e-5);
* the ep LM (8 experts over 4 ranks) forward (rtol 1e-5, atol 2e-5) and
  gradients (rtol 1e-4, atol 2e-5);
* the dp x ep ``[2, 2]`` round with 4 experts: rtol 1e-4, atol 2e-5;
* every rank's ``params_sha256`` equal.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ep_jobs as jobs
from fedml_tpu.data.stacking import stack_client_data
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.models import TransformerLM as JLM
from fedml_tpu.parallel.cohort import make_cohort_step as j_step
from fedml_tpu.parallel.expert import ep_shard_params as j_ep_shard
from fedml_tpu.parallel.expert import make_dp_ep_mesh as j_dp_ep_mesh
from fedml_tpu.parallel.expert import make_expert_mesh as j_expert_mesh
from fedml_tpu.parallel.mesh import make_mesh as j_make_mesh
from fedml_tpu.parallel.mesh import tp_shard_params as j_tp_shard
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local
from fedml_tpu.trainer.workload import ClassificationWorkload as JCls
from fedml_tpu.trainer.workload import NWPWorkload as JNWP
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.core.pytree import flatten_nested, nest
from fedml_tpu_torch.parallel.expert import ep_shard_params
from fedml_tpu_torch.parallel.launch import spawn_ranks
from fedml_tpu_torch.parallel.mesh import Mesh, tp_shard_params
from fedml_tpu_torch.utils.jax_params import params_from_numpy

JOIN_S = 240.0
TP_MODEL = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                max_len=32)
EP_MODEL = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=16, moe_experts=8)
DP_EP_MODEL = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=1,
                   d_ff=64, max_len=8, moe_experts=4)
LR_CLIP = 0.05


def _flat(tree):
    return flatten_nested(jax.tree.map(np.asarray, tree))


def _spec(sharded):
    """JAX's ``PartitionSpec`` as the port's tuple (``()`` replicated)."""
    spec = tuple(sharded.sharding.spec)
    return () if all(s is None for s in spec) else spec


def _port_specs(placement):
    return {k: placement.spec(k) for k in placement.dims}


def _close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


# -- the cases' inputs ---------------------------------------------------------

def _lr_case():
    rng = np.random.RandomState(0)
    w = rng.randn(12, 4)
    xs, ys = [], []
    for _ in range(4):
        n = rng.randint(6, 21)
        x = rng.randn(n, 12).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ w + 0.1 * rng.randn(n, 4), 1)
                  .astype(np.int32))
    cohort = stack_client_data(xs, ys, batch_size=5)
    wl = JCls(JLR(input_dim=12, output_dim=4), num_classes=4,
              grad_clip_norm=None)
    params = wl.init(jax.random.key(0), jax.tree.map(
        lambda v: jnp.asarray(v[0, 0]),
        {k: cohort[k] for k in ("x", "y", "mask")}))
    return params, {k: np.asarray(v) for k, v in cohort.items()}


def _std(name, shape):
    """LeCun-like scales for a filled leaf: fan-in from the layout."""
    if name.endswith("embedding"):
        return 1.0 / np.sqrt(shape[-1])
    if name.endswith("out/kernel"):
        return 1.0 / np.sqrt(shape[0] * shape[1])
    if len(shape) == 3 and name.split("/")[-1] in ("w1", "w2"):
        return 1.0 / np.sqrt(shape[1])
    return 1.0 / np.sqrt(shape[0])


def _filled(model, toks, seed=0):
    """Weights for ``model``'s tree (shapes from ``jax.eval_shape``,
    values seeded numpy: flax's eager init of these nets takes seconds on
    the CPU): kernels at LeCun scales, LayerNorm scales near 1, nonzero
    biases, so every bias path is exercised."""
    shapes = flatten_nested(jax.eval_shape(
        model.init, jax.random.key(0), jnp.asarray(toks))["params"])
    rng = np.random.RandomState(seed)
    flat = {}
    for k, sd in shapes.items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if len(sd.shape) == 1:
            z = 1.0 + 0.1 * z if k.endswith("scale") else 0.1 * z
        else:
            z = z * _std(k, sd.shape)
        flat[k] = z
    return jax.tree.map(jnp.asarray, nest(flat))


def _dp_ep_cohort():
    rng = np.random.RandomState(0)
    xs = [rng.randint(1, 32, (4, 8)).astype(np.int32) for _ in range(4)]
    ys = [np.concatenate([x[:, 1:], x[:, :1]], axis=1) for x in xs]
    return {k: np.asarray(v)
            for k, v in stack_client_data(xs, ys, batch_size=2).items()}


@pytest.fixture(scope="module")
def cases():
    """JAX's inits and the cases' data (built here, not at import)."""
    lr_params, lr_cohort = _lr_case()
    tp_toks = np.random.RandomState(9).randint(0, 40, (4, 32)).astype(
        np.int32)
    ep_toks = np.random.RandomState(0).randint(1, 32, (4, 16)).astype(
        np.int32)
    dp_ep_cohort = _dp_ep_cohort()
    return {
        "lr": (lr_params, lr_cohort),
        "tp": (_filled(JLM(**TP_MODEL), tp_toks), tp_toks),
        "ep": (_filled(JLM(**EP_MODEL), ep_toks), ep_toks),
        "dp_ep": (_filled(JLM(**DP_EP_MODEL), dp_ep_cohort["x"][0, 0]),
                  dp_ep_cohort)}


# -- placements (no ranks) -----------------------------------------------------

def _port_mesh(shape):
    """One process's view of a mesh of that shape (rank 0; no group is
    needed to place a tree)."""
    return Mesh(shape, device="cpu")


def test_lr_placement_equals_jax(cases, devices):
    params, _ = cases["lr"]
    want = j_tp_shard(params, j_make_mesh(client_axis=4, model_axis=2,
                                          devices=devices), min_size=8)
    assert _spec(want["Dense_0"]["kernel"]) == (None, "model")
    shards, placement = tp_shard_params(
        params_from_numpy(jax.tree.map(np.asarray, params)),
        _port_mesh({"clients": 4, "model": 2}), min_size=8)
    assert _port_specs(placement) == {
        k: _spec(v) for k, v in flatten_nested(want).items()}
    assert tuple(shards["Dense_0/kernel"].shape) == (12, 2)


def test_tp_3d_gate_equals_jax(devices):
    tree = {"qkv": np.zeros((64, 4, 16), np.float32),
            "out": np.zeros((4, 16, 64), np.float32),
            "conv1d": np.zeros((3, 32, 32), np.float32),
            "square": np.zeros((32, 4, 32), np.float32)}
    want = j_tp_shard(jax.tree.map(jnp.asarray, tree),
                      j_make_mesh(client_axis=4, model_axis=2,
                                  devices=devices), min_size=8)
    _, placement = tp_shard_params(
        {k: torch.tensor(v) for k, v in tree.items()},
        _port_mesh({"clients": 4, "model": 2}), min_size=8)
    got = _port_specs(placement)
    assert got == {k: _spec(v) for k, v in want.items()}
    assert got["qkv"] == (None, "model", None)
    assert got["out"] == ("model", None, None)
    assert got["conv1d"] == got["square"] == ()


def test_transformer_placement_equals_jax(cases, devices):
    params, _ = cases["tp"]
    want = flatten_nested(j_tp_shard(
        params, j_make_mesh(client_axis=4, model_axis=2, devices=devices),
        min_size=512))
    _, placement = tp_shard_params(params_from_numpy(
        jax.tree.map(np.asarray, params)),
        _port_mesh({"clients": 4, "model": 2}), min_size=512)
    assert _port_specs(placement) == {k: _spec(v) for k, v in want.items()}
    heads = [k for k, s in _port_specs(placement).items() if len(s) == 3]
    assert len(heads) == 4          # q, k, v and out on their heads
    # JAX's min_size is an argument: the default shards nothing here
    _, none = tp_shard_params(params_from_numpy(
        jax.tree.map(np.asarray, params)),
        _port_mesh({"clients": 4, "model": 2}))
    assert not none.sharded


@pytest.mark.parametrize("experts", [8, 4])
def test_ep_placement_equals_jax(devices, experts):
    model = dict(EP_MODEL, moe_experts=experts)
    toks = np.random.RandomState(0).randint(1, 32, (4, 16)).astype(np.int32)
    params = _filled(JLM(**model), toks)
    jmesh = (j_expert_mesh(8, devices=devices) if experts == 8
             else j_dp_ep_mesh(2, 4, devices=devices))
    want = flatten_nested(j_ep_shard(params, jmesh, experts))
    shape = ({"experts": 8} if experts == 8
             else {"clients": 2, "experts": 4})
    shards, placement = ep_shard_params(
        params_from_numpy(jax.tree.map(np.asarray, params)),
        _port_mesh(shape), experts)
    got = _port_specs(placement)
    assert got == {k: _spec(v) for k, v in want.items()}
    assert got["moe_0/w1"] == ("experts", None, None)
    assert got["moe_0/b1"] == ("experts", None)
    assert got["moe_0/router/kernel"] == got["tok_embed/embedding"] == ()
    assert shards["moe_1/w2"].shape[0] == experts // shape["experts"]


def test_ep_indivisible_refused_as_jax(cases, devices):
    params, _ = cases["ep"]
    with pytest.raises(ValueError, match="not divisible"):
        j_ep_shard(params, j_expert_mesh(8, devices=devices), 12)
    with pytest.raises(ValueError, match="not divisible"):
        ep_shard_params(params_from_numpy(jax.tree.map(np.asarray, params)),
                        _port_mesh({"experts": 8}), 12)


def test_unported_layers_refuse_their_shards():
    """The CNN's sharded kernels and the MoE tables under the tp rule lie
    outside the layers that compute on shards: both raise by name."""
    from fedml_tpu_torch.experiments.models import create_workload
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel.cohort import make_cohort_step
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import (NWPWorkload, apply_model,
                                                  make_client_optimizer)
    mesh = _port_mesh({"clients": 1, "model": 2})
    axis = mesh.axis("model")
    cnn = create_workload("cnn", "femnist", 62, (28, 28, 1))
    _, placement = tp_shard_params(cnn.init(torch.Generator().manual_seed(0)),
                                   mesh, min_size=8)
    assert placement.sharded
    with pytest.raises(NotImplementedError, match="item 12"):
        placement.check(cnn.model)
    with pytest.raises(NotImplementedError, match="CNNDropOut.*item 12"):
        make_cohort_step(make_local_trainer(cnn, make_client_optimizer(
            "sgd", 0.1), 1), mesh=mesh, placement=placement)
    lm = TransformerLM(**dict(DP_EP_MODEL, max_len=16))
    params = NWPWorkload(lm).init(torch.Generator().manual_seed(0))
    shards, placement = tp_shard_params(params, mesh, min_size=2048)
    assert placement.sharded == ["moe_0/w1"]
    with pytest.raises(NotImplementedError, match="SwitchFFN.*item 12"):
        apply_model(lm, shards, torch.ones(2, 16, dtype=torch.long),
                    forward_kwargs={"tp_axis": axis})


# -- the computations on 4 ranks ------------------------------------------------

def _j_refs(c):
    """JAX's unsharded references for every spawned case."""
    refs = {}
    params, cohort = c["lr"]
    jc = {k: jnp.asarray(v) for k, v in cohort.items()}
    for name, clip in (("lr", None), ("lr_clip", LR_CLIP)):
        wl = JCls(JLR(input_dim=12, output_dim=4), num_classes=4,
                  grad_clip_norm=clip)
        out, _ = j_step(j_local(wl, j_opt("sgd", 0.1), epochs=1))(
            params, jc, jax.random.key(5))
        refs[name] = _flat(out)
    for name, spec in (("tp", TP_MODEL), ("ep", EP_MODEL)):
        params, toks = c[name]
        model = JLM(**spec)
        x = jnp.asarray(toks)
        refs[name + "_logits"] = np.asarray(jax.jit(
            lambda p, x: model.apply({"params": p}, x))(params, x))
        batch = {"x": x, "y": jnp.roll(x, -1, axis=1),
                 "mask": jnp.ones(x.shape[0], jnp.float32)}
        wl = JNWP(model)
        refs[name + "_grads"] = _flat(jax.jit(jax.grad(
            lambda p: wl.loss_fn(p, batch, None, True)[0]))(params))
    params, cohort = c["dp_ep"]
    out, _ = j_step(j_local(JNWP(JLM(**DP_EP_MODEL)), j_opt("sgd", 0.1),
                            epochs=1))(
        params, {k: jnp.asarray(v) for k, v in cohort.items()},
        jax.random.key(5))
    refs["dp_ep"] = _flat(out)
    return refs


@pytest.fixture(scope="module")
def runs(cases):
    """Every rank's results (4 ranks, spawned once from a worker thread)
    and, meanwhile, JAX's references."""
    words = tuple(int(w) for w in jax.random.key_data(jax.random.key(5)))
    lr_params, lr_cohort = cases["lr"]
    spec = {
        "lr": {"dims": (12, 4), "params": _flat(lr_params), "min_size": 8,
               "lr": 0.1, "clip": LR_CLIP, "cohort": lr_cohort,
               "seed_words": words},
        "tp": {"model": TP_MODEL, "params": _flat(cases["tp"][0]),
               "min_size": 512, "tokens": cases["tp"][1].astype(np.int64)},
        "ep": {"model": EP_MODEL, "params": _flat(cases["ep"][0]),
               "tokens": cases["ep"][1].astype(np.int64)},
        "dp_ep": {"model": DP_EP_MODEL, "params": _flat(cases["dp_ep"][0]),
                  "lr": 0.1, "cohort": cases["dp_ep"][1],
                  "seed_words": words}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, jobs.tp_ep_job, 4, (spec,), "cpu",
                          JOIN_S)
        refs = _j_refs(cases)
        return fut.result(), refs


def test_make_mesh_builds_the_model_axis(runs):
    ranks, _ = runs
    assert [r["coords"] for r in ranks] == [
        {"clients": c, "model": m} for c in (0, 1) for m in (0, 1)]


@pytest.mark.parametrize("case", ["lr", "lr_clip"])
def test_dp_tp_lr_step_matches_jax(runs, case):
    ranks, refs = runs
    for r in ranks:
        _close(r[case]["params"], refs[case], rtol=1e-4, atol=1e-5)
    assert len({r[case]["sha"] for r in ranks}) == 1
    assert ranks[0][case]["spec"]["Dense_0/kernel"] == (None, "model")


def test_tp_transformer_forward_and_grads_match_jax(runs):
    ranks, refs = runs
    for r in ranks:
        np.testing.assert_allclose(r["tp"]["logits"], refs["tp_logits"],
                                   atol=1e-5, rtol=0)
        _close(r["tp"]["grads"], refs["tp_grads"], rtol=1e-4, atol=2e-5)
        assert r["tp"]["tp_ms"] > 0
    assert sum(len(s) == 3 for s in ranks[0]["tp"]["spec"].values()) == 4


def test_ep_lm_forward_and_grads_match_jax(runs):
    ranks, refs = runs
    for r in ranks:
        np.testing.assert_allclose(r["ep"]["logits"], refs["ep_logits"],
                                   rtol=1e-5, atol=2e-5)
        _close(r["ep"]["grads"], refs["ep_grads"], rtol=1e-4, atol=2e-5)
    assert float(np.abs(ranks[0]["ep"]["grads"]["moe_0/router/kernel"]
                        ).max()) > 0


def test_dp_ep_round_matches_jax(runs):
    ranks, refs = runs
    for r in ranks:
        _close(r["dp_ep"]["params"], refs["dp_ep"], rtol=1e-4, atol=2e-5)
    assert len({r["dp_ep"]["sha"] for r in ranks}) == 1
