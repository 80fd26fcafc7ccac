"""The topology managers, the pytree helpers and gossip against the JAX
package.

* Topology matrices, both managers at several n, k and seeds, and the
  asymmetric manager on the global ``np.random`` (``seed=None``): bit
  for bit, neighbour lists and weights included.
* ``tree_zeros_like``, ``tree_scale``, ``tree_add``, ``tree_cast``,
  ``tree_global_norm``, ``tree_vector_norm``: 1e-6.
* ``mix_stacked`` and ``_ring_weights`` (n = 1, 2 and a ring, and their
  refusals): 1e-6.
* ``DecentralizedGossip``'s dense rounds from JAX's init, carried across:
  2 rounds of LR and one of the FEMNIST CNN on 12x12 images, 1e-6.
* The ring gossip over a mesh: ONE spawn of 3 gloo ranks on the CPU
  (`torch_mesh_jobs.gossip_job`), every rank held to the port's dense
  gossip at 1e-6 and the ranks to each other byte for byte;
  ``tree_weighted_psum_mean`` over the axis to JAX's weighted mean
  (1e-6); the one-node-a-rank refusal.
* The ``decentralized`` runner on ``--platform cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from fedml_tpu.algorithms.decentralized import DecentralizedConfig as JCfg
from fedml_tpu.algorithms.decentralized import DecentralizedGossip as JGossip
from fedml_tpu.algorithms.decentralized import _ring_weights as j_ring_weights
from fedml_tpu.algorithms.decentralized import mix_stacked as j_mix
from fedml_tpu.core import pytree as jpt
from fedml_tpu.core import topology as jtopo
from fedml_tpu.data.stacking import FederatedData as JData
from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms.decentralized import (DecentralizedConfig,
                                                      DecentralizedGossip,
                                                      _ring_weights,
                                                      mix_stacked)
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core import topology as topo
from fedml_tpu_torch.data.stacking import FederatedData, stack_client_data
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models import CNNOriginalFedAvg
from fedml_tpu_torch.parallel.launch import spawn_ranks
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy

TOL = 1e-6
WORLD = 3                      # gloo ranks of the mesh case, one node each
JOIN_S = 120                   # a spawn that outlives this fails the test
DIM, CLASSES = 10, 3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the suite runs files side by side, and torch's
    CPU convs and GroupNorm slow by tens of times when their thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# topology

@pytest.mark.parametrize("n,k", [(1, 2), (2, 2), (3, 2), (5, 2), (6, 4),
                                 (9, 3), (10, 4), (16, 6)])
def test_symmetric_topology_bit_equal(n, k):
    mine = topo.SymmetricTopologyManager(n, k)
    ref = jtopo.SymmetricTopologyManager(n, k)
    w, w_ref = mine.generate_topology(), ref.generate_topology()
    assert w.dtype == w_ref.dtype and np.array_equal(w, w_ref)
    for i in range(n + 1):
        assert mine.get_in_neighbor_idx_list(i) == \
            ref.get_in_neighbor_idx_list(i)
        assert mine.get_out_neighbor_idx_list(i) == \
            ref.get_out_neighbor_idx_list(i)
    assert np.array_equal(topo.ring_lattice_adjacency(n, k),
                          jtopo.ring_lattice_adjacency(n, k))
    assert np.array_equal(topo.ring_topology(n).topology,
                          jtopo.ring_topology(n).topology)


@pytest.mark.parametrize("n,und,out,seed", [(5, 2, 3, 0), (8, 4, 4, 1),
                                            (12, 3, 2, 7), (32, 4, 4, 3)])
def test_asymmetric_topology_bit_equal(n, und, out, seed):
    mine = topo.AsymmetricTopologyManager(n, und, out, seed=seed)
    ref = jtopo.AsymmetricTopologyManager(n, und, out, seed=seed)
    w, w_ref = mine.generate_topology(), ref.generate_topology()
    assert np.array_equal(w, w_ref)
    for i in (0, n // 2, n - 1, n):
        assert np.array_equal(mine.get_in_neighbor_weights(i),
                              ref.get_in_neighbor_weights(i))
        assert np.array_equal(mine.get_out_neighbor_weights(i),
                              ref.get_out_neighbor_weights(i))
        assert mine.get_in_neighbor_idx_list(i) == \
            ref.get_in_neighbor_idx_list(i)
        assert mine.get_out_neighbor_idx_list(i) == \
            ref.get_out_neighbor_idx_list(i)


def test_asymmetric_topology_on_the_global_random_state():
    """``seed=None`` draws from the global ``np.random``, as JAX's does:
    the same global seed gives the same matrix, and the draw advances the
    global state as much."""
    np.random.seed(11)
    w = topo.AsymmetricTopologyManager(9, 2, 3).generate_topology()
    after = np.random.rand()
    np.random.seed(11)
    w_ref = jtopo.AsymmetricTopologyManager(9, 2, 3).generate_topology()
    assert np.array_equal(w, w_ref) and np.random.rand() == after


# ---------------------------------------------------------------------------
# pytree helpers

def _tree(rng):
    return {"a/kernel": rng.randn(4, 3).astype(np.float32),
            "a/bias": rng.randn(3).astype(np.float32),
            "b": rng.randn(2, 2, 5).astype(np.float32)}


def test_pytree_helpers_match_jax():
    rng = np.random.RandomState(0)
    a, b = _tree(rng), _tree(rng)
    ta = {k: torch.tensor(v) for k, v in a.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    ja = jpt_nested(a)
    jb = jpt_nested(b)
    pairs = [
        (pt.tree_zeros_like(ta), jpt.tree_zeros_like(ja)),
        (pt.tree_scale(ta, 0.37), jpt.tree_scale(ja, 0.37)),
        (pt.tree_add(ta, tb), jpt.tree_add(ja, jb)),
        (pt.tree_cast(ta, torch.bfloat16), jpt.tree_cast(ja, jnp.bfloat16)),
    ]
    for got, want in pairs:
        want = params_from_numpy(jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), want))
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       want[k].numpy(), rtol=0, atol=TOL)
    assert pt.tree_cast(ta, torch.bfloat16)["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(pt.tree_global_norm(ta)),
                               float(jpt.tree_global_norm(ja)), rtol=TOL)
    np.testing.assert_allclose(float(pt.tree_vector_norm(ta, tb)),
                               float(jpt.tree_vector_norm(ja, jb)), rtol=TOL)


def jpt_nested(flat):
    """A flat ``a/b`` dict as the JAX package's nested tree."""
    return pt.nest({k: jnp.asarray(v) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# the mix and the ring weights

def test_mix_stacked_matches_jax():
    rng = np.random.RandomState(1)
    n = 6
    stacked = {"w": rng.randn(n, 4, 3).astype(np.float32),
               "b": rng.randn(n, 3).astype(np.float32)}
    W = topo.SymmetricTopologyManager(n, 4).generate_topology()
    got = mix_stacked({k: torch.tensor(v) for k, v in stacked.items()},
                      torch.tensor(W))
    want = j_mix({k: jnp.asarray(v) for k, v in stacked.items()},
                 jnp.asarray(W))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("W", [
    np.ones((1, 1), np.float32),
    np.array([[0.6, 0.4], [0.4, 0.6]], np.float32),
    topo.ring_topology(5).topology,
    topo.SymmetricTopologyManager(3, 2).generate_topology()])
def test_ring_weights_match_jax(W):
    np.testing.assert_allclose(_ring_weights(W), j_ring_weights(W),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("W", [
    np.full((1, 1), 0.5, np.float32),
    np.array([[0.6, 0.4], [0.3, 0.7]], np.float32),
    topo.SymmetricTopologyManager(8, 4).generate_topology()])
def test_ring_weights_refusals_match_jax(W):
    with pytest.raises(ValueError) as mine:
        _ring_weights(W)
    with pytest.raises(ValueError) as ref:
        j_ring_weights(W)
    assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the dense gossip against JAX's

def _clients(n, dim, classes, seed, shape=None):
    rng = np.random.RandomState(seed)
    W = rng.randn(dim, classes)
    xs, ys = [], []
    for _ in range(n):
        m = rng.randint(5, 13)
        x = rng.randn(m, dim).astype(np.float32)
        xs.append(x if shape is None else x.reshape((m,) + shape))
        ys.append(np.argmax(x @ W, axis=1).astype(np.int32))
    return xs, ys


def _gossip_pair(kind, n, rounds):
    """(port's stack, JAX's stack, port's history, JAX's history) of
    ``rounds`` dense gossip rounds from JAX's init."""
    if kind == "lr":
        xs, ys = _clients(n, DIM, CLASSES, 2)
        jm, mine = JLR(DIM, CLASSES), jobs.lr_workload(DIM, CLASSES)
        classes, clip = CLASSES, None
    else:   # the FEMNIST CNN on 12x12 single-channel images, 62 classes
        xs, ys = _clients(n, 144, 62, 3, shape=(12, 12, 1))
        jm = JCNN(only_digits=False)
        mine = ClassificationWorkload(
            CNNOriginalFedAvg(only_digits=False, image_size=12),
            num_classes=62, grad_clip_norm=1.0)
        classes, clip = 62, 1.0
    train = stack_client_data(xs, ys, batch_size=4)
    jwl = JWorkload(jm, num_classes=classes, grad_clip_norm=clip)
    init = jwl.init(jax.random.key(5), {k: jnp.asarray(train[k][0, 0])
                                        for k in ("x", "y", "mask")})
    stacked = jax.tree.map(lambda x: jnp.stack([x] * n), init)
    cfg = dict(comm_round=rounds, epochs=1, lr=0.1, neighbor_num=2,
               frequency_of_the_test=1, seed=0)
    ref = JGossip(jwl, JData(client_num=n, class_num=classes, train=train),
                  JCfg(**cfg))
    want = ref.run(stacked_params=stacked)
    algo = DecentralizedGossip(mine, FederatedData(
        client_num=n, class_num=classes, train=train),
        DecentralizedConfig(**cfg), device="cpu")
    got = algo.run(params_from_numpy(jax.tree.map(np.asarray, stacked)))
    return (got, params_from_numpy(jax.tree.map(np.asarray, want)),
            algo.history, ref.history)


@pytest.mark.parametrize("kind,n,rounds", [("lr", 5, 2), ("cnn", 3, 1)])
def test_dense_gossip_matches_jax(kind, n, rounds):
    got, want, hist, ref_hist = _gossip_pair(kind, n, rounds)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=TOL, err_msg=k)
    assert [h["round"] for h in hist] == [h["round"] for h in ref_hist]
    np.testing.assert_allclose([h["train_acc"] for h in hist],
                               [h["train_acc"] for h in ref_hist], atol=1e-6)


# ---------------------------------------------------------------------------
# the ring gossip over a mesh of gloo ranks

def _mesh_spec():
    xs, ys = _clients(WORLD, DIM, CLASSES, 4)
    rng = np.random.RandomState(6)
    init = {"Dense_0/kernel": (0.1 * rng.randn(DIM, CLASSES)).astype(
        np.float32), "Dense_0/bias": np.zeros(CLASSES, np.float32)}
    trees = {"k": rng.randn(WORLD, 4, 3).astype(np.float32),
             "b": rng.randn(WORLD, 3).astype(np.float32)}
    return {"gossip": {"xs": xs, "ys": ys, "batch": 4, "classes": CLASSES,
                       "dim": DIM,
                       "cfg": dict(comm_round=2, epochs=1, lr=0.1,
                                   neighbor_num=2, frequency_of_the_test=1,
                                   seed=0),
                       "init": {k: np.stack([v] * WORLD)
                                for k, v in init.items()}},
            "psum": {"trees": trees,
                     "weights": [3.0, 1.0, 5.0]}}


@pytest.fixture(scope="module")
def mesh_runs():
    spec = _mesh_spec()
    ranks = spawn_ranks(jobs.gossip_job, WORLD, (WORLD, spec), "cpu", JOIN_S)
    return spec, ranks


def test_ring_gossip_on_the_mesh_matches_the_dense_gossip(mesh_runs):
    spec, ranks = mesh_runs
    g = spec["gossip"]
    dense = DecentralizedGossip(
        jobs.lr_workload(g["dim"], g["classes"]),
        jobs.fed_data(g["xs"], g["ys"], g["batch"], g["classes"]),
        DecentralizedConfig(**g["cfg"]), device="cpu")
    want = dense.run({k: torch.tensor(v) for k, v in g["init"].items()})
    assert len({r["gossip_sha256"] for r in ranks}) == 1
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["gossip"][k], v.numpy(), rtol=0,
                                       atol=TOL, err_msg=k)
        np.testing.assert_allclose([h["train_acc"] for h in r["history"]],
                                   [h["train_acc"] for h in dense.history],
                                   atol=1e-6)
        assert r["p2p_ms"] > 0
        assert r["refusal"] == "mesh gossip needs one node per device"


def test_weighted_psum_mean_over_the_mesh_matches_jax(mesh_runs):
    spec, ranks = mesh_runs
    p = spec["psum"]
    want = jpt.tree_weighted_mean(
        {k: jnp.asarray(v) for k, v in p["trees"].items()},
        jnp.asarray(p["weights"]))
    for r in ranks:
        for k in p["trees"]:
            np.testing.assert_allclose(r["psum_mean"][k], np.asarray(want[k]),
                                       rtol=0, atol=TOL)


def test_decentralized_runner_on_the_cpu():
    out = main(["--algo", "decentralized", "--model", "lr", "--dataset",
                "mnist", "--client_num_in_total", "4", "--batch_size", "8",
                "--comm_round", "2", "--neighbor_num", "2", "--platform",
                "cpu", "--log_stdout", "false"])
    assert out["round"] == 1 and 0.0 <= out["train_acc"] <= 1.0
    assert out["params_finite"] and out["device"] == "cpu"
