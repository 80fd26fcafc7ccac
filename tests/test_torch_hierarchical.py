"""The port's hierarchical FL (``fedml_tpu_torch/algorithms/
hierarchical.py``) against the JAX package's.

* `HierarchicalFedAvg`: the port loops over the groups where JAX vmaps
  them (``make_grouped_round``); on the same synthetic clients and init,
  with empty groups arising from the random assignment, the global is
  held to JAX's vmapped path at ``atol=1e-5`` after 3 rounds;
  ``group_num=1, group_comm_round=1`` equals FedAvg (1e-5), as BASELINE's
  oracle and JAX ``tests/test_algorithms.py:204-210`` hold it.
* The edge tier: an edge topology equals the flat federation (1e-6, the
  two-level mean adds in another order); ``--secagg grouped`` and
  ``pairwise`` agree with plaintext within the ring quantisation
  (test_loss 1e-3, as JAX ``tests/test_secagg_live.py:595-604``); an edge
  killed after a fold resumes its block from its journal and the root's
  global equals the uncrashed run's bit for bit; a JAX root takes port
  edges' frames over one MQTT broker.
* The gates refuse what the JAX package's refuse.
"""

import threading

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as jcs
from fedml_tpu.algorithms.hierarchical import HierarchicalConfig as JHConfig
from fedml_tpu.algorithms.hierarchical import HierarchicalFedAvg as JHier
from fedml_tpu.comm import mqtt_transport as jmt
from fedml_tpu.data import registry as j_registry
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.algorithms.hierarchical import (EdgeAggregatorActor,
                                                     HierarchicalConfig,
                                                     HierarchicalFedAvg,
                                                     make_two_level_round)
from fedml_tpu_torch.comm import mqtt_transport as mt
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.core.pytree import flatten_nested
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.data.stacking import FederatedData, stack_client_data
from fedml_tpu_torch.experiments import main as t_main
from fedml_tpu_torch.experiments.config import ExperimentConfig
from fedml_tpu_torch.models import LogisticRegression
from fedml_tpu_torch.robust.faultline import (ActorKilled, CrashSpec,
                                              Faultline, kill_actor)
from fedml_tpu_torch.trainer.workload import ClassificationWorkload
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy
from fedml_tpu_torch.utils.journal import RoundJournal

DIM, CLASSES, N_CLIENTS = 12, 4, 10


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def _data():
    rng = np.random.RandomState(0)
    W = rng.randn(DIM, CLASSES)
    xs, ys = [], []
    for _ in range(N_CLIENTS):
        n = rng.randint(6, 21)
        x = rng.randn(n, DIM).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ W, axis=1).astype(np.int32))
    train = stack_client_data(xs, ys, batch_size=5)
    return (FederatedData(client_num=N_CLIENTS, class_num=CLASSES,
                          train=train, test=train),
            j_registry.FederatedData(client_num=N_CLIENTS, class_num=CLASSES,
                                     train=train, test=train))


def _workloads():
    return (JWorkload(JLR(DIM, CLASSES), num_classes=CLASSES),
            ClassificationWorkload(LogisticRegression(DIM, CLASSES),
                                   num_classes=CLASSES))


COMMON = dict(comm_round=3, client_num_per_round=4, batch_size=5, lr=0.3,
              frequency_of_the_test=1, seed=3)


@pytest.mark.parametrize("groups,group_rounds", [(2, 2), (3, 1), (4, 2)])
def test_grouped_rounds_match_the_jax_vmapped_path(groups, group_rounds):
    t_data, j_data = _data()
    jwl, twl = _workloads()
    p0 = jwl.init(jax.random.key(7), jax.tree.map(
        lambda v: v[0, 0], {k: t_data.train[k] for k in ("x", "y", "mask")}))
    kw = dict(COMMON, group_num=groups, group_comm_round=group_rounds)
    j_algo = JHier(jwl, j_data, JHConfig(**kw))
    assert j_algo._grouped_round is not None      # the vmapped path
    want = j_algo.run(params=p0)
    t_algo = HierarchicalFedAvg(twl, t_data, HierarchicalConfig(**kw),
                                device="cpu")
    assert (t_algo.group_indexes == j_algo.group_indexes).all()
    got = t_algo.run(params=params_from_numpy(jax.tree.map(np.asarray,
                                                           p0)))
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    assert len(t_algo.history) == len(j_algo.history) == 3
    for row_t, row_j in zip(t_algo.history, j_algo.history):
        assert abs(row_t["train_loss"] - row_j["train_loss"]) < 1e-4
    if groups == 4:
        # some round leaves a group empty: it keeps the params, weight 0
        from fedml_tpu_torch.core.sampling import sample_clients
        assert any(len(t_algo._group_clients(sample_clients(r, N_CLIENTS,
                                                            4))) < groups
                   for r in range(3))


def test_single_group_equals_fedavg():
    t_data, _ = _data()
    _, twl = _workloads()
    fa = FedAvg(twl, t_data, FedAvgConfig(**COMMON), device="cpu")
    p0 = fa.init_params()
    want = fa.run(params={k: v.clone() for k, v in p0.items()})
    fh = HierarchicalFedAvg(twl, t_data, HierarchicalConfig(
        **COMMON, group_num=1, group_comm_round=1), device="cpu")
    got = fh.run(params={k: v.clone() for k, v in p0.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_hierarchical_runner_checkpoints_and_refusals(tmp_path):
    base = ["--algo", "hierarchical", "--model", "lr", "--dataset",
            "mnist", "--client_num_in_total", "12", "--client_num_per_round",
            "4", "--batch_size", "4", "--group_num", "2",
            "--group_comm_round", "2", "--platform", "cpu",
            "--log_stdout", "false", "--checkpoint_dir", str(tmp_path),
            "--checkpoint_every", "1"]
    out = t_main.main(base + ["--comm_round", "2"])
    assert out["params_finite"] and out["round"] == 1
    resumed = t_main.main(base + ["--comm_round", "3"])
    assert resumed["round"] == 2
    # the two-level mesh is ported: its group axis must equal group_num
    from fedml_tpu_torch.parallel.mesh import make_two_level_mesh
    with pytest.raises(ValueError, match="group_num"):
        HierarchicalFedAvg(_workloads()[1], _data()[0], HierarchicalConfig(
            **COMMON), mesh=make_two_level_mesh(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="client_axis"):
        HierarchicalFedAvg(_workloads()[1], _data()[0], HierarchicalConfig(
            **COMMON, client_axis="scan"), device="cpu")


# ---------------------------------------------------------------------------
# the live edge tier
# ---------------------------------------------------------------------------

class _Sink:
    def log(self, row, step=None):
        pass


_CLI = dict(algo="cross_silo", model="lr", dataset="mnist",
            client_num_in_total=8, client_num_per_round=4, batch_size=4,
            comm_round=2, frequency_of_the_test=2, agg_mode="stream",
            platform="cpu", log_stdout=False)


def _fed(**kw):
    cfg = ExperimentConfig(**{**_CLI, **kw})
    t_main.check_config(cfg)
    fed = t_main.CrossSiloFederation(cfg, t_main.load_experiment_data(cfg),
                                     _Sink())
    return fed, fed.run()


def test_edges_equal_the_flat_topology():
    flat, _ = _fed()
    edged, out = _fed(edge_aggregators=2)
    assert out["params_finite"] and edged.server.round_idx == 2
    assert len(edged.edges) == 2 and edged.server._num_silos == 2
    for k, v in flat.server.params.items():
        np.testing.assert_allclose(edged.server.params[k].numpy(),
                                   v.numpy(), rtol=0, atol=1e-6)


def test_grouped_pairwise_and_plaintext_agree():
    _, plain = _fed()
    _, pairwise = _fed(secagg="pairwise")
    grouped_fed, grouped = _fed(secagg="grouped", edge_aggregators=2)
    assert all(e.secagg is not None for e in grouped_fed.edges)
    assert grouped_fed.server.secagg is None          # the root: plaintext
    assert abs(pairwise["test_loss"] - plain["test_loss"]) < 1e-3
    assert abs(grouped["test_loss"] - plain["test_loss"]) < 1e-3
    assert abs(pairwise["train_acc"] - plain["train_acc"]) < 1e-6


def test_root_sample_cap_scales_with_the_largest_block():
    fed, _ = _fed(edge_aggregators=2, norm_clip=5.0, max_num_samples=1000,
                  comm_round=1)
    assert fed.server.admission.max_num_samples == 2000
    assert all(e.admission.max_num_samples == 1000 for e in fed.edges)


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return params_from_numpy(
        {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                   "bias": rng.randn(3).astype(np.float32)}})


def _train_fn(silo):
    def fn(params, client_idx, round_idx):
        rng = np.random.RandomState(1000 * silo + int(round_idx or 0))
        return {k: np.asarray(v) + rng.randn(*np.shape(v))
                .astype(np.float32) * 0.1 for k, v in params.items()}, \
            10 + silo
    return fn


def _build(init, jr_dir=None, fl=None):
    hub = LocalHub(codec_roundtrip=True)
    root = FedAvgServerActor(hub.transport(0), init, 4, 2, 2)
    edges = []
    for e, block in ((1, (1, 2)), (2, (3, 4))):
        edges.append(EdgeAggregatorActor(
            e, hub.transport(e), {2 + g: g for g in block},
            cohort_total=4, client_num_in_total=4,
            stream_agg=StreamingAggregator(init, method="mean",
                                           kind="params", seed=0),
            journal=(RoundJournal(jr_dir, snapshot_every=1)
                     if jr_dir and e == 1 else None),
            faultline=fl if e == 1 else None))
    silos = [FedAvgClientActor(2 + g, hub.transport(2 + g), _train_fn(g),
                               server_id=(1 if g <= 2 else 2))
             for g in (1, 2, 3, 4)]
    for a in [root] + edges + silos:
        a.register_handlers()
    return hub, root, edges


def test_edge_kill_respawn_resumes_the_block_bit_identical(tmp_path):
    init = _params(3)
    hub, root, _ = _build(init)
    root.start()
    hub.pump()
    want = {k: v.numpy().tobytes() for k, v in root.params.items()}
    assert root.round_idx == 2
    jdir = str(tmp_path / "e1")
    fl = Faultline(crashes=[CrashSpec(point="post_fold_pre_ack", hit=1,
                                      round_idx=0)])
    hub, root, edges = _build(init, jr_dir=jdir, fl=fl)
    root.start()
    with pytest.raises(ActorKilled):
        hub.pump()
    kill_actor(edges[0])
    respawned = EdgeAggregatorActor(
        1, hub.transport(1), {3: 1, 4: 2}, cohort_total=4,
        client_num_in_total=4,
        stream_agg=StreamingAggregator(init, method="mean", kind="params",
                                       seed=0),
        journal=RoundJournal(jdir, snapshot_every=1))
    respawned.register_handlers()
    assert respawned.resume()
    hub.pump()
    assert root.round_idx == 2
    assert {k: v.numpy().tobytes() for k, v in root.params.items()} == want
    root.finish()


def test_edge_without_a_snapshot_gives_the_round_up(tmp_path):
    init = _params(3)
    jdir = str(tmp_path / "e1")
    j = RoundJournal(jdir)
    j.round_start(0, mode="stream_mean", resumable=True, global_crc=None,
                  expected=[3, 4])
    edge = EdgeAggregatorActor(
        1, LocalHub().transport(1), {3: 1, 4: 2}, cohort_total=4,
        client_num_in_total=4,
        stream_agg=StreamingAggregator(init, method="mean", kind="params"),
        journal=RoundJournal(jdir))
    assert edge.resume() is False
    with pytest.raises(ValueError, match="exactly one"):
        EdgeAggregatorActor(1, LocalHub().transport(1), {3: 1}, 4, 4, None)
    # the edge's health seam is ported: taken, not refused
    edge = EdgeAggregatorActor(1, LocalHub().transport(1), {3: 1}, 4, 4,
                               StreamingAggregator(init), health=object())
    assert edge.health is not None


def _exact_init():
    return {"dense": {"kernel": np.arange(12, dtype=np.float32)
                      .reshape(4, 3), "bias": np.full(3, -4.0, np.float32)}}


def _t_exact(silo):
    def fn(params, client_idx, round_idx):
        return {k: np.asarray(v) + np.float32(silo)
                for k, v in params.items()}, 2
    return fn


def test_a_jax_root_takes_port_edges_over_one_broker():
    """Port edges and silos, a JAX root, one MQTT broker: the edge frames
    ``(mean, weight, count)`` cross the packages, and the exact sums give
    the flat global bit for bit (the global moves by mean(1..4) a
    round)."""
    rounds = 2
    with MqttBroker() as broker:
        ts = {0: jmt.MqttTransport(0, "127.0.0.1", broker.port)}
        for i in range(1, 7):
            ts[i] = mt.MqttTransport(i, "127.0.0.1", broker.port)
        root = jcs.FedAvgServerActor(ts[0], _exact_init(), 4, 2, rounds)
        edges = [EdgeAggregatorActor(
            e, ts[e], {2 + g: g for g in block}, cohort_total=4,
            client_num_in_total=4,
            stream_agg=StreamingAggregator(params_from_numpy(_exact_init()),
                                           method="mean", kind="params"))
            for e, block in ((1, (1, 2)), (2, (3, 4)))]
        silos = [FedAvgClientActor(2 + g, ts[2 + g], _t_exact(g),
                                   server_id=1 if g <= 2 else 2)
                 for g in (1, 2, 3, 4)]
        actors = edges + silos
        threads = [threading.Thread(target=a.run, daemon=True,
                                    name=f"node-{a.node_id}")
                   for a in actors]
        for th in threads:
            th.start()
        root.register_handlers()
        root.start()
        st = threading.Thread(target=ts[0].run, daemon=True, name="node-0")
        st.start()
        st.join(timeout=30)
        finished = not st.is_alive()
        for th in threads:
            th.join(timeout=2)
        for t in ts.values():
            t.stop()
        for th in threads + [st]:
            th.join(timeout=5)
    assert finished and root.round_idx == rounds
    got = flatten_nested(jax.tree.map(np.asarray, root.params))
    np.testing.assert_array_equal(got["dense/bias"],
                                  np.full(3, -4.0 + rounds * 2.5, np.float32))


@pytest.mark.parametrize("flags,match", [
    (dict(edge_aggregators=5), "must be in 1..4"),
    (dict(edge_aggregators=2, wire_compression="topk"), "edge tier"),
    (dict(edge_aggregators=2, dead_after_s=5.0), "heartbeats terminate"),
    (dict(edge_aggregators=2, secagg="pairwise"), "use --secagg grouped"),
    (dict(edge_aggregators=3, secagg="grouped"), "short block"),
    (dict(edge_aggregators=2, model_shards=2), "edge_aggregators"),
    (dict(secagg="grouped"), "needs --edge_aggregators"),
])
def test_edge_gates(flags, match):
    cfg = ExperimentConfig(**{**_CLI, **flags})
    with pytest.raises(ValueError, match=match):
        t_main.check_config(cfg)
        t_main.CrossSiloFederation(cfg, t_main.load_experiment_data(cfg),
                                   _Sink())
