"""SplitNN, vertical FL, FedGKT and the base framework against the JAX
package, each from JAX's init carried across.

* SplitNN: the simulator's body and head after 2 round-robin sweeps of 3
  clients, 2 epochs each, and its history (loss, accuracy, order): 1e-5;
  one client's epoch over the hub actors against the port's simulator
  and against JAX's actors: 1e-5.
* Vertical FL: ``fit``'s parties and history, and the wire protocol's
  losses and parties against the joint step: 1e-6.
* FedGKT: ``kd_kl_loss`` 1e-6 relative; one round at ``blocks=1,
  layers=(1, 1)`` with 2 clients, client and server nets and the losses: 1e-4 (flax's
  GroupNorm takes E[x²] − E[x]², `F.group_norm` E[(x − mean)²]).
* ``run_base_framework_demo(3, 2) == [3, 3]``, as JAX's.
* The ``split_nn``, ``vfl`` and ``fedgkt`` runners on ``--platform
  cpu``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import base_framework as jbase
from fedml_tpu.algorithms import fedgkt as jgkt
from fedml_tpu.algorithms import split_nn as jsplit
from fedml_tpu.algorithms import vertical_fl as jvfl
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.data.tabular import synthetic_vfl_parties
from fedml_tpu.models import GKTClientResNet as JGKTClient
from fedml_tpu.models import GKTServerResNet as JGKTServer
from fedml_tpu.models import VFLPartyNet as JVFLPartyNet
from fedml_tpu_torch.algorithms import base_framework, fedgkt, split_nn
from fedml_tpu_torch.algorithms import vertical_fl as vfl
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.resnet_gkt import GKTClientResNet, GKTServerResNet
from fedml_tpu_torch.models.vfl import VFLPartyNet
from fedml_tpu_torch.utils.jax_params import params_from_numpy

SPLIT_TOL = 1e-5
VFL_TOL = 1e-6
GKT_TOL = 1e-4
DIM, HID, CLASSES = 12, 16, 5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the suite runs files side by side, and torch's
    CPU convs and GroupNorm slow by tens of times when their thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want_jax, tol):
    want = params_from_numpy(_np(want_jax))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().cpu().numpy(),
                                   want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# SplitNN

class _JBody(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return nn.relu(nn.Dense(HID)(x.reshape(x.shape[0], -1)))


class _JHead(nn.Module):
    @nn.compact
    def __call__(self, a, train=False):
        return nn.Dense(CLASSES)(a)


class _Body(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(DIM, HID)

    def forward(self, x):
        return torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(HID, CLASSES)

    def forward(self, a):
        return self.Dense_0(a)


def _client_batches(n_clients=3, steps=3, bs=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_clients):
        mask = np.ones((steps, bs), np.float32)
        mask[-1, bs // 2:] = 0.0                      # a padded tail
        out.append({"x": rng.randn(steps, bs, DIM).astype(np.float32),
                    "y": rng.randint(0, CLASSES, (steps, bs)).astype(
                        np.int32),
                    "mask": mask})
    return out


def test_splitnn_simulator_matches_jax():
    data = _client_batches()
    cfg = dict(epochs_per_client=2, rounds=2, client_lr=0.05,
               server_lr=0.05)
    jsm = jsplit.SplitModel(_JBody(), _JHead())
    want = jsplit.SplitNNSimulator(jsm, jsplit.SplitNNConfig(**cfg)).run(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in data],
        jax.random.key(0))
    body0, head0 = jsm.init(jax.random.key(0), jnp.asarray(data[0]["x"][0]))
    sim = split_nn.SplitNNSimulator(split_nn.SplitModel(_Body(), _Head()),
                                    split_nn.SplitNNConfig(**cfg),
                                    device="cpu")
    got = sim.run(data, params=(params_from_numpy(_np(body0)),
                                params_from_numpy(_np(head0))))
    _close(got["body_params"], want["body_params"], SPLIT_TOL)
    _close(got["head_params"], want["head_params"], SPLIT_TOL)
    assert [(h["sweep"], h["client"]) for h in got["history"]] == \
        [(h["sweep"], h["client"]) for h in want["history"]]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose([a["loss"], a["acc"]],
                                   [b["loss"], b["acc"]], atol=SPLIT_TOL)
    ev = sim.evaluate(got["body_params"], got["head_params"], data[0])
    jev = jsplit.SplitNNSimulator(jsm, jsplit.SplitNNConfig(**cfg)).evaluate(
        want["body_params"], want["head_params"],
        {k: jnp.asarray(v) for k, v in data[0].items()})
    np.testing.assert_allclose([ev["loss"], ev["acc"]],
                               [jev["loss"], jev["acc"]], atol=SPLIT_TOL)


def test_splitnn_hub_actors_match_the_simulator_and_jax():
    """One client's epoch over the actors (activations up, gradients down
    per batch) against the simulator's epoch, and JAX's actors."""
    data = _client_batches(n_clients=1)[0]
    cfg = dict(epochs_per_client=1, rounds=1, client_lr=0.05,
               server_lr=0.05)
    jsm = jsplit.SplitModel(_JBody(), _JHead())
    body0, head0 = jsm.init(jax.random.key(1), jnp.asarray(data["x"][0]))
    b0, h0 = params_from_numpy(_np(body0)), params_from_numpy(_np(head0))
    sm = split_nn.SplitModel(_Body(), _Head())
    c = split_nn.SplitNNConfig(**cfg)
    sim = split_nn.SplitNNSimulator(sm, c, device="cpu")
    ref = sim._epoch_step(b0, h0, sim.client_opt.init(b0),
                          sim.server_opt.init(h0),
                          {k: torch.tensor(v) for k, v in data.items()})

    def wire(pkg, hub, body, head):
        server = pkg.SplitNNServerActor(
            0, hub.transport(0), jsm if pkg is jsplit else sm, head,
            pkg.SplitNNConfig(**cfg), **({} if pkg is jsplit
                                         else {"device": "cpu"}))
        client = pkg.SplitNNClientActor(
            1, hub.transport(1), jsm if pkg is jsplit else sm, body, data,
            server_id=0, cfg=pkg.SplitNNConfig(**cfg),
            **({} if pkg is jsplit else {"device": "cpu"}))
        server.register_handlers()
        client.register_handlers()
        client.start_epoch()
        hub.pump()
        return client.body_params, server.head_params, server.metrics

    got_b, got_h, metrics = wire(split_nn, LocalHub(), b0, h0)
    jb, jh, jmetrics = wire(jsplit, JHub(), body0, head0)
    for k in got_b:
        np.testing.assert_allclose(got_b[k].numpy(), ref[0][k].numpy(),
                                   atol=SPLIT_TOL)
    for k in got_h:
        np.testing.assert_allclose(got_h[k].numpy(), ref[1][k].numpy(),
                                   atol=SPLIT_TOL)
    _close(got_b, jb, SPLIT_TOL)
    _close(got_h, jh, SPLIT_TOL)
    np.testing.assert_allclose([metrics[k] for k in sorted(metrics)],
                               [jmetrics[k] for k in sorted(jmetrics)],
                               atol=SPLIT_TOL)


# ---------------------------------------------------------------------------
# vertical FL

def _vfl_models(train, hidden=6):
    dims = [x.shape[1] for x in train[:-1]]
    return ([VFLPartyNet(d, hidden_dim=hidden) for d in dims],
            [JVFLPartyNet(hidden_dim=hidden) for _ in dims])


def test_vfl_fit_matches_jax():
    train, test = synthetic_vfl_parties(n_samples=160, feature_dims=(5, 7),
                                        seed=1, neg_label=-1)
    cfg = dict(rounds=12, batch_size=48, lr=0.1, frequency_of_the_test=5)
    mine, theirs = _vfl_models(train)
    ref = jvfl.VerticalFL(theirs, jvfl.VFLConfig(**cfg))
    jp, _ = ref.init(jax.random.key(3), [jnp.asarray(x) for x in train[:-1]])
    want = ref.fit(train, test, jax.random.key(3))
    got = vfl.VerticalFL(mine, vfl.VFLConfig(**cfg), device="cpu").fit(
        train, test, params=[params_from_numpy(_np(p)) for p in jp])
    for g, w in zip(got["params"], want["params"]):
        _close(g, w, VFL_TOL)
    assert [h["round"] for h in got["history"]] == \
        [h["round"] for h in want["history"]]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=VFL_TOL)
        assert a["test_acc"] == b["test_acc"]


def test_vfl_wire_protocol_matches_the_joint_step_and_jax():
    train, _ = synthetic_vfl_parties(n_samples=96, feature_dims=(5, 7),
                                     seed=2)
    Xa, Xb, y = train
    cfg = dict(rounds=5, batch_size=32, lr=0.05, momentum=0.9,
               weight_decay=0.01)
    mine, theirs = _vfl_models(train)
    jp, _ = jvfl.VerticalFL(theirs, jvfl.VFLConfig(**cfg)).init(
        jax.random.key(7), [jnp.asarray(Xa), jnp.asarray(Xb)])
    init = [params_from_numpy(_np(p)) for p in jp]
    joint = vfl.VerticalFL(mine, vfl.VFLConfig(**cfg), device="cpu")
    params, opts = init, [joint.opt.init(p) for p in init]
    joint_losses = []
    for rnd in range(cfg["rounds"]):
        idx = vfl._cyclic_batch(rnd, cfg["batch_size"], len(y))
        params, opts, loss = joint._step(
            params, opts, [torch.tensor(Xa[idx]), torch.tensor(Xb[idx])],
            torch.tensor(y[idx]))
        joint_losses.append(float(loss))
    guest = vfl.VFLGuest(mine[0], Xa, y, vfl.VFLConfig(**cfg), device="cpu")
    host = vfl.VFLHost(mine[1], Xb, vfl.VFLConfig(**cfg), device="cpu")
    wire_losses = vfl.run_vfl_protocol(guest, [host], cfg["rounds"],
                                       cfg["batch_size"], params=init)
    jguest = jvfl.VFLGuest(theirs[0], Xa, y, jvfl.VFLConfig(**cfg))
    jhost = jvfl.VFLHost(theirs[1], Xb, jvfl.VFLConfig(**cfg))
    jlosses = jvfl.run_vfl_protocol(jguest, [jhost], cfg["rounds"],
                                    cfg["batch_size"], jax.random.key(7))
    np.testing.assert_allclose(wire_losses, joint_losses, rtol=VFL_TOL)
    np.testing.assert_allclose(wire_losses, jlosses, rtol=VFL_TOL)
    for k in guest.params:
        np.testing.assert_allclose(guest.params[k].numpy(),
                                   params[0][k].numpy(), atol=VFL_TOL)
        np.testing.assert_allclose(host.params[k].numpy(),
                                   params[1][k].numpy(), atol=VFL_TOL)
    _close(guest.params, jguest.params, VFL_TOL)
    _close(host.params, jhost.params, VFL_TOL)


def test_vfl_runs_from_its_own_init_and_the_party_order():
    """Weights drawn from one seed, party by party, are the joint step's
    and the protocol's alike."""
    train, test = synthetic_vfl_parties(n_samples=64, feature_dims=(3, 4),
                                        seed=5)
    mine, _ = _vfl_models(train, hidden=4)
    joint = vfl.VerticalFL(mine, vfl.VFLConfig(rounds=3, batch_size=16),
                           device="cpu")
    p, _ = joint.init(9)
    guest = vfl.VFLGuest(mine[0], train[0], train[2], joint.cfg,
                         device="cpu")
    host = vfl.VFLHost(mine[1], train[1], joint.cfg, device="cpu")
    vfl.run_vfl_protocol(guest, [host], 0, 16, rng=9)
    for k in p[0]:
        assert torch.equal(p[0][k], guest.params[k])
        assert torch.equal(p[1][k], host.params[k])


# ---------------------------------------------------------------------------
# FedGKT

def test_kd_kl_loss_matches_jax():
    rng = np.random.RandomState(0)
    s = rng.randn(6, 7).astype(np.float32) * 3
    t = rng.randn(6, 7).astype(np.float32) * 3
    for T in (1.0, 3.0):
        got = fedgkt.kd_kl_loss(torch.tensor(s), torch.tensor(t), T)
        want = jgkt.kd_kl_loss(jnp.asarray(s), jnp.asarray(t), T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


def test_fedgkt_round_matches_jax():
    rng = np.random.RandomState(0)
    C, S, B = 2, 2, 4
    cohort = {"x": rng.rand(C, S, B, 8, 8, 3).astype(np.float32),
              "y": rng.randint(0, 4, (C, S, B)).astype(np.int32),
              "mask": np.ones((C, S, B), np.float32)}
    cohort["mask"][1, 1, 2:] = 0.0
    cfg = dict(rounds=1, epochs_client=1, epochs_server=1, lr_client=0.05,
               lr_server=0.05, temperature=3.0, alpha=1.0)
    ref = jgkt.FedGKT(JGKTClient(blocks=1, num_classes=4),
                      JGKTServer(layers=(1, 1), num_classes=4),
                      jgkt.FedGKTConfig(**cfg))
    # flax's eager init of the vmapped nets takes ~18 s on the CPU; jitted
    # ~4 s, the same weights for JAX's run and the port's
    ref.init = jax.jit(ref.init)
    jc = {k: jnp.asarray(v) for k, v in cohort.items()}
    cp0, _, sp0, _ = ref.init(jax.random.key(0), jc)
    want = ref.run(jc, jax.random.key(0))
    algo = fedgkt.FedGKT(GKTClientResNet(blocks=1, num_classes=4),
                         GKTServerResNet(layers=(1, 1), num_classes=4),
                         fedgkt.FedGKTConfig(**cfg), device="cpu")
    got = algo.run(cohort, params=(params_from_numpy(_np(cp0)),
                                   params_from_numpy(_np(sp0))))
    _close(got["client_params"], want["client_params"], GKT_TOL)
    _close(got["server_params"], want["server_params"], GKT_TOL)
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose([a["client_loss"], a["server_loss"]],
                                   [b["client_loss"], b["server_loss"]],
                                   atol=GKT_TOL)
    assert set(algo.phase_times[0]) == {"clients", "server", "distil"}
    ev = algo.evaluate(got["client_params"], got["server_params"], cohort)
    jev = ref.evaluate(want["client_params"], want["server_params"], jc)
    assert ev["acc"] == jev["acc"]


def test_fedgkt_refuses_a_phase_without_epochs():
    with pytest.raises(ValueError, match="epochs_client >= 1"):
        fedgkt.FedGKTConfig(epochs_server=0)


# ---------------------------------------------------------------------------
# the base framework and the runners

def test_base_framework_demo_matches_jax():
    assert base_framework.run_base_framework_demo(3, 2) == [3, 3] == \
        jbase.run_base_framework_demo(3, 2)
    assert base_framework.run_base_framework_demo(4, 3) == \
        jbase.run_base_framework_demo(4, 3)


@pytest.mark.parametrize("argv,key", [
    (["--algo", "split_nn", "--model", "lr", "--dataset", "femnist",
      "--client_num_in_total", "6", "--client_num_per_round", "2",
      "--batch_size", "10"], "loss"),
    (["--algo", "vfl", "--batch_size", "32", "--lr", "0.1"], "test_acc"),
    (["--algo", "fedgkt", "--dataset", "cifar10", "--client_num_in_total",
      "2", "--client_num_per_round", "1", "--batch_size", "8"], "acc")])
def test_runners_on_the_cpu(argv, key):
    out = main(argv + ["--comm_round", "2", "--platform", "cpu",
                       "--log_stdout", "false"])
    assert np.isfinite(out[key])
