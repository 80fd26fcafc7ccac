"""Decentralized (serverless) FL: gossip over a topology (port of
``fedml_tpu/algorithms/decentralized.py``).

Node states live stacked on a leading ``nodes`` axis.  One gossip round
trains every node on its own data (``torch.func.vmap`` over the nodes, as
the cohort engine trains a cohort, each node keyed by ``fold_in(round
key, node)``) and mixes the trained states with the topology's
row-stochastic W:

* dense (`mix_stacked`): ``W @ [N, D]`` per leaf, one matmul on the
  device;
* on a mesh (`ring_mix_sharded`), one node a rank: the two ring shifts of
  the rank's ``clients`` axis (`parallel.mesh.Mesh.ring_shift`, each one
  ``batch_isend_irecv`` over every leaf) in place of JAX's two
  ``ppermute`` s.  Only ring topologies take this path (`_ring_weights`).

Node 0's model is evaluated over every node's train split every
``frequency_of_the_test`` rounds and on the last one."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree, tree_keys, tree_map
from fedml_tpu_torch.core.topology import SymmetricTopologyManager
from fedml_tpu_torch.data.stacking import FederatedData, to_device
from fedml_tpu_torch.device import resolve_device, synchronize
from fedml_tpu_torch.parallel.cohort import client_keys, cohort_eval
from fedml_tpu_torch.trainer.local_sgd import (make_evaluator,
                                              make_local_trainer)
from fedml_tpu_torch.trainer.workload import Workload, make_client_optimizer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DecentralizedConfig:
    comm_round: int = 10
    epochs: int = 1
    batch_size: int = 10
    lr: float = 0.03
    client_optimizer: str = "sgd"
    wd: float = 0.0
    neighbor_num: int = 2
    frequency_of_the_test: int = 5
    seed: int = 0


def mix_stacked(stacked: Tree, W: torch.Tensor) -> Tree:
    """One gossip mixing step: the row-stochastic W applied along the node
    axis, a ``[N, N] @ [N, D]`` matmul per leaf in f32."""
    def _mix(x):
        flat = x.reshape(x.shape[0], -1)
        mixed = W.to(flat.device, torch.float32) @ flat.to(torch.float32)
        return mixed.reshape(x.shape).to(x.dtype)
    return tree_map(_mix, stacked)


def ring_mix_sharded(local: Tree, axis, w_self: float, w_left: float,
                     w_right: float) -> Tree:
    """Ring gossip over a mesh axis (``axis``: a `parallel.mesh.MeshAxis`,
    one node a rank): every leaf from the previous rank and from the next,
    one ``batch_isend_irecv`` each way, then ``w_self·x + w_left·left +
    w_right·right``."""
    keys = tree_keys(local)
    leaves = [local[k] for k in keys]
    from_left = axis.mesh.ring_shift(leaves, axis.name)
    from_right = axis.mesh.ring_shift(leaves, axis.name, reverse=True)
    return {k: w_self * x + w_left * a + w_right * b
            for k, x, a, b in zip(keys, leaves, from_left, from_right)}


def _ring_weights(W: np.ndarray):
    """Check that W is a circulant ring mixing matrix (nonzero only on the
    diagonal and the two ring neighbours, the same across rows) and return
    (w_self, w_left, w_right).  The mesh path takes exactly this
    structure; other topologies need the dense path."""
    n = W.shape[0]
    if n == 1:
        if not np.allclose(W, 1.0, atol=1e-6):
            raise ValueError("1-node gossip requires W == [[1.0]]")
        return 1.0, 0.0, 0.0
    if n == 2:
        # both ring directions reach the one neighbour, so its weight is
        # split between the two shifts (their sum is what mixes)
        expect = np.array([[W[0, 0], W[0, 1]], [W[0, 1], W[0, 0]]])
        if not np.allclose(W, expect, atol=1e-6):
            raise ValueError("2-node gossip requires a symmetric circulant W")
        return float(W[0, 0]), float(W[0, 1]) / 2, float(W[0, 1]) / 2
    ring = np.zeros_like(W)
    for i in range(n):
        ring[i, i] = W[0, 0]
        ring[i, (i - 1) % n] = W[0, n - 1]
        ring[i, (i + 1) % n] = W[0, 1]
    if not np.allclose(W, ring, atol=1e-6):
        raise ValueError(
            "mesh gossip supports ring topologies only (nonzeros on the "
            "diagonal and adjacent ring neighbors); use the dense path "
            "(mesh=None) for general mixing matrices")
    return float(W[0, 0]), float(W[0, n - 1]), float(W[0, 1])


class DecentralizedGossip:
    """Every node trains each round, then the topology mixes the states.
    ``mesh``: one node a rank of its ``clients`` axis, ring topologies
    only.  ``device``: None for the card (raises without one), "cpu" for
    the CPU; on a mesh, the rank's device."""

    def __init__(self, workload: Workload, data: FederatedData,
                 config: DecentralizedConfig, mesh=None,
                 topology: Optional[np.ndarray] = None, device=None):
        self.workload = workload
        self.data = data
        self.cfg = config
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        n = data.client_num
        if topology is None:
            mgr = SymmetricTopologyManager(n, config.neighbor_num)
            topology = mgr.generate_topology()
        self.W = torch.as_tensor(np.asarray(topology, np.float32)).to(
            self.device)

        opt = make_client_optimizer(config.client_optimizer, config.lr,
                                    config.wd)
        self._local_train = make_local_trainer(workload, opt, config.epochs)
        self.evaluate = make_evaluator(workload)
        self._eval_cohort = cohort_eval(self.evaluate, mesh=mesh)
        self.history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []
        if mesh is None:
            self._round = self._dense_round
        else:
            if n != mesh.shape["clients"]:
                raise ValueError("mesh gossip needs one node per device")
            self._ring = _ring_weights(np.asarray(topology))
            self._axis = mesh.axis("clients")
            self._round = self._ring_round

    def _train(self, stacked: Tree, batches: Dict[str, torch.Tensor],
               round_key: prng.Key, offset: int) -> Tree:
        """Train the nodes ``offset ..`` of a stack, vmapped."""
        train = self._local_train
        extra = ()
        if train.rng_inputs is not None:
            n = batches["mask"].shape[0]
            keys = client_keys(round_key, n, offset, self.device)
            extra = (train.rng_inputs(keys, batches["mask"].shape[1]),)
        trained, _ = vmap(train, in_dims=(0, 0) + (0,) * len(extra))(
            stacked, batches, *extra)
        return trained

    def _dense_round(self, stacked: Tree, data: Dict[str, torch.Tensor],
                     round_key: prng.Key) -> Tree:
        batches = {k: v for k, v in data.items() if k != "num_samples"}
        return mix_stacked(self._train(stacked, batches, round_key, 0),
                           self.W)

    def _ring_round(self, stacked: Tree, data: Dict[str, torch.Tensor],
                    round_key: prng.Key) -> Tree:
        """This rank's node: train it, mix it over the ring, then gather
        every rank's node back into the stack."""
        i = self._axis.index
        local = {k: v[i:i + 1].to(self.device) for k, v in stacked.items()}
        batches = {k: v[i:i + 1].to(self.device) for k, v in data.items()
                   if k != "num_samples"}
        trained = self._train(local, batches, round_key, i)
        mixed = ring_mix_sharded(trained, self._axis, *self._ring)
        return self.mesh.all_gather_rows(mixed)

    def init_params(self) -> Tree:
        """Fresh weights from ``cfg.seed``, drawn on the CPU."""
        return self.workload.init(
            torch.Generator().manual_seed(self.cfg.seed), self.device)

    def run(self, stacked_params: Optional[Tree] = None, rng=None,
            on_round: Optional[Callable[[int, Tree], None]] = None) -> Tree:
        """``stacked_params``: ``[N, ...]`` node states (None: every node
        starts from `init_params`).  ``rng``: the run's key (default
        ``key(seed)``); one ``split`` for the init when the run draws its
        weights, then one a round.  ``on_round(r, stacked)`` after each
        round's mix."""
        cfg = self.cfg
        rng = rng if rng is not None else prng.key(cfg.seed)
        train = to_device(self.data.train, self.device)
        n = self.data.client_num
        if stacked_params is None:
            rng, _ = prng.split(rng)
            p0 = self.init_params()
            stacked_params = {k: v.expand((n,) + tuple(v.shape)).clone()
                              for k, v in p0.items()}
        stacked_params = {k: v.to(self.device)
                          for k, v in stacked_params.items()}
        for r in range(cfg.comm_round):
            t0 = time.perf_counter()
            rng, rr = prng.split(rng)
            stacked_params = self._round(stacked_params, train, rr)
            synchronize(self.device)
            self.round_times.append(time.perf_counter() - t0)
            if on_round is not None:
                on_round(r, stacked_params)
            if r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1:
                # node 0's model quality over every node's data
                p0 = {k: v[0] for k, v in stacked_params.items()}
                m = self._eval_cohort(p0, train)
                acc = float(m["correct"]) / max(float(m["total"]), 1.0)
                self.history.append({"round": r, "train_acc": acc})
                logger.info("gossip round %d acc %.4f", r, acc)
        return stacked_params
