"""Graph topologies for decentralized FL (the port's own numpy copy of
``fedml_tpu/core/topology.py``).

``SymmetricTopologyManager`` and ``AsymmetricTopologyManager`` build the
row-stochastic mixing matrix W of a ring lattice (``watts_strogatz_graph(n,
k, 0)``: each node linked to its k//2 nearest neighbours on each side),
the asymmetric one with random directed links added.  The matrices are
bit-equal to the JAX package's for the same arguments; the asymmetric
manager draws from ``np.random.RandomState(seed)``, or from the global
``np.random`` when ``seed`` is None, as the JAX package does.

A gossip round does not iterate neighbours: W drives a dense ``W @
stacked_params`` (`algorithms.decentralized.mix_stacked`) or the two ring
shifts over a mesh axis (`algorithms.decentralized.ring_mix_sharded`).
"""

from __future__ import annotations

import abc

import numpy as np


def ring_lattice_adjacency(n: int, k: int) -> np.ndarray:
    """Adjacency of watts_strogatz_graph(n, k, p=0): each node connected to
    the k//2 nearest neighbours on each side (k odd rounds down)."""
    adj = np.zeros((n, n), dtype=np.float32)
    half = k // 2
    for offset in range(1, half + 1):
        for i in range(n):
            j = (i + offset) % n
            adj[i, j] = 1.0
            adj[j, i] = 1.0
    return adj


class BaseTopologyManager(abc.ABC):
    """The topology managers' interface."""

    @abc.abstractmethod
    def generate_topology(self): ...

    @abc.abstractmethod
    def get_in_neighbor_idx_list(self, node_index): ...

    @abc.abstractmethod
    def get_out_neighbor_idx_list(self, node_index): ...

    @abc.abstractmethod
    def get_in_neighbor_weights(self, node_index): ...

    @abc.abstractmethod
    def get_out_neighbor_weights(self, node_index): ...


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring + extra symmetric links, each row normalised by its degree."""

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self):
        ring = ring_lattice_adjacency(self.n, 2)
        extra = ring_lattice_adjacency(self.n, int(self.neighbor_num))
        adj = np.maximum(ring, extra)
        np.fill_diagonal(adj, 1.0)
        row_degree = adj.sum(axis=1, keepdims=True)
        self.topology = adj / row_degree
        return self.topology

    def get_in_neighbor_weights(self, node_index):
        if node_index >= self.n:
            return []
        return self.topology[node_index]

    def get_out_neighbor_weights(self, node_index):
        if node_index >= self.n:
            return []
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index):
        w = self.get_in_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index):
        w = self.get_out_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]


class AsymmetricTopologyManager(BaseTopologyManager):
    """Symmetric base graph plus randomly added directed links, each row
    normalised.  Rows mix in-neighbours; columns give out-edges."""

    def __init__(self, n: int, undirected_neighbor_num: int = 3,
                 out_directed_neighbor: int = 3, seed: int | None = None):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self._rng = (np.random.RandomState(seed) if seed is not None
                     else np.random)
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self):
        adj = np.maximum(ring_lattice_adjacency(self.n, 2),
                         ring_lattice_adjacency(self.n,
                                                self.undirected_neighbor_num))
        np.fill_diagonal(adj, 1.0)
        # promote zero entries to directed links by a coin per entry, at
        # most one direction of each (i, j) pair
        out_link_set = set()
        for i in range(self.n):
            zeros = [j for j in range(self.n) if adj[i, j] == 0]
            coin = self._rng.randint(2, size=len(zeros))
            for flip, j in zip(coin, zeros):
                if flip == 1 and (j * self.n + i) not in out_link_set:
                    adj[i, j] = 1.0
                    out_link_set.add(i * self.n + j)
        row_degree = adj.sum(axis=1, keepdims=True)
        self.topology = adj / row_degree
        return self.topology

    def get_in_neighbor_weights(self, node_index):
        """In-edges of node i: column i of the row-stochastic matrix."""
        if node_index >= self.n:
            return []
        return [self.topology[row_idx][node_index]
                for row_idx in range(self.n)]

    def get_out_neighbor_weights(self, node_index):
        """Out-edges of node i: row i."""
        if node_index >= self.n:
            return []
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index):
        w = self.get_in_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index):
        w = self.get_out_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]


def ring_topology(n: int) -> SymmetricTopologyManager:
    """A plain ring (each node, 2 neighbours), generated."""
    mgr = SymmetricTopologyManager(n, 2)
    mgr.generate_topology()
    return mgr
