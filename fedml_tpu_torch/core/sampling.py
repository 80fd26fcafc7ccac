"""Per-round client sampling with the reference's seeded determinism.

Port of ``fedml_tpu/core/sampling.py``.  ``sample_clients`` is numpy
``RandomState(round_idx)``, so the cohort of every round is bit-identical
to the JAX package's.  ``sample_clients_jax`` is the JAX package's
threefry permutation sampler, on the port's numpy threefry
(`core.prng.permutation`), bit-identical to ``jax.random.permutation``.
The two give different cohorts for the same (round, N, m); a run that
picks between them records which one it used."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core import prng


def sample_clients(round_idx: int, client_num_in_total: int,
                   client_num_per_round: int) -> np.ndarray:
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    num_clients = min(client_num_per_round, client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(range(client_num_in_total), num_clients, replace=False)


def sample_clients_jax(key: prng.Key, client_num_in_total: int,
                       client_num_per_round: int) -> np.ndarray:
    """The first ``min(m, N)`` entries of ``jax.random.permutation(key,
    N)``."""
    num = min(client_num_per_round, client_num_in_total)
    return prng.permutation(key, client_num_in_total)[:num].astype(np.int64)
