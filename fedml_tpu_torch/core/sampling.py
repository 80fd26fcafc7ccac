"""Per-round client sampling with the reference's seeded determinism.

Port of ``fedml_tpu/core/sampling.py::sample_clients``: numpy
``RandomState(round_idx)``, so the cohort of every round is bit-identical
to the JAX package's."""

from __future__ import annotations

import numpy as np


def sample_clients(round_idx: int, client_num_in_total: int,
                   client_num_per_round: int) -> np.ndarray:
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    num_clients = min(client_num_per_round, client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(range(client_num_in_total), num_clients, replace=False)
