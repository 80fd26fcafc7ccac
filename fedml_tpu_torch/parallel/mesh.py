"""Device layout of the sharded spine (port of
``fedml_tpu/parallel/mesh.py::make_model_mesh``).

JAX lays the spine's shards on a ``[1, S]`` mesh; here the "mesh" is the
list of devices the shards live on, one per shard."""

from __future__ import annotations

from typing import List, Optional

import torch


def make_model_mesh(num_shards: int) -> Optional[List[torch.device]]:
    """One visible CUDA device per shard, or None when fewer than
    ``num_shards`` exist — the spine then keeps every shard on its default
    device (same math, no per-device memory split), as the JAX package
    does on a one-device host."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if torch.cuda.device_count() < num_shards:
        return None
    return [torch.device("cuda", i) for i in range(num_shards)]
