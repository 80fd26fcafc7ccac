"""Carry parameters across the JAX package and the port.

The port stores parameters in flax's layout (conv kernels HWIO, dense
kernels ``[in, out]``, attention kernels ``[d_model, H, d_head]`` and
``[H, d_head, d_model]``) under flax's paths, so the carry is a renaming:
``{"Dense_0": {"kernel": a}}`` <-> ``{"Dense_0/kernel": tensor(a)}``.  A
stateful (BatchNorm) workload's variables carry both collections the
same way: ``{"params": ..., "batch_stats": ...}`` <-> ``params/...`` and
``batch_stats/...``.  `parallel.pipeline.PipelineLM`'s tree carries the
same way: ``{"embed", "blocks", "final"}`` <-> ``embed/...``,
``blocks/...`` (each leaf with its stacked ``[L, ...]`` layer axis) and
``final/...``.
Inputs and outputs on the JAX side are nested dicts of numpy arrays (pass
``jax.tree.map(np.asarray, params)``); this module imports no JAX."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fedml_tpu_torch.core.pytree import Tree, flatten_nested, nest, to_host


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> Tree:
    """Nested dict of arrays -> the port's flat dict, in JAX's leaf
    order."""
    return {k: torch.as_tensor(np.array(v)).to(device)
            for k, v in flatten_nested(tree).items()}


def params_to_numpy(params: Tree) -> Dict[str, Any]:
    """The port's flat dict -> nested dict of numpy arrays."""
    return to_host(nest(params))
