"""Norm-difference clipping and weak-DP noise on one client's tree.

Port of ``fedml_tpu/core/robust.py`` — the unfused ("torch") defense
backend, twin of the JAX package's "xla" backend.  Its noise comes from a
``torch.Generator``, so against the JAX package only its distribution can
be compared; the fused backend (``core/fused_agg.py``) reproduces the JAX
fused kernel's noise stream instead."""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.pytree import Tree, tree_keys, tree_sub


def default_is_weight_param(path: str) -> bool:
    """Exclude normalisation running statistics from the norm and from
    clipping: flax's ``batch_stats`` collection and torch-style names."""
    return not any(s in path for s in
                   ("batch_stats", "running_mean", "running_var",
                    "num_batches_tracked"))


def _masked_global_norm(tree: Tree, is_weight,
                        batch_dims: int = 0) -> torch.Tensor:
    """L2 norm over the leaves whose path ``is_weight`` selects.  With
    ``batch_dims=1`` the leaves carry a leading client axis and the result
    is one norm per client."""
    total = 0.0
    for k in tree_keys(tree):
        if is_weight(k):
            sq = torch.square(tree[k].to(torch.float32))
            total = total + sq.reshape(sq.shape[:batch_dims] + (-1,)).sum(-1)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_update(client_params: Tree, global_params: Tree, norm_bound: float,
                is_weight=default_is_weight_param) -> Tree:
    """client' = global + (client - global) * min(1, bound / ||diff||) on
    weight leaves; other leaves pass through unclipped."""
    diff = tree_sub(client_params, global_params)
    norm = _masked_global_norm(diff, is_weight)
    scale = torch.clamp(norm_bound / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (global_params[k] + diff[k] * scale.to(diff[k].dtype)
                if is_weight(k) else client_params[k])
            for k in tree_keys(client_params)}


def add_gaussian_noise(params: Tree, generator: torch.Generator,
                       stddev: float) -> Tree:
    """Weak-DP Gaussian noise on float leaves; integer leaves pass
    through."""
    out = {}
    for k in tree_keys(params):
        x = params[k]
        if x.dtype.is_floating_point:
            x = x + stddev * torch.randn(x.shape, generator=generator,
                                         device=x.device, dtype=x.dtype)
        out[k] = x
    return out
