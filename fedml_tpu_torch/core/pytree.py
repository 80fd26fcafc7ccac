"""Parameter-tree math over flat dicts of tensors.

Port of ``fedml_tpu/core/pytree.py``.  A tree is a ``dict`` mapping the
flax path (``"Dense_0/kernel"``) to a tensor; ``tree_keys`` gives JAX's
leaf order (dict keys sorted at every level), which the fused aggregate's
per-leaf noise seeds depend on."""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch

Tree = Dict[str, torch.Tensor]


def tree_keys(tree) -> List[str]:
    """Keys in JAX's flatten order: sorted path component by component."""
    return sorted(tree, key=lambda k: k.split("/"))


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in tree_keys(tree)}


def tree_sub(a: Tree, b: Tree) -> Tree:
    """a - b, elementwise."""
    return tree_map(torch.sub, a, b)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The weighted-mean accumulator dtype: float leaves accumulate in
    their own dtype, ints in f32 (exact for step counters)."""
    return dtype if dtype.is_floating_point else torch.float32


def tree_stack(trees: Sequence[Tree]) -> Tree:
    return {k: torch.stack([t[k] for t in trees]) for k in tree_keys(trees[0])}


def tree_weighted_mean(trees: Union[Sequence[Tree], Tree],
                       weights: torch.Tensor) -> Tree:
    """Sample-weighted average of client trees: ``sum_i (n_i / sum_j n_j)
    * w_i`` per leaf, normalised in f32.  Accepts a list of trees or one
    stacked tree whose leaves carry a leading ``[num_clients]`` axis.
    Int leaves accumulate in f32 and are cast back, which truncates."""
    stacked = tree_stack(trees) if isinstance(trees, (list, tuple)) else trees
    w = torch.as_tensor(weights, dtype=torch.float32)
    norm = w / w.sum()

    def _avg(x):
        acc = acc_dtype(x.dtype)
        r = norm.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.to(acc) * r.to(acc)).sum(0).to(x.dtype)

    return tree_map(_avg, stacked)
