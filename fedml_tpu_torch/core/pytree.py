"""Parameter-tree math over flat dicts of tensors.

Port of ``fedml_tpu/core/pytree.py``.  A tree is a ``dict`` mapping the
flax path (``"Dense_0/kernel"``) to a tensor; ``tree_keys`` gives JAX's
leaf order (dict keys sorted at every level), which the fused aggregate's
per-leaf noise seeds depend on."""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def tree_keys(tree) -> List[str]:
    """Keys in JAX's flatten order: sorted path component by component."""
    return sorted(tree, key=lambda k: k.split("/"))


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in tree_keys(tree)}


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    """a - b, elementwise."""
    return tree_map(torch.sub, a, b)


def tree_cast(tree: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm of the concatenation of all leaves (each squared and
    summed in f32, the leaves' sums added in leaf order), without
    materialising the flat vector."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].to(torch.float32)))
                          for k in tree_keys(tree)))


def tree_vector_norm(a: Tree, b: Tree) -> torch.Tensor:
    """|| a - b ||_2 over all leaves (the norm of an update)."""
    return tree_global_norm(tree_sub(a, b))


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


def tree_weighted_psum_mean(local_tree: Tree, local_weight: torch.Tensor,
                            axis) -> Tree:
    """The weighted mean over a mesh axis (``axis``: a
    `parallel.mesh.MeshAxis`): each rank holds one client's (or a block's
    partial) tree and weight; the weights' sum and then the weighted
    leaves' sum are taken over the axis, normalised in f32 as the JAX
    package's two ``psum`` s."""
    w = torch.as_tensor(local_weight).to(torch.float32)
    total = axis.mesh.allsum(w.reshape(()), axis.name)
    ratio = w / total
    return axis.mesh.allsum(
        tree_map(lambda x: x * ratio.to(x.device, x.dtype), local_tree),
        axis.name)


# ---------------------------------------------------------------------------
# the wire layout: the JAX package's nested dicts of numpy arrays
# ---------------------------------------------------------------------------

def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"Dense_0/kernel": x}`` -> ``{"Dense_0": {"kernel": x}}``, the
    nested layout the JAX package (and so the wire) keeps; leaves are
    passed through."""
    out: Dict[str, Any] = {}
    for k in tree_keys(flat):
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[k]
    return out


def flatten_nested(tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, Any]:
    """The inverse of `nest`: nested dicts -> a flat dict keyed by the
    ``/``-joined path, in JAX's leaf order."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_nested(v, path))
        else:
            flat[path] = v
    return {k: flat[k] for k in tree_keys(flat)}


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device) -> torch.Tensor:
    """A tensor, or a host array (possibly a read-only view into a wire
    frame), as a tensor on ``device``.  A host array is wrapped without a
    copy on the way there; the callers only read it."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only buffer
        return torch.as_tensor(np.asarray(x)).to(device)


def to_host(tree):
    """Every leaf of a nested dict/list/tuple tree as a host numpy array
    (one device-to-host copy per tensor leaf)."""
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return host_array(tree)


class HostMirror:
    """Identity-keyed memo of a flat params dict's host copy in the wire
    layout (nested numpy).

    The server actor reads the global's host form several times per
    round (broadcast payload, admission reference, staging refill); this
    keeps ONE device-to-host transfer per distinct params value — the
    mirror invalidates when the params OBJECT is replaced, which is how
    every aggregation produces a new global.  Do not mutate a mirrored
    tree's leaves in place."""

    __slots__ = ("_key", "_host")

    def __init__(self):
        self._key = self._host = None

    def get(self, params: Tree) -> Dict[str, Any]:
        if self._host is None or self._key is not params:
            self._key = params
            self._host = to_host(nest(params))
        return self._host
