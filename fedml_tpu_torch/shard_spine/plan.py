"""Deterministic leaf→shard layout for the sharded global-model spine.

Port of ``fedml_tpu/shard_spine/plan.py``.  Given only the template's leaf
shapes, the shard count ``S`` and the split threshold, the plan derives
which piece of the model each shard owns:

* a leaf with a dimension divisible by ``S`` (and at least
  ``min_split_elems`` elements) is **split** along the first such
  dimension: shard ``s`` owns the ``s``-th contiguous block;
* a small (or indivisible) leaf is **replicated** for placement but owned
  by exactly ONE shard for the wire and the fold (greedy lightest shard
  first, ties to the lowest id), so no leaf is folded twice.

The plan's ``spec()`` rides the sync frame and its ``fingerprint()`` (a
crc32 of the descriptor) identifies the layout, so both are part of the
wire: they are byte-equal to the JAX package's for the same template.
The template here is the port's flat dict; its leaf order (`tree_keys`)
is JAX's, its paths are JAX's ``/``-joined dict keys, and the codec
``structure`` in the spec is that of the nested (JAX) layout.

Wire form of one shard's slice::

    {"s<idx>": {"00007": <piece of leaf 7>, ...}}

Slice keys are zero-padded, so their string order is leaf order.  Pieces
may be numpy arrays (the wire) or tensors (the server's fold state):
split and join work on both.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.comm.message import _flatten_arrays, _unflatten_arrays
from fedml_tpu_torch.core.pytree import nest, tree_keys
from fedml_tpu_torch.core.robust import default_is_weight_param

# wire slice keys: zero-padded so string sort order == leaf order
_LEAF_KEY_DIGITS = 5


def _leaf_key(i: int) -> str:
    return f"{i:0{_LEAF_KEY_DIGITS}d}"


def _shard_key(s: int) -> str:
    return f"s{s}"


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf's layout: ``mode`` is ``"split"`` (shard ``s`` owns the
    ``s``-th block of ``dim``) or ``"rep"`` (whole leaf owned by
    ``owner``, replicated for placement)."""
    index: int
    path: str
    shape: tuple
    dtype: str
    is_weight: bool          # counts toward the clip norm (core/robust.py)
    mode: str                # "split" | "rep"
    dim: int = -1            # split dimension (mode == "split")
    owner: int = 0           # owning shard (mode == "rep")

    def to_json(self) -> dict:
        return {"i": self.index, "path": self.path,
                "shape": list(self.shape), "dtype": self.dtype,
                "w": int(self.is_weight), "mode": self.mode,
                "dim": self.dim, "owner": self.owner}

    @classmethod
    def from_json(cls, d: dict) -> "LeafPlan":
        return cls(index=int(d["i"]), path=str(d["path"]),
                   shape=tuple(int(x) for x in d["shape"]),
                   dtype=str(d["dtype"]), is_weight=bool(d["w"]),
                   mode=str(d["mode"]), dim=int(d["dim"]),
                   owner=int(d["owner"]))


class ShardPlan:
    """The derived layout.  Build with `build_shard_plan` (server side,
    from the live template) or `ShardPlan.from_spec` (silo side, from the
    sync frame's descriptor)."""

    def __init__(self, num_shards: int, leaves: Sequence[LeafPlan],
                 min_split_elems: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.leaves: List[LeafPlan] = list(leaves)
        self.min_split_elems = int(min_split_elems)
        self._structure: Optional[dict] = None
        # shard -> ordered leaf indices it carries a piece of
        self.members: List[List[int]] = [[] for _ in range(num_shards)]
        for lp in self.leaves:
            if lp.mode == "split":
                for s in range(num_shards):
                    self.members[s].append(lp.index)
            else:
                self.members[lp.owner].append(lp.index)

    # -- identity ------------------------------------------------------------
    def descriptor(self) -> dict:
        return {"num_shards": self.num_shards,
                "min_split_elems": self.min_split_elems,
                "leaves": [lp.to_json() for lp in self.leaves]}

    def fingerprint(self) -> int:
        """crc32 of the canonical descriptor."""
        blob = json.dumps(self.descriptor(), sort_keys=True).encode()
        return zlib.crc32(blob)

    def spec(self) -> dict:
        """What shard 0's sync frame ships, so a silo can split/join with
        zero configuration: the descriptor plus the codec ``structure``."""
        return dict(self.descriptor(), structure=self._structure)

    @classmethod
    def from_spec(cls, spec: dict) -> "ShardPlan":
        plan = cls(int(spec["num_shards"]),
                   [LeafPlan.from_json(d) for d in spec["leaves"]],
                   int(spec["min_split_elems"]))
        plan._structure = spec.get("structure")
        return plan

    # -- leaf-list split / join ----------------------------------------------
    def _piece(self, lp: LeafPlan, arr, shard: int):
        if lp.mode != "split":
            return arr
        n = arr.shape[lp.dim] // self.num_shards
        idx = [slice(None)] * arr.dim() if isinstance(arr, torch.Tensor) \
            else [slice(None)] * arr.ndim
        idx[lp.dim] = slice(shard * n, (shard + 1) * n)
        return arr[tuple(idx)]

    def piece_shape(self, lp: LeafPlan) -> tuple:
        if lp.mode != "split":
            return lp.shape
        shape = list(lp.shape)
        shape[lp.dim] //= self.num_shards
        return tuple(shape)

    def split_leaves(self, leaves: Sequence) -> List[Dict[str, dict]]:
        """Ordered leaf list (arrays or tensors) → one wire slice dict per
        shard.  Split pieces are views of the input leaves."""
        if len(leaves) != len(self.leaves):
            raise ValueError(
                f"shard plan covers {len(self.leaves)} leaves but the "
                f"tree has {len(leaves)} — the model does not match the "
                f"plan's template")
        out: List[Dict[str, dict]] = [
            {_shard_key(s): {}} for s in range(self.num_shards)]
        for lp, leaf in zip(self.leaves, leaves):
            arr = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            if tuple(arr.shape) != lp.shape:
                raise ValueError(
                    f"leaf {lp.index} ({lp.path}) has shape "
                    f"{tuple(arr.shape)} but the plan expects {lp.shape}")
            if lp.mode == "split":
                for s in range(self.num_shards):
                    out[s][_shard_key(s)][_leaf_key(lp.index)] = \
                        self._piece(lp, arr, s)
            else:
                out[lp.owner][_shard_key(lp.owner)][
                    _leaf_key(lp.index)] = arr
        return out

    def join_slices(self, slices: Sequence[Dict[str, dict]]) -> List:
        """One wire slice per shard → the ordered full leaf list
        (concatenation along the split dim; exact)."""
        if len(slices) != self.num_shards:
            raise ValueError(f"join_slices needs {self.num_shards} "
                             f"slices, got {len(slices)}")
        inner = []
        for s, sl in enumerate(slices):
            body = sl.get(_shard_key(s))
            if body is None:
                raise ValueError(
                    f"slice {s} does not carry the '{_shard_key(s)}' "
                    f"shard key (wrong-shard or malformed slice)")
            inner.append(body)
        leaves: List = []
        for lp in self.leaves:
            key = _leaf_key(lp.index)
            if lp.mode == "split":
                pieces = [inner[s][key] for s in range(self.num_shards)]
                if self.num_shards == 1:
                    leaves.append(pieces[0])
                elif isinstance(pieces[0], torch.Tensor):
                    leaves.append(torch.cat(pieces, dim=lp.dim))
                else:
                    leaves.append(np.concatenate(
                        [np.asarray(p) for p in pieces], axis=lp.dim))
            else:
                leaves.append(inner[lp.owner][key])
        return leaves

    def slice_weight_flags(self, shard: int) -> tuple:
        """Per-piece is_weight flags in the shard slice's KEY ORDER."""
        by_index = {lp.index: lp for lp in self.leaves}
        return tuple(by_index[i].is_weight
                     for i in sorted(self.members[shard]))

    def slice_numel(self, shard: int, floats_only: bool = True) -> int:
        """Elements of one shard's slice (its float pieces by default):
        the length of the buffer its fused finalize runs over."""
        by_index = {lp.index: lp for lp in self.leaves}
        return sum(int(np.prod(self.piece_shape(by_index[i]) or (1,)))
                   for i in self.members[shard]
                   if not floats_only
                   or np.dtype(by_index[i].dtype).kind == "f")


def build_shard_plan(template, num_shards: int,
                     min_split_elems: int = 1024) -> ShardPlan:
    """Derive the plan from a flat template dict (tensors or arrays).
    Deterministic in (leaf shapes/dtypes, ``num_shards``,
    ``min_split_elems``) only."""
    keys = tree_keys(template)
    leaves: List[LeafPlan] = []
    rep_bytes = [0] * num_shards
    for i, k in enumerate(keys):
        leaf = template[k]
        shape = tuple(int(d) for d in leaf.shape)
        dtype = _np_dtype(leaf)
        size = int(np.prod(shape, dtype=np.int64))
        nbytes = size * dtype.itemsize
        is_w = bool(default_is_weight_param(k))
        dim = -1
        if num_shards > 1 and size >= min_split_elems:
            for d, n in enumerate(shape):
                if n >= num_shards and n % num_shards == 0:
                    dim = d
                    break
        if dim >= 0:
            leaves.append(LeafPlan(i, k, shape, dtype.str, is_w, "split",
                                   dim=dim))
        else:
            owner = int(np.argmin(rep_bytes))
            rep_bytes[owner] += nbytes
            leaves.append(LeafPlan(i, k, shape, dtype.str, is_w, "rep",
                                   owner=owner))
    plan = ShardPlan(num_shards, leaves, min_split_elems)
    # the client-facing structure: the wire codec's spec of the NESTED
    # template, so a silo rebuilds the JAX-layout params tree from slices
    _, plan._structure = _flatten_arrays(
        nest({k: np.zeros(0, np.float32) for k in keys}))
    return plan


class SiloShardCodec:
    """Silo-side split/join built purely from the sync frame's plan
    spec: ``join(slices) -> params tree`` (the nested wire layout) for
    training, ``split(tree) -> slices`` for the upload."""

    def __init__(self, spec: dict):
        self.plan = ShardPlan.from_spec(spec)
        self._structure = spec.get("structure")
        if self._structure is None:
            raise ValueError("shard spec carries no structure; the silo "
                             "cannot rebuild the params tree from slices")
        self.fingerprint = self.plan.fingerprint()

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    def join(self, slices: Sequence[dict]):
        return _unflatten_arrays(self._structure,
                                 self.plan.join_slices(slices))

    def split(self, tree) -> List[dict]:
        leaves, _ = _flatten_arrays(tree)
        if leaves is None:
            raise ValueError("cannot split a tree with no array leaves")
        return self.plan.split_leaves(leaves)
