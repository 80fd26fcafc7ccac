"""Update compression for the cross-silo wire.

The port of ``fedml_tpu/comm/compress.py`` (:1-214), numpy throughout as
there: compression is a wire-boundary op on host trees and never bounces
the model through the card.  Two lossy schemes over the UPDATE (the delta
to the global):

* ``topk`` — keep the k largest-|x| entries per leaf (``np.argpartition``,
  so ties break as the JAX package breaks them): int32 indices + values.
* ``int8`` — per-leaf symmetric quantization with an f32 scale.

``ErrorFeedback`` keeps the compressor's residual silo-side and settles it
once the next sync says whether the upload was aggregated.

Trees are the wire's nested dicts (and lists/tuples) of numpy arrays.  The
payload carries a structural token, ``str(jax treedef)`` in the JAX
package; the port has no JAX, so `treedef_token` renders the same string
(``PyTreeDef({'Conv_0': {'bias': *, 'kernel': *}, ...})``) from the tree
itself, with dict keys in sorted order — a frame from either package
decompresses in the other.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

Pytree = Any

SCHEMES = ("none", "topk", "int8")


# -- the JAX pytree protocol over the wire's containers ----------------------

def tree_leaves(tree) -> List[Any]:
    """Leaves in JAX's flatten order: dict keys sorted, lists and tuples
    in order, ``None`` an empty node."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(tree_leaves(v))
        return out
    return [tree]


def _render(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_render(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_render(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_render(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def treedef_token(tree) -> str:
    """``str(jax.tree.structure(tree))`` without JAX: the structural
    fingerprint the compressed payload carries, so a mismatched
    decompress fails loudly instead of mis-zipping leaves."""
    return f"PyTreeDef({_render(tree)})"


def tree_unflatten(like, leaves: List[Any]):
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        return next(it)

    return walk(like)


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over the wire's containers (dict keys sorted)."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


# -- the codec ---------------------------------------------------------------

def compress_update(tree: Pytree, scheme: str, topk_frac: float = 0.1):
    """tree -> wire-able payload (still a tree of arrays, so it rides the
    binary message codec unchanged)."""
    if scheme == "none":
        return {"scheme": "none", "tree": tree}
    leaves = tree_leaves(tree)
    if scheme == "topk":
        comp = []
        for x in leaves:
            x = np.asarray(x)
            if not np.issubdtype(x.dtype, np.floating) or x.size < 16:
                comp.append({"dense": x})
                continue
            _check_finite(x, scheme)
            flat = x.reshape(-1)
            k = max(1, int(round(topk_frac * flat.size)))
            idx = np.argpartition(np.abs(flat), -k)[-k:].astype(np.int32)
            comp.append({"idx": idx, "val": flat[idx],
                         "shape": np.asarray(x.shape, np.int64),
                         "dtype": str(x.dtype)})
        return {"scheme": "topk", "leaves": comp,
                "treedef": treedef_token(tree)}
    if scheme == "int8":
        comp = []
        for x in leaves:
            x = np.asarray(x)
            if not np.issubdtype(x.dtype, np.floating) or x.size < 16:
                comp.append({"dense": x})
                continue
            _check_finite(x, scheme)
            amax = float(np.max(np.abs(x)))
            scale = amax / 127.0 if amax > 0 else 1.0
            q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            comp.append({"q": q, "scale": np.float32(scale),
                         "dtype": str(x.dtype)})
        return {"scheme": "int8", "leaves": comp,
                "treedef": treedef_token(tree)}
    raise ValueError(f"unknown compression scheme {scheme!r}; "
                     f"available: {SCHEMES}")


def decompress_update(payload, like: Pytree) -> Pytree:
    """Inverse of compress_update; ``like`` supplies the tree structure
    (the server always knows the model skeleton)."""
    scheme = payload["scheme"]
    if scheme == "none":
        return payload["tree"]
    if payload["treedef"] != treedef_token(like):
        raise ValueError(
            "compressed payload tree structure does not match the "
            "receiver's model skeleton — sender/receiver model mismatch")
    out = []
    for d, _ in zip(payload["leaves"], tree_leaves(like)):
        if "dense" in d:
            out.append(np.asarray(d["dense"]))
        elif scheme == "topk":
            flat = np.zeros(int(np.prod(d["shape"])), dtype=d["dtype"])
            flat[np.asarray(d["idx"])] = np.asarray(d["val"])
            out.append(flat.reshape(tuple(int(s) for s in d["shape"])))
        else:  # int8
            out.append((np.asarray(d["q"], np.float32)
                        * float(d["scale"])).astype(d["dtype"]))
    return tree_unflatten(like, out)


def _check_finite(x, scheme: str) -> None:
    """Fail loudly on NaN/Inf updates: a non-finite amax quantizes the
    whole leaf to garbage, and argpartition over NaN picks arbitrary
    coordinates."""
    if not np.isfinite(x).all():
        raise ValueError(
            f"non-finite values in update leaf (shape {x.shape}); "
            f"refusing to {scheme}-compress a diverged update")


class ErrorFeedback:
    """Per-silo EF-SGD residual carry, ack-aware.

    ``record`` parks (delta, sent) until the next sync carries the
    server's accepted-silo list (``Message.ARG_ACCEPTED``) and ``resolve``
    settles it: accepted ⇒ carry ``delta − sent``; dropped ⇒ carry the
    full delta forward.
    """

    def __init__(self):
        self._residual: Dict[Any, Pytree] = {}
        self._pending: Dict[Any, tuple] = {}

    def apply(self, silo, delta: Pytree) -> Pytree:
        """Add the carried residual to this round's delta."""
        r = self._residual.get(silo)
        if r is None:
            return delta
        return tree_map(np.add, delta, r)

    def record(self, silo, delta: Pytree, sent: Pytree) -> None:
        """Park this round's (residual-augmented delta, decoded payload)
        until the server's ack arrives."""
        self._pending[silo] = (delta, sent)

    def resolve(self, silo, accepted) -> None:
        """Settle the parked residual once the next sync says whether the
        upload was aggregated; ``accepted=None`` (no ack field, the INIT
        sync) assumes accepted."""
        if silo not in self._pending:
            return
        delta, sent = self._pending.pop(silo)
        if accepted is None or int(silo) in np.asarray(accepted).astype(
                np.int64).tolist():
            self._residual[silo] = tree_map(np.subtract, delta, sent)
        else:
            self._residual[silo] = delta

    # -- checkpoint surface: the settled residual AND the parked entry ------
    def state_dict(self, silos, like: Pytree) -> Dict[str, Any]:
        """Fixed-shape host tree of the EF state for ``silos``; absent
        entries serialize as zeros and a 0 flag, so the structure doubles
        as the restore template."""
        zeros = tree_map(lambda v: np.zeros_like(np.asarray(v)), like)
        host = lambda t: tree_map(np.asarray, t)  # noqa: E731
        out = {}
        for silo in silos:
            r = self._residual.get(silo)
            pend = self._pending.get(silo)
            out[f"s{int(silo)}"] = {
                "residual": host(r) if r is not None else zeros,
                "has_residual": np.asarray(r is not None, np.int8),
                "pending_delta": host(pend[0]) if pend else zeros,
                "pending_sent": host(pend[1]) if pend else zeros,
                "has_pending": np.asarray(pend is not None, np.int8)}
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Inverse of ``state_dict`` (silo keys restore as ints)."""
        for key, d in state.items():
            silo = int(key[1:])
            if int(np.asarray(d["has_residual"])):
                self._residual[silo] = d["residual"]
            if int(np.asarray(d["has_pending"])):
                self._pending[silo] = (d["pending_delta"],
                                       d["pending_sent"])


def wire_bytes(payload) -> int:
    """Approximate payload size: summed array bytes."""
    return sum(np.asarray(x).nbytes for x in tree_leaves(payload)
               if hasattr(np.asarray(x), "nbytes"))

