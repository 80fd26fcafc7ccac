"""Durable-write helpers (the port's copies of two functions of
``fedml_tpu/utils/journal.py``; the round journal itself is not ported).

* `atomic_write` — tmp file + fsync + ``os.replace``: a reader sees the
  previous complete file or the new complete one, never a torn middle.
* `tree_crc` — crc32 over a tree's leaf bytes in JAX's leaf order (dict
  keys sorted at every level; a flat key ``"a/b"`` sorts as the path
  ``a``, ``b``), so a tree of the same values gives the JAX package's crc.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through ``path + ".tmp"``, fsynced, then
    renamed over ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` for every leaf of nested dicts, in JAX's leaf
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: str(k).split("/")):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def tree_crc(tree) -> int:
    """crc32 over the bytes of every leaf, in leaf order (tensors through
    their host copy)."""
    crc = 0
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(leaf)).tobytes(),
                         crc)
    return crc
