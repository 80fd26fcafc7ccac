"""Round-level checkpoint / resume (port of ``fedml_tpu/utils/checkpoint.py``,
without orbax).

The state a round loop saves — global params, round key, round index,
and whatever a stateful server adds — is a nested dict whose leaves are
tensors, numpy arrays or Python scalars.  Each saved step is one
directory, ``<ckpt_dir>/<step>/``, holding

* ``tree.json`` — every leaf's path, kind (tensor, array, int, float,
  bool) and dtype;
* ``state.npz`` — the leaves as numpy arrays (uncompressed).

It is written under a temporary name and renamed, so a step directory is
either complete or absent.  A round key is saved as its two uint32 words
(a numpy array).  Beside the steps, ``manifests/<step>.json`` holds a
crc32 per top-level key of the state (`utils.journal.tree_crc`, JAX's
leaf order) for a reader that wants to check what it loads.  A stateful
(BatchNorm) workload's params hold both collections (``params/...`` and
``batch_stats/...``), so its running statistics are saved and resumed
with the weights, and its crc is JAX's over the variables tree.

``async_save`` copies the state to the host on the caller's thread (so a
buffer the next round overwrites is read now) and writes it on one
background thread; ``flush()``, ``close()``, ``latest_round()`` and
``restore()`` wait for pending writes and raise a write's error.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.utils.journal import (atomic_write, leaves_with_path,
                                          tree_crc)

log = logging.getLogger(__name__)

MANIFEST_DIRNAME = "manifests"
TREE_FILE = "tree.json"
STATE_FILE = "state.npz"


def manifest_path(ckpt_dir: str, step: int) -> str:
    """``<ckpt_dir>/manifests/<step>.json``: a sibling tree, never
    digit-named at the top level, so a step listing never takes it for a
    round."""
    return os.path.join(ckpt_dir, MANIFEST_DIRNAME, f"{step}.json")


def _to_host(state: Dict[str, Any]) -> List[tuple]:
    """``(path, kind, numpy value)`` per leaf, tensors copied to the
    host."""
    out = []
    for path, leaf in leaves_with_path(state):
        if isinstance(leaf, torch.Tensor):
            out.append((path, "tensor", leaf.detach().cpu().numpy().copy()))
        elif isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
            out.append((path, "ndarray", np.array(leaf)))
        elif isinstance(leaf, (bool, int, float)):
            kind = type(leaf).__name__
            out.append((path, kind, np.asarray(leaf)))
        else:
            raise TypeError(f"checkpoint leaf {'/'.join(map(str, path))} "
                            f"is a {type(leaf).__name__}; leaves are "
                            f"tensors, numpy arrays or Python scalars")
    return out


def _nest(leaves: List[tuple]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in leaves:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def _as_like(value, like, where: str):
    """``value`` (restored) in the type, dtype and device of ``like``."""
    if isinstance(like, torch.Tensor):
        t = torch.as_tensor(value)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {where} has shape "
                             f"{tuple(t.shape)}, the template "
                             f"{tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        a = np.asarray(value)
        if a.shape != np.shape(like):
            raise ValueError(f"checkpoint leaf {where} has shape {a.shape}, "
                             f"the template {np.shape(like)}")
        return a.astype(np.asarray(like).dtype)
    return type(like)(np.asarray(value).item())


class RoundCheckpointer:
    """Save and restore the training state every ``save_every`` rounds,
    keeping the newest ``max_to_keep`` steps (``keep_last_n`` overrides it
    when set)."""

    def __init__(self, ckpt_dir: str, save_every: int = 1,
                 max_to_keep: int = 3, async_save: bool = False,
                 keep_last_n: Optional[int] = None):
        self.save_every = max(1, int(save_every))
        self.async_save = bool(async_save)
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.keep_last_n = int(keep_last_n) if keep_last_n else max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []

    # -- writing -------------------------------------------------------------
    def maybe_save(self, round_idx: int, state, last_round: bool = False
                   ) -> bool:
        """Save on every ``save_every``-th round and on the last one.
        ``state`` may be a zero-argument callable that builds it, so a
        skipped round pays nothing."""
        if not last_round and (round_idx + 1) % self.save_every:
            return False
        self.save(round_idx, state() if callable(state) else state)
        return True

    def save(self, round_idx: int, state: Dict[str, Any]) -> None:
        leaves = _to_host(state)
        if not self.async_save:
            self._write(int(round_idx), leaves)
            return
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._pending.append(self._pool.submit(self._write, int(round_idx),
                                               leaves))

    def _write(self, step: int, leaves: List[tuple]) -> None:
        final = os.path.join(self.ckpt_dir, str(step))
        tmp = os.path.join(self.ckpt_dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        tree = [{"path": list(p), "kind": kind, "dtype": str(v.dtype)}
                for p, kind, v in leaves]
        with open(os.path.join(tmp, TREE_FILE), "w") as f:
            json.dump({"step": step, "leaves": tree}, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            np.savez(f, **{f"l{i}": v for i, (_, _, v) in enumerate(leaves)})
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._write_manifest(step, leaves)
        self._gc(step)

    def _write_manifest(self, step: int, leaves: List[tuple]) -> None:
        """The per-step crc manifest; a failed write warns (the step itself
        is durable, only the reader's check is lost)."""
        top: Dict[str, list] = {}
        for path, _, v in leaves:
            top.setdefault(str(path[0]), []).append((path[1:], v))
        crcs = {k: tree_crc(_nest(sub) if sub[0][0] else sub[0][1])
                for k, sub in top.items()}
        data = json.dumps({"step": step, "algo": "crc32", "crc": crcs},
                          sort_keys=True).encode()
        path = manifest_path(self.ckpt_dir, step)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write(path, data)
        except OSError as e:
            log.warning("checkpoint manifest for step %d not written (%s)",
                        step, e)

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit())

    def _gc(self, current: int) -> None:
        """Keep the newest ``keep_last_n`` steps and their manifests."""
        steps = self._steps()
        for step in steps[:-self.keep_last_n]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(step)),
                          ignore_errors=True)
        live = set(self._steps())
        mdir = os.path.join(self.ckpt_dir, MANIFEST_DIRNAME)
        for name in os.listdir(mdir) if os.path.isdir(mdir) else ():
            stem = name[:-5] if name.endswith(".json") else name
            if stem.isdigit() and int(stem) not in live \
                    and int(stem) < current:
                os.unlink(os.path.join(mdir, name))

    def flush(self) -> None:
        """Wait until every pending save is on disk; raise a save's
        error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.flush()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- reading -------------------------------------------------------------
    def latest_round(self) -> Optional[int]:
        self.flush()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, round_idx: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The state saved at ``round_idx`` (default: the latest step).
        With ``like`` (a template of the same structure), every leaf comes
        back in the template leaf's type, dtype and device, and a
        structure or shape mismatch raises ``ValueError``; without it,
        saved tensors come back as CPU tensors, arrays as arrays and
        scalars as scalars."""
        self.flush()
        step = round_idx if round_idx is not None else self.latest_round()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        d = os.path.join(self.ckpt_dir, str(step))
        with open(os.path.join(d, TREE_FILE)) as f:
            tree = json.load(f)["leaves"]
        with np.load(os.path.join(d, STATE_FILE)) as z:
            values = [z[f"l{i}"] for i in range(len(tree))]
        if like is not None:
            want = [p for p, _ in leaves_with_path(like)]
            got = [tuple(t["path"]) for t in tree]
            if want != got:
                raise ValueError(f"checkpoint step {step} does not match the "
                                 f"template's structure")
            leaves = [(p, _as_like(v, lk, "/".join(map(str, p))))
                      for (p, lk), v in zip(leaves_with_path(like), values)]
            return _nest(leaves)
        out = []
        for t, v in zip(tree, values):
            kind = t["kind"]
            if kind == "tensor":
                v = torch.from_numpy(np.array(v))
            elif kind != "ndarray":
                v = {"int": int, "float": float, "bool": bool}[kind](v.item())
            out.append((tuple(t["path"]), v))
        return _nest(out)
