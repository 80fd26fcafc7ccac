"""Host-side cohort staging: ragged per-client data -> padded device tensors.

Port of ``fedml_tpu/data/stacking.py``.  All clients' data stays in
stacked host numpy arrays ``[num_clients, S, B, ...]`` padded to a common
S; each round gathers the sampled cohort's rows and ships one block to the
device.  Masks keep padded rows out of loss and metrics, so the
sample-weighted aggregate stays exact despite padding."""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

Array = np.ndarray


@dataclasses.dataclass
class FederatedData:
    """train/test: dicts of stacked host arrays {x: [N, S, B, ...],
    y: [N, S, B, ...], mask: [N, S, B], num_samples: [N]} over all N
    clients; the *_global splits are one client's layout [S, B, ...]."""
    client_num: int
    class_num: int
    train: Dict[str, Array]
    test: Optional[Dict[str, Array]] = None
    train_global: Optional[Dict[str, Array]] = None
    test_global: Optional[Dict[str, Array]] = None


def stack_client_data(xs: Sequence[Array], ys: Sequence[Array],
                      batch_size: int, steps: Optional[int] = None,
                      shuffle_seed: Optional[int] = None) -> Dict[str, Array]:
    """Stack ragged per-client (x, y) into [C, S, B, ...] + mask + counts.
    S = ceil(max_i n_i / B) unless given; short clients get zero-padded
    batches with mask 0.  ``shuffle_seed`` shuffles each client once."""
    C = len(xs)
    assert C == len(ys)
    rng = np.random.RandomState(shuffle_seed) if shuffle_seed is not None else None
    counts = np.asarray([len(x) for x in xs], dtype=np.int64)
    if steps is None:
        steps = int(np.ceil(max(int(counts.max()), 1) / batch_size))
    cap = steps * batch_size

    # shapes and dtypes from the first non-empty client
    x0 = next((np.asarray(x) for x in xs if len(x)), np.asarray(xs[0]))
    sample_shape = x0.shape[1:]
    x_out = np.zeros((C, steps, batch_size) + sample_shape, dtype=x0.dtype)
    y0 = next((np.asarray(y) for y in ys if len(y)), np.asarray(ys[0]))
    y_shape = y0.shape[1:]
    y_out = np.zeros((C, steps, batch_size) + y_shape, dtype=y0.dtype)
    mask = np.zeros((C, steps, batch_size), dtype=np.float32)

    clipped = np.minimum(counts, cap)
    for c in range(C):
        n = int(clipped[c])
        if n == 0:
            continue
        x = np.asarray(xs[c])[:n]
        y = np.asarray(ys[c])[:n]
        if rng is not None and n > 1:
            perm = rng.permutation(n)
            x, y = x[perm], y[perm]
        x_out[c].reshape((cap,) + sample_shape)[:n] = x
        y_out[c].reshape((cap,) + y_shape)[:n] = y
        mask[c].reshape(cap)[:n] = 1.0
    return {"x": x_out, "y": y_out, "mask": mask,
            "num_samples": clipped.astype(np.float32)}


def batch_global(x: Array, y: Array, batch_size: int) -> Dict[str, Array]:
    """Batch one (global) dataset into [S, B, ...] + mask."""
    d = stack_client_data([x], [y], batch_size)
    return {"x": d["x"][0], "y": d["y"][0], "mask": d["mask"][0]}


def save_stacked(stacked: Dict[str, Array], out_dir: str) -> None:
    """Persist a stacked client tree as one ``.npy`` per key (the staging
    format of corpora larger than host memory, `load_stacked_memmap`)."""
    os.makedirs(out_dir, exist_ok=True)
    for k, v in stacked.items():
        np.save(os.path.join(out_dir, f"{k}.npy"), np.asarray(v))


def load_stacked_memmap(in_dir: str) -> Dict[str, Array]:
    """A saved stacked tree, memory-mapped read-only.  The ``[N, S, B,
    ...]`` arrays stay on disk: `gather_cohort`'s ``v[ids]`` copies only
    the sampled cohort's rows, and FedAvg's device-data budget reads
    ``nbytes`` without reading the data, so a corpus over the budget
    stays on the per-round host gather."""
    out = {}
    for f in sorted(os.listdir(in_dir)):
        if f.endswith(".npy"):
            out[f[:-4]] = np.load(os.path.join(in_dir, f), mmap_mode="r")
    return out


def _tensor(v, device: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.flags.writeable:
        return torch.as_tensor(a).to(device)
    # a read-only memmap: a CPU tensor gets its own copy (a tensor on the
    # map would fault on a write); a CUDA one is read once off the map
    if device.type == "cpu":
        return torch.from_numpy(a.copy())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a).to(device)


def to_device(stacked: Dict[str, Array], device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    return {k: _tensor(v, device) for k, v in stacked.items()}


def gather_cohort(stacked: Dict[str, Array], client_ids: Sequence[int],
                  pad_to: Optional[int] = None, device="cpu"
                  ) -> Dict[str, torch.Tensor]:
    """The sampled cohort's rows as tensors on ``device``, optionally padded
    with weight-0 dummy clients to a fixed cohort size.  A padded slot
    aliases client 0's rows but carries mask 0 and num_samples 0, so the
    local trainer leaves it at the round's global and every weighted
    reduction sees an exact +0.0."""
    ids = np.asarray(client_ids, dtype=np.int64)
    if pad_to is not None and len(ids) > pad_to:
        raise ValueError(
            f"gather_cohort: {len(ids)} sampled clients exceed "
            f"pad_to={pad_to}; the fixed cohort shape cannot hold them")
    live = np.ones(len(ids), np.float32)
    if pad_to is not None and len(ids) < pad_to:
        ids = np.concatenate([ids, np.zeros(pad_to - len(ids), np.int64)])
        live = np.concatenate([live, np.zeros(pad_to - len(live), np.float32)])
    out = to_device({k: v[ids] for k, v in stacked.items()}, device)
    live_t = torch.as_tensor(live).to(device)
    out["mask"] = out["mask"] * live_t[:, None, None]
    out["num_samples"] = out["num_samples"] * live_t
    return out
