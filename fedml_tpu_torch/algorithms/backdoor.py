"""Backdoor-attack evaluation for robust FL (port of
``fedml_tpu/algorithms/backdoor.py``).

* poisoned clients: a fraction of the cohort trains on trigger-stamped,
  target-relabelled data (`poison_stacked_clients`), drawn from
  ``np.random.RandomState(seed)`` as the JAX package draws them, so the
  poisoned stacks are bit-equal;
* the targeted task (`targeted_accuracy`): how often the global model
  emits the attacker's label on triggered inputs, the backdoor's success
  rate;
* the raw task beside it (`evaluate_backdoor`), so a defense is judged on
  both axes.

The trigger is `data.edge_case.apply_pixel_trigger`.  Poisoning is host
numpy on the stacked ``[C, S, B, ...]`` split; the evaluations run the
model on the params' device."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.data.edge_case import apply_pixel_trigger
from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.trainer.workload import apply_model

Array = np.ndarray


def poison_stacked_clients(train: Dict[str, Array],
                           attacker_ids: Sequence[int],
                           target_label: int,
                           poison_frac: float = 1.0,
                           trigger_size: int = 3,
                           value: float = 1.0,
                           seed: int = 0) -> Dict[str, Array]:
    """Stamp the pixel trigger and the target label onto ``poison_frac`` of
    each attacker's real (masked) samples in a stacked [C, S, B, ...] train
    dict.  Samples are replaced in place, so the stacked shapes, masks and
    aggregation weights are unchanged."""
    x = np.array(train["x"], copy=True)
    y = np.array(train["y"], copy=True)
    rng = np.random.RandomState(seed)
    sample_shape = x.shape[3:]
    for cid in attacker_ids:
        flat_x = x[cid].reshape((-1,) + sample_shape)
        flat_y = y[cid].reshape(-1)
        real = np.where(np.asarray(train["mask"][cid]).reshape(-1) > 0)[0]
        k = int(round(poison_frac * len(real)))
        if k == 0:
            continue
        sel = rng.choice(real, k, replace=False)
        px, py = apply_pixel_trigger(flat_x[sel], target_label,
                                     trigger_size=trigger_size, value=value)
        flat_x[sel] = px
        flat_y[sel] = py
        x[cid] = flat_x.reshape(x[cid].shape)
        y[cid] = flat_y.reshape(y[cid].shape)
    return {**train, "x": x, "y": y}


def poison_federated_data(data: FederatedData,
                          attacker_ids: Sequence[int],
                          target_label: int,
                          poison_frac: float = 1.0,
                          trigger_size: int = 3,
                          value: float = 1.0,
                          seed: int = 0) -> FederatedData:
    """``data`` with the attackers' train shards backdoored (the test split
    stays clean: the raw task is measured on honest data)."""
    return FederatedData(
        client_num=data.client_num, class_num=data.class_num,
        train=poison_stacked_clients(
            data.train, attacker_ids, target_label, poison_frac,
            trigger_size, value, seed),
        test=data.test, train_global=data.train_global,
        test_global=data.test_global)


def make_targeted_test_set(x_clean: Array, y_clean: Array, target_label: int,
                           trigger_size: int = 3, value: float = 1.0,
                           exclude_target_class: bool = True
                           ) -> Dict[str, Array]:
    """Trigger-stamp clean test images, keeping only those whose true label
    is not the target already (a flip counts, a freebie does not)."""
    if exclude_target_class:
        keep = y_clean != target_label
        x_clean, y_clean = x_clean[keep], y_clean[keep]
    xt, yt = apply_pixel_trigger(x_clean, target_label,
                                 trigger_size=trigger_size, value=value)
    return {"x": xt, "y": yt}


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def targeted_accuracy(workload, params, targeted: Dict[str, Array],
                      batch_size: int = 256) -> float:
    """Backdoor success rate: the fraction of targeted-task inputs the
    model classifies as the attacker's label."""
    x = np.asarray(targeted["x"])
    y = np.asarray(targeted["y"])
    device = _device_of(params)
    hits, total = 0, 0
    with torch.no_grad():
        for lo in range(0, len(x), batch_size):
            logits = apply_model(workload.model, params,
                                 torch.as_tensor(x[lo:lo + batch_size]
                                                 ).to(device))
            pred = torch.argmax(logits, dim=-1).cpu().numpy()
            hits += int((pred == y[lo:lo + batch_size]).sum())
            total += len(pred)
    return hits / max(total, 1)


def evaluate_backdoor(workload, params, targeted: Dict[str, Array],
                      clean: Optional[Dict[str, Array]] = None
                      ) -> Dict[str, float]:
    """The two-axis report: backdoor success and, given a clean stacked
    eval set (one batch [B, ...] or a stack [S, B, ...]), the raw-task
    accuracy."""
    out = {"backdoor_acc": targeted_accuracy(workload, params, targeted)}
    if clean is not None:
        x, y, m = (np.asarray(clean[k]) for k in ("x", "y", "mask"))
        if m.ndim == 2:
            x = x.reshape((-1,) + x.shape[2:])
            y = y.reshape(-1)
            m = m.reshape(-1)
        device = _device_of(params)
        with torch.no_grad():
            metrics = workload.metric_fn(params, {
                "x": torch.as_tensor(x).to(device),
                "y": torch.as_tensor(y).to(device),
                "mask": torch.as_tensor(m).to(device)})
        out["raw_task_acc"] = (float(metrics["correct"])
                               / max(float(metrics["total"]), 1.0))
    return out
