"""Edge-case / backdoor example sets for robust-FL evaluation.

Port of ``fedml_tpu/data/edge_case.py``.  ``apply_pixel_trigger`` stamps
a corner square and relabels (the badnets trigger; the ``--adversary
backdoor`` silo transform uses it), ``make_poisoned_dataset`` blends a
poison set into one client's shard, ``load_external_poison`` reads the
reference's pickled edge-case sets (Southwest airliners relabelled
"truck" for CIFAR-10, ARDIS digits relabelled "7"), and
``targeted_task_eval_set`` is the "targetted task" test set: those
images when they are on disk, else trigger-stamped noise."""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np


def apply_pixel_trigger(x: np.ndarray, target_label: int,
                        trigger_size: int = 3, value: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Stamp a trigger_size² bright square in the bottom-right corner of each
    [N, H, W, C] image and relabel everything to ``target_label``."""
    x = x.copy()
    x[..., -trigger_size:, -trigger_size:, :] = value
    y = np.full(len(x), target_label, dtype=np.int32)
    return x, y


def make_poisoned_dataset(x_clean: np.ndarray, y_clean: np.ndarray,
                          x_poison: np.ndarray, y_poison: np.ndarray,
                          poison_frac: float = 0.5, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Blend poison into a clean shard (attacker's local dataset): keep all
    clean samples, append round(poison_frac * n_clean) poison samples,
    shuffle (the reference's attacker datasets are similar fixed blends)."""
    rng = np.random.RandomState(seed)
    n_poison = min(len(y_poison), int(round(poison_frac * len(y_clean))))
    sel = rng.choice(len(y_poison), n_poison, replace=False)
    x = np.concatenate([x_clean, x_poison[sel]])
    y = np.concatenate([y_clean, y_poison[sel]])
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def load_external_poison(path: str, target_label: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Read a pickled image array (e.g. southwest_images_new_train.pkl) and
    relabel to the attack target — target 9 ("truck") for southwest, 7 for
    ARDIS (edge_case_examples/data_loader.py:283-330)."""
    with open(path, "rb") as f:
        imgs = pickle.load(f)
    x = np.asarray(imgs, dtype=np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    y = np.full(len(x), target_label, dtype=np.int32)
    return x, y


def targeted_task_eval_set(dataset: str, data_dir: Optional[str] = None,
                           image_shape: Tuple[int, ...] = (32, 32, 3),
                           target_label: int = 9, n: int = 64,
                           seed: int = 0) -> Dict[str, np.ndarray]:
    """The "targetted task" test set: external poison images when the
    reference's pickles are on disk, otherwise trigger-stamped noise images
    (hermetic).  Accuracy on this set measures backdoor persistence."""
    if data_dir:
        for fname in ("southwest_images_new_test.pkl",
                      "ardis_test_dataset.pt"):
            p = os.path.join(data_dir, fname)
            if not os.path.exists(p):
                continue
            if fname.endswith(".pkl"):
                x, y = load_external_poison(p, target_label)
            else:  # torch-pickled ARDIS TensorDataset (data_loader.py:320)
                import torch
                obj = torch.load(p, map_location="cpu", weights_only=False)
                tensors = getattr(obj, "tensors", obj)
                x = np.asarray(tensors[0], dtype=np.float32)
                if x.max() > 1.5:
                    x = x / 255.0
                # torch ships NCHW (or [N, H, W]); everything here is NHWC
                if x.ndim == 3:
                    x = x[..., None]
                elif x.ndim == 4 and x.shape[1] in (1, 3) \
                        and x.shape[-1] not in (1, 3):
                    x = x.transpose(0, 2, 3, 1)
                y = np.full(len(x), target_label, dtype=np.int32)
            return {"x": x, "y": y}
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *image_shape).astype(np.float32)
    x, y = apply_pixel_trigger(x, target_label)
    return {"x": x, "y": y}
