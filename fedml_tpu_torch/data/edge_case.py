"""Edge-case / backdoor poison construction.

Only the pixel trigger is ported here, from
``fedml_tpu/data/edge_case.py::apply_pixel_trigger`` (:26-34), for the
``--adversary backdoor`` silo transform; the edge-case poison-set
loaders (``make_poisoned_dataset``, ``load_external_poison``,
``targeted_task_eval_set``) arrive with the rest of the data loaders
(ROADMAP Queue 1 item 12)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def apply_pixel_trigger(x: np.ndarray, target_label: int,
                        trigger_size: int = 3, value: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Stamp a trigger_size² bright square in the bottom-right corner of
    each [N, H, W, C] image and relabel everything to ``target_label``."""
    x = x.copy()
    x[..., -trigger_size:, -trigger_size:, :] = value
    y = np.full(len(x), target_label, dtype=np.int32)
    return x, y
