"""Model x dataset factory (port of ``fedml_tpu/experiments/models.py``)
for the models of this slice: ``lr`` and ``cnn_fedavg``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.trainer.workload import ClassificationWorkload, Workload


def create_workload(model_name: str, dataset: str, class_num: int,
                    sample_shape: Sequence[int]) -> Workload:
    input_dim = int(np.prod(sample_shape))
    small = class_num <= 10
    factories = {
        "lr": lambda: LogisticRegression(input_dim, class_num),
        "cnn_fedavg": lambda: CNNOriginalFedAvg(only_digits=small),
    }
    if model_name not in factories:
        raise KeyError(f"model {model_name!r} is not ported yet; the port "
                       f"has {sorted(factories)}")
    # grad-clip 1.0, as the reference's classification trainer
    return ClassificationWorkload(factories[model_name](),
                                  num_classes=class_num, grad_clip_norm=1.0)


def sample_shape_of(data: FederatedData) -> tuple:
    return tuple(data.train["x"].shape[3:])
