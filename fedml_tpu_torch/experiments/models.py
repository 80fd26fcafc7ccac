"""Model x dataset factory (port of ``fedml_tpu/experiments/models.py``)
for the models of the ported slices: ``lr``, ``cnn`` (CNNDropOut),
``cnn_fedavg``, the GroupNorm ResNets (``resnet56``, ``resnet110``,
``resnet18_gn``) and MobileNets (``mobilenet``, ``mobilenet_v3``) on the
image twins; on the next-word twins ``transformer``, and the LSTMs for
every other model name, as in the JAX package (``RNNStackOverflow`` on
``stackoverflow_nwp``, ``RNNOriginalFedAvg`` on the Shakespeare
twins)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.models import (CNNDropOut, CNNOriginalFedAvg,
                                    LogisticRegression, RNNOriginalFedAvg,
                                    RNNStackOverflow, TransformerLM,
                                    mobilenet, mobilenet_v3, resnet18_gn,
                                    resnet56, resnet110)
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              NWPWorkload, Workload)

# next-word/char-prediction datasets -> NWP workload
_NWP_DATASETS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp"}
# the JAX factory's image models the port does not have yet
_QUEUED_IMAGE_MODELS = ("efficientnet", "vgg11", "vgg13", "vgg16")


def create_workload(model_name: str, dataset: str, class_num: int,
                    sample_shape: Sequence[int], attn_block_size: int = 0,
                    attn_flash: bool = False,
                    moe_experts: int = 0) -> Workload:
    """``attn_block_size`` > 0 gives the transformer blockwise attention;
    ``attn_flash`` the flash kernel (K4) instead."""
    if (attn_block_size or attn_flash or moe_experts) \
            and model_name != "transformer":
        raise ValueError("--attn_block_size/--attn_flash/--moe_experts "
                         "only apply to --model transformer")
    if attn_block_size and attn_flash:
        raise ValueError("--attn_block_size and --attn_flash are mutually "
                         "exclusive attention backends; pick one")
    if dataset in _NWP_DATASETS:
        if model_name == "transformer":
            model = TransformerLM(vocab_size=class_num,
                                  block_size=attn_block_size or None,
                                  use_flash=attn_flash,
                                  moe_experts=moe_experts)
        elif dataset == "stackoverflow_nwp":
            model = RNNStackOverflow()
        else:
            model = RNNOriginalFedAvg(vocab_size=class_num)
        return NWPWorkload(model)
    input_dim = int(np.prod(sample_shape))
    small = class_num <= 10
    factories = {
        "lr": lambda: LogisticRegression(input_dim, class_num),
        "cnn": lambda: CNNDropOut(only_digits=small),          # Reddi'20
        "cnn_fedavg": lambda: CNNOriginalFedAvg(only_digits=small),
        "resnet56": lambda: resnet56(class_num),
        "resnet110": lambda: resnet110(class_num),
        "resnet18_gn": lambda: resnet18_gn(class_num),
        "mobilenet": lambda: mobilenet(num_classes=class_num),
        "mobilenet_v3": lambda: mobilenet_v3(num_classes=class_num),
    }
    if model_name not in factories:
        where = (" (EfficientNet and VGG arrive with ROADMAP Queue 1 item "
                 "10's second part, with item 4's remainder)"
                 if model_name in _QUEUED_IMAGE_MODELS else "")
        raise KeyError(f"model {model_name!r} is not ported yet; the port "
                       f"has {sorted(factories)} on image datasets and "
                       f"'transformer' and the LSTMs on "
                       f"{sorted(_NWP_DATASETS)}{where}")
    # grad-clip 1.0, as the reference's classification trainer
    return ClassificationWorkload(factories[model_name](),
                                  num_classes=class_num, grad_clip_norm=1.0)


def sample_shape_of(data: FederatedData) -> tuple:
    return tuple(data.train["x"].shape[3:])
