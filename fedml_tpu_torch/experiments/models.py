"""Model x dataset factory (port of ``fedml_tpu/experiments/models.py``)
for the models of the ported slices: ``lr``, ``cnn`` (CNNDropOut),
``cnn_fedavg``, the GroupNorm ResNets (``resnet56``, ``resnet110``,
``resnet18_gn``), MobileNets (``mobilenet``, ``mobilenet_v3``),
``efficientnet`` (B0) and ``vgg11``/``vgg13``/``vgg16`` on the image
twins; on the next-word twins ``transformer``, and the LSTMs for every
other model name, as in the JAX package (``RNNStackOverflow`` on
``stackoverflow_nwp``, ``RNNOriginalFedAvg`` on the Shakespeare twins).
``compute_dtype`` ("bfloat16") is the workloads' mixed precision, and the
NWP models' ``dtype``.  On ``stackoverflow_lr`` every model name gives
the tag-prediction LR (10,000 words onto 500 tags), as in the JAX
package."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.models import (CNNDropOut, CNNOriginalFedAvg,
                                    LogisticRegression, RNNOriginalFedAvg,
                                    RNNStackOverflow, TransformerLM,
                                    efficientnet, mobilenet, mobilenet_v3,
                                    resnet18_gn, resnet56, resnet110, vgg11,
                                    vgg13, vgg16)
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              NWPWorkload,
                                              TagPredictionWorkload, Workload,
                                              compute_dtype_of)

# next-word/char-prediction datasets -> NWP workload
_NWP_DATASETS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp"}


def create_workload(model_name: str, dataset: str, class_num: int,
                    sample_shape: Sequence[int], compute_dtype: str = "",
                    attn_block_size: int = 0, attn_flash: bool = False,
                    moe_experts: int = 0) -> Workload:
    """``attn_block_size`` > 0 gives the transformer blockwise attention;
    ``attn_flash`` the flash kernel (K4) instead (its bf16 kernels under
    ``compute_dtype="bfloat16"``)."""
    dtype = compute_dtype_of(compute_dtype)
    if (attn_block_size or attn_flash or moe_experts) \
            and model_name != "transformer":
        raise ValueError("--attn_block_size/--attn_flash/--moe_experts "
                         "only apply to --model transformer")
    if attn_block_size and attn_flash:
        raise ValueError("--attn_block_size and --attn_flash are mutually "
                         "exclusive attention backends; pick one")
    if dtype is not None and dataset == "stackoverflow_lr":
        raise ValueError(
            f"--compute_dtype is not wired into the tag-prediction "
            f"workload; dataset {dataset!r} would silently ignore it")
    if dataset in _NWP_DATASETS:
        if model_name == "transformer":
            model = TransformerLM(vocab_size=class_num, dtype=dtype,
                                  block_size=attn_block_size or None,
                                  use_flash=attn_flash,
                                  moe_experts=moe_experts)
        elif dataset == "stackoverflow_nwp":
            model = RNNStackOverflow(dtype=dtype)
        else:
            model = RNNOriginalFedAvg(vocab_size=class_num, dtype=dtype)
        return NWPWorkload(model, compute_dtype=dtype)
    input_dim = int(np.prod(sample_shape))
    if dataset == "stackoverflow_lr":
        # tag prediction: an LR of the bag of words onto the tags
        return TagPredictionWorkload(LogisticRegression(input_dim,
                                                        class_num))
    small = class_num <= 10
    # an HWC image's channels, and VGG's dense head its pooled map (flax
    # infers both from the first batch)
    hw = int(sample_shape[0]) if len(sample_shape) == 3 else 32
    ch = dict(in_channels=int(sample_shape[-1])) \
        if len(sample_shape) == 3 else {}
    factories = {
        "lr": lambda: LogisticRegression(input_dim, class_num),
        "cnn": lambda: CNNDropOut(only_digits=small),          # Reddi'20
        "cnn_fedavg": lambda: CNNOriginalFedAvg(only_digits=small),
        "resnet56": lambda: resnet56(class_num, **ch),
        "resnet110": lambda: resnet110(class_num, **ch),
        "resnet18_gn": lambda: resnet18_gn(class_num, **ch),
        "mobilenet": lambda: mobilenet(num_classes=class_num, **ch),
        "mobilenet_v3": lambda: mobilenet_v3(num_classes=class_num, **ch),
        "efficientnet": lambda: efficientnet("b0", num_classes=class_num,
                                             **ch),
        "vgg11": lambda: vgg11(num_classes=class_num, input_hw=hw, **ch),
        "vgg13": lambda: vgg13(num_classes=class_num, input_hw=hw, **ch),
        "vgg16": lambda: vgg16(num_classes=class_num, input_hw=hw, **ch),
    }
    if model_name not in factories:
        raise KeyError(f"unknown model {model_name!r}; the port has "
                       f"{sorted(factories)} on image datasets and "
                       f"'transformer' and the LSTMs on "
                       f"{sorted(_NWP_DATASETS)}")
    # grad-clip 1.0, as the reference's classification trainer
    return ClassificationWorkload(factories[model_name](),
                                  num_classes=class_num, grad_clip_norm=1.0,
                                  compute_dtype=dtype)


def sample_shape_of(data: FederatedData) -> tuple:
    return tuple(data.train["x"].shape[3:])
