"""The FedAvg-paper CNNs (port of ``fedml_tpu/models/cnn.py``).

Input is NHWC at the public boundary, as in the JAX package; it is turned
to NCHW for cuDNN, and turned back before the flatten so that ``Dense_0``
sees features in flax's (H, W, C) order."""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dense, dropout


class CNNOriginalFedAvg(nn.Module):
    """McMahan'17: 2x [5x5 conv SAME, relu, 2x2 maxpool], dense 512, dense
    num_classes.  1,690,046 parameters at 62 classes."""

    def __init__(self, only_digits: bool = True, in_channels: int = 1,
                 image_size: int = 28):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, 32, 5)
        self.Conv_1 = Conv2d(32, 64, 5)
        side = image_size // 4
        self.Dense_0 = Dense(side * side * 64, 512)
        self.Dense_1 = Dense(512, 10 if only_digits else 62)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]                       # [B, 28, 28] -> NHWC
        x = x.permute(0, 3, 1, 2)                  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class CNNDropOut(nn.Module):
    """Reddi'20 (Adaptive Federated Optimization): 2x 3x3 conv VALID,
    relu, 2x2 maxpool, dropout 0.25, dense 128, dropout 0.5, dense
    num_classes.  1,199,882 parameters at 10 classes, 1,206,590 at 62.
    Dropout runs when ``dropout_key`` is given (train mode)."""

    stochastic = True

    def __init__(self, only_digits: bool = True, in_channels: int = 1,
                 image_size: int = 28):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, 32, 3, padding="VALID")
        self.Conv_1 = Conv2d(32, 64, 3, padding="VALID")
        side = (image_size - 4) // 2
        self.Dense_0 = Dense(side * side * 64, 128)
        self.Dense_1 = Dense(128, 10 if only_digits else 62)

    def forward(self, x: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1)                  # (H, W, C), as flax
        x = dropout(x, 0.25, dropout_key, 0).reshape(x.shape[0], -1)
        x = dropout(F.relu(self.Dense_0(x)), 0.5, dropout_key, 1)
        return self.Dense_1(x)
