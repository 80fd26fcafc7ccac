"""EfficientNet B0-B7 (port of ``fedml_tpu/models/efficientnet.py``): Tan
and Le's compound-scaled MBConv nets.

Stem (3x3/2 conv, norm, swish) -> seven MBConv stages of the port's
`InvertedResidual` (squeeze-excite, swish, per-block drop-connect) -> 1x1
conv to ``round_filters(1280)``, norm, swish -> global average pool ->
dropout -> dense.  Parameter names are flax's: ``Conv_0``/``Norm_0`` (the
stem), ``InvertedResidual_{0..}``, ``Conv_1``/``Norm_1`` (the head),
``Dense_0``.  The head's dropout is dropout layer 0 of the seam and block
i's drop-connect layer i + 1 (`models.layers.dropout`); they draw in
train mode only (a ``dropout_key``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dense, dropout
from fedml_tpu_torch.models.mobilenet import InvertedResidual
from fedml_tpu_torch.models.norms import Norm

# (expand_ratio, channels, repeats, stride, kernel): B0, Table 1
B0_BLOCKS = (
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3))

# name -> (width_mult, depth_mult, dropout)
SCALINGS = {
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5),
}


def round_filters(ch: int, width_mult: float, divisor: int = 8) -> int:
    ch *= width_mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


class EfficientNet(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 depth_mult: float = 1.0, dropout_rate: float = 0.2,
                 drop_connect: float = 0.2, norm: str = "group",
                 in_channels: int = 3):
        super().__init__()
        c = round_filters(32, width_mult)
        self.Conv_0 = Conv2d(in_channels, c, 3, stride=2, use_bias=False,
                             init="fan_out")
        self.Norm_0 = Norm(c, norm)
        total = sum(round_repeats(r, depth_mult) for _, _, r, _, _ in
                    B0_BLOCKS)
        idx = 0
        for expand, ch, repeats, stride, kernel in B0_BLOCKS:
            out_ch = round_filters(ch, width_mult)
            for i in range(round_repeats(repeats, depth_mult)):
                setattr(self, f"InvertedResidual_{idx}", InvertedResidual(
                    c, c * expand, out_ch, kernel, stride if i == 0 else 1,
                    use_se=True, use_hs=False, norm=norm,
                    se_reduce_ch=max(1, c // 4),
                    drop_rate=drop_connect * idx / total, layer=idx + 1,
                    activation=F.silu))
                c = out_ch
                idx += 1
        self.n_blocks = idx
        head = round_filters(1280, width_mult)
        self.Conv_1 = Conv2d(c, head, 1, use_bias=False, init="fan_out")
        self.Norm_1 = Norm(head, norm)
        self.Dense_0 = Dense(head, num_classes)
        self.dropout_rate = dropout_rate
        self.stochastic = dropout_rate > 0.0 or drop_connect > 0.0

    def forward(self, x: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.silu(self.Norm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x, dropout_key)
        x = F.silu(self.Norm_1(self.Conv_1(x)))
        x = dropout(torch.mean(x, dim=(2, 3)), self.dropout_rate,
                    dropout_key, 0)
        return self.Dense_0(x)


def efficientnet(name: str = "b0", num_classes: int = 1000,
                 norm: str = "group", in_channels: int = 3) -> EfficientNet:
    """``EfficientNet.from_name('efficientnet-b0')``'s scaling."""
    w, d, drop = SCALINGS[name]
    return EfficientNet(num_classes=num_classes, width_mult=w, depth_mult=d,
                        dropout_rate=drop, norm=norm,
                        in_channels=in_channels)
