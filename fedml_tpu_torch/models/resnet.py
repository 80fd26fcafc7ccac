"""ResNets (port of ``fedml_tpu/models/resnet.py``): the CIFAR-style
``resnet56``/``resnet110`` (Bottleneck blocks, stages 16/32/64 x 4) and
the ImageNet-stem ``resnet18_gn`` (7x7/2 conv, 3x3/2 max pool,
BasicBlocks, stages 64..512), GroupNorm by default.

NHWC at the public boundary, NCHW inside; parameters keep flax's paths
and layouts (``BasicBlock_3/Conv_1/kernel`` HWIO, ``Norm_0/GroupNorm_0/
scale``, ``fc/kernel``), so `utils.jax_params` carries weights across.
Every conv and the stem's pool pad as flax's ``SAME`` does, asymmetric at
stride 2 (`models.layers.same_pads`).  Convs carry no bias and start
from flax's ``variance_scaling(2.0, "fan_out", "truncated_normal")``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dense, max_pool_same
from fedml_tpu_torch.models.norms import Norm


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, use_bias=False,
                  init="fan_out")


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block, expansion 1."""
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        self.Conv_0 = _conv(cin, planes, 3, stride)
        self.Norm_0 = Norm(planes, norm)
        self.Conv_1 = _conv(planes, planes, 3)
        self.Norm_1 = Norm(planes, norm, zero_init=True)
        self.down = stride != 1 or cin != planes
        if self.down:
            self.Conv_2 = _conv(cin, planes, 1, stride)
            self.Norm_2 = Norm(planes, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = self.Norm_1(self.Conv_1(out))
        identity = self.Norm_2(self.Conv_2(x)) if self.down else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block, expansion 4."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        out_ch = planes * self.expansion
        self.Conv_0 = _conv(cin, planes, 1)
        self.Norm_0 = Norm(planes, norm)
        self.Conv_1 = _conv(planes, planes, 3, stride)
        self.Norm_1 = Norm(planes, norm)
        self.Conv_2 = _conv(planes, out_ch, 1)
        self.Norm_2 = Norm(out_ch, norm, zero_init=True)
        self.down = stride != 1 or cin != out_ch
        if self.down:
            self.Conv_3 = _conv(cin, out_ch, 1, stride)
            self.Norm_3 = Norm(out_ch, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = F.relu(self.Norm_1(self.Conv_1(out)))
        out = self.Norm_2(self.Conv_2(out))
        identity = self.Norm_3(self.Conv_3(x)) if self.down else x
        return F.relu(out + identity)


def _stages(owner: nn.Module, block, cin: int, widths: Sequence[int],
            layers: Sequence[int], norm: str) -> int:
    """Register the blocks under flax's names (``Bottleneck_0``, ...);
    the first block of every stage after the first has stride 2.
    Returns the channels out."""
    n = 0
    for stage, (planes, n_blocks) in enumerate(zip(widths, layers)):
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            setattr(owner, f"{block.__name__}_{n}",
                    block(cin, planes, stride, norm))
            cin = planes * block.expansion
            n += 1
    owner.n_blocks = n
    owner.block_name = block.__name__
    return cin


def _run_blocks(owner: nn.Module, x: torch.Tensor) -> torch.Tensor:
    for i in range(owner.n_blocks):
        x = getattr(owner, f"{owner.block_name}_{i}")(x)
    return x


class CifarResNet(nn.Module):
    """3-stage CIFAR ResNet: 3x3 conv (16), norm, relu, the stages, global
    average pool, ``fc``."""

    def __init__(self, layers: Sequence[int], num_classes: int = 10,
                 norm: str = "group", block=Bottleneck, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = _conv(in_channels, 16, 3)
        self.Norm_0 = Norm(16, norm)
        cout = _stages(self, block, 16, (16, 32, 64), layers, norm)
        self.fc = Dense(cout, num_classes)

    def forward_features(self, x: torch.Tensor):
        """(pooled features, logits): the reference's KD forward."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        feats = torch.mean(_run_blocks(self, x), dim=(2, 3))
        return feats, self.fc(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_features(x)[1]


class ImageNetResNet(nn.Module):
    """4-stage ImageNet-stem ResNet: 7x7/2 conv (64), norm, relu, 3x3/2
    max pool, the stages, global average pool, ``fc``."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 norm: str = "group", block=BasicBlock,
                 in_channels: int = 3):
        super().__init__()
        self.Conv_0 = _conv(in_channels, 64, 7, 2)
        self.Norm_0 = Norm(64, norm)
        cout = _stages(self, block, 64, (64, 128, 256, 512), layers, norm)
        self.fc = Dense(cout, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        x = max_pool_same(x, 3, 2)
        return self.fc(torch.mean(_run_blocks(self, x), dim=(2, 3)))


def resnet56(num_classes: int, norm: str = "group",
             in_channels: int = 3) -> CifarResNet:
    """Bottleneck [6, 6, 6]."""
    return CifarResNet(layers=(6, 6, 6), num_classes=num_classes, norm=norm,
                       in_channels=in_channels)


def resnet110(num_classes: int, norm: str = "group",
              in_channels: int = 3) -> CifarResNet:
    """Bottleneck [12, 12, 12]."""
    return CifarResNet(layers=(12, 12, 12), num_classes=num_classes,
                       norm=norm, in_channels=in_channels)


def resnet18_gn(num_classes: int, norm: str = "group",
                in_channels: int = 3) -> ImageNetResNet:
    """BasicBlock [2, 2, 2, 2], GroupNorm: the fed_cifar100 benchmark
    model (BASELINE.md config 4)."""
    return ImageNetResNet(layers=(2, 2, 2, 2), num_classes=num_classes,
                          norm=norm, in_channels=in_channels)
