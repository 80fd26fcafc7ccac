"""MobileNet V1 and V3 (port of ``fedml_tpu/models/mobilenet.py``): the
cross-silo CIFAR/CINIC models of BASELINE config 3.

V1 is the depthwise-separable stack with the CIFAR stem (stride 1);
``width_mult`` scales the stem and the pointwise convs as ``max(8,
int(c * width_mult))``.  V3 is the inverted-residual stack with
squeeze-excite and hard-swish, ``large`` and ``small``, and a head
dropout of 0.2 through the dropout seam (`models.layers.dropout`).

Parameter names are flax's auto-names: the convs and norms that the
JAX package's helpers (``_conv_norm``, ``_depthwise``) create inside a
parent's compact ``__call__`` are numbered in the parent's scope in
creation order (``Conv_0 ... Conv_26``, ``Norm_0 ...``), which `_Stack`
reproduces.  Convs carry no bias, start from flax's fan-out init and pad
with flax's ``SAME`` (asymmetric at stride 2); a depthwise conv is a
grouped conv with one group per channel (under ``vmap`` over clients,
clients x channels groups)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dense, dropout
from fedml_tpu_torch.models.norms import Norm


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_sigmoid``: ``relu6(x + 3) / 6``."""
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish``: ``x * hard_sigmoid(x)``."""
    return x * hard_sigmoid(x)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Stack(nn.Module):
    """A scope that numbers its convs and norms as flax does (each conv
    is followed by its norm, so ``Conv_n`` pairs with ``Norm_n``) and runs
    its conv-norm-act layers in order."""

    def __init__(self):
        super().__init__()
        self._n_conv = 0
        self._layers: List[Tuple[str, str, Callable]] = []

    def conv_norm(self, cin: int, cout: int, k: int, stride: int, norm: str,
                  act: Callable, groups: int = 1) -> int:
        n = self._n_conv
        self._n_conv += 1
        setattr(self, f"Conv_{n}", Conv2d(cin, cout, k, stride=stride,
                                          use_bias=False, init="fan_out",
                                          groups=groups))
        setattr(self, f"Norm_{n}", Norm(cout, norm))
        self._layers.append((f"Conv_{n}", f"Norm_{n}", act))
        return cout

    def depthwise(self, ch: int, k: int, stride: int, norm: str,
                  act: Callable) -> int:
        return self.conv_norm(ch, ch, k, stride, norm, act, groups=ch)

    def run(self, x: torch.Tensor, layers) -> torch.Tensor:
        for conv, norm, act in layers:
            x = act(getattr(self, norm)(getattr(self, conv)(x)))
        return x


# (out_channels, stride) of V1's blocks after the stem
V1_BLOCKS: Sequence[Tuple[int, int]] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
    (1024, 1))


class MobileNetV1(_Stack):
    """13 depthwise-separable blocks; ``stem_stride=2`` gives the ImageNet
    stem."""

    def __init__(self, num_classes: int = 100, width_mult: float = 1.0,
                 norm: str = "group", stem_stride: int = 1,
                 in_channels: int = 3):
        super().__init__()
        w = lambda c: max(8, int(c * width_mult))
        c = self.conv_norm(in_channels, w(32), 3, stem_stride, norm, F.relu)
        for out_ch, stride in V1_BLOCKS:
            c = self.depthwise(c, 3, stride, norm, F.relu)
            c = self.conv_norm(c, w(out_ch), 1, 1, norm, F.relu)
        self.Dense_0 = Dense(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.run(x.permute(0, 3, 1, 2), self._layers)
        return self.Dense_0(torch.mean(x, dim=(2, 3)))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce_ch: int):
        super().__init__()
        self.Dense_0 = Dense(channels, reduce_ch)
        self.Dense_1 = Dense(reduce_ch, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(torch.mean(x, dim=(2, 3))))
        s = hard_sigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class InvertedResidual(_Stack):
    """MBConv: 1x1 expand -> k x k depthwise (+ squeeze-excite) -> 1x1
    project, residual at stride 1 with matching channels.  ``drop_rate``:
    stochastic depth on the residual branch, one keep/drop per sample,
    keyed through the dropout seam as dropout ``layer``.  ``activation``
    overrides the ``use_hs`` switch (EfficientNet's swish)."""

    def __init__(self, cin: int, exp_ch: int, out_ch: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool, norm: str = "group",
                 se_reduce_ch: Optional[int] = None, drop_rate: float = 0.0,
                 layer: int = 0, activation: Optional[Callable] = None):
        super().__init__()
        act = activation or (hard_swish if use_hs else F.relu)
        c = cin
        if exp_ch != cin:
            c = self.conv_norm(c, exp_ch, 1, 1, norm, act)
        c = self.depthwise(c, kernel, stride, norm, act)
        self._pre = list(self._layers)
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(
                c, se_reduce_ch or max(8, exp_ch // 4))
        self.conv_norm(c, out_ch, 1, 1, norm, _identity)
        self._post = self._layers[len(self._pre):]
        self.use_se = use_se
        self.residual = stride == 1 and cin == out_ch
        self.drop_rate, self.layer = drop_rate, layer

    def forward(self, x: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.run(x, self._pre)
        if self.use_se:
            h = self.SqueezeExcite_0(h)
        h = self.run(h, self._post)
        if not self.residual:
            return h
        if dropout_key is not None and self.drop_rate > 0.0:
            keep = torch.ones_like(h[:, :1, :1, :1])
            h = h * dropout(keep, self.drop_rate, dropout_key, self.layer)
        return h + x


# (kernel, exp, out, SE, HS, stride), Howard'19 Tables 1 and 2
V3_LARGE = (
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1))
V3_SMALL = (
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1))


class MobileNetV3(_Stack):
    """Stem (3x3/2, hard-swish), the inverted residuals, a 1x1 conv to the
    last expansion, global average pool, dense 1280 (large) or 1024
    (small) with hard-swish, dropout, dense ``num_classes``.  The head's
    dropout is dropout layer 0 of the seam."""

    def __init__(self, num_classes: int = 1000, mode: str = "large",
                 norm: str = "group", dropout_rate: float = 0.2,
                 in_channels: int = 3):
        super().__init__()
        if mode not in ("large", "small"):
            raise ValueError(f"mode must be 'large' or 'small', got {mode!r}")
        cfg = V3_LARGE if mode == "large" else V3_SMALL
        c = self.conv_norm(in_channels, 16, 3, 2, norm, hard_swish)
        self.n_blocks = len(cfg)
        for i, (k, exp, out, se, hs, s) in enumerate(cfg):
            setattr(self, f"InvertedResidual_{i}", InvertedResidual(
                c, exp, out, k, s, se, hs, norm, layer=i + 1))
            c = out
        self.conv_norm(c, cfg[-1][1], 1, 1, norm, hard_swish)
        head = 1280 if mode == "large" else 1024
        self.Dense_0 = Dense(cfg[-1][1], head)
        self.Dense_1 = Dense(head, num_classes)
        self.dropout_rate = dropout_rate
        self.stochastic = dropout_rate > 0.0

    def forward(self, x: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.run(x.permute(0, 3, 1, 2), self._layers[:1])
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x, dropout_key)
        x = self.run(x, self._layers[1:])
        x = hard_swish(self.Dense_0(torch.mean(x, dim=(2, 3))))
        x = dropout(x, self.dropout_rate, dropout_key, 0)
        return self.Dense_1(x)


def mobilenet(num_classes: int = 100, norm: str = "group",
              width_mult: float = 1.0, stem_stride: int = 1,
              in_channels: int = 3) -> MobileNetV1:
    """The CIFAR MobileNet (the reference's class_num default 100,
    stride-1 stem); ``stem_stride=2`` for the ImageNet stem."""
    return MobileNetV1(num_classes=num_classes, norm=norm,
                       width_mult=width_mult, stem_stride=stem_stride,
                       in_channels=in_channels)


def mobilenet_v3(num_classes: int = 1000, mode: str = "large",
                 norm: str = "group", in_channels: int = 3) -> MobileNetV3:
    return MobileNetV3(num_classes=num_classes, mode=mode, norm=norm,
                       in_channels=in_channels)
