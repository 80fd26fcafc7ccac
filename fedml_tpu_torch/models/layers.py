"""Dense and conv layers that keep flax's parameter layout.

A conv kernel is stored HWIO and a dense kernel ``[in, out]``, as flax
stores them, and permuted at use.  Keeping the layout makes weights carry
across the two packages by renaming alone, and keeps each element's index
within a leaf equal on both sides, which the fused aggregate's noise
stream is keyed by.  Initialisation follows flax's defaults: LeCun-normal
kernels (truncated normal, variance 1 / fan_in) and zero biases."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Conv2d(nn.Module):
    """NCHW activations, HWIO kernel, stride 1, ``SAME`` padding for odd
    kernel sizes."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        k = kernel_size
        self.padding = k // 2
        self.kernel = nn.Parameter(torch.empty(k, k, in_channels,
                                               out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator=None) -> None:
        h, w, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel.data, h * w * cin, generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        padding=self.padding)
