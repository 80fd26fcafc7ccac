"""Dense, conv, attention-projection, norm and embedding layers that keep
flax's parameter layout.

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


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` in the two forms the transformer uses.

    ``in_features -> out_shape``: kernel ``[in, *out_shape]``, bias
    ``out_shape`` (the attention's query/key/value, ``[d_model, H,
    d_head]``).  ``in_shape -> out_features`` with ``contract=len(in_shape)``
    trailing input axes: kernel ``[*in_shape, out]``, bias ``[out]`` (the
    attention's ``out``, ``[H, d_head, d_model]``).  flax initialises the
    kernel LeCun-normal over the flattened contracted axes."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel.data, math.prod(self.in_shape), generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        w = self.kernel.reshape(math.prod(self.in_shape),
                                math.prod(self.out_shape))
        y = x.reshape(lead + (-1,)) @ w
        return y.reshape(lead + self.out_shape) + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: ``scale`` and ``bias`` over the last axis,
    epsilon 1e-6 (flax's default, not torch's 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is named ``embedding``, ``[num,
    features]``, drawn N(0, 1 / features) (flax's variance scaling with
    an untruncated normal)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.embedding.data, 0.0,
                        math.sqrt(1.0 / self.embedding.shape[1]),
                        generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)
