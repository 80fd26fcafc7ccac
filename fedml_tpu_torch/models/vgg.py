"""VGG 11/13/16 with an optional norm, VGG16's perceptual-loss trunk
(port of ``fedml_tpu/models/vgg.py``).

One ``norm`` switch covers the reference's plain and BN variants
("none", "batch", "group").  Convs are 3x3 ``SAME`` with a bias and
flax's fan-out init (``Conv_k``, then ``Norm_k`` when normalised), "M" a
2x2 stride-2 max pool; the classifier flattens whatever spatial extent
remains in NHWC order (as flax's ``reshape``, so ``Dense_0``'s kernel
rows line up) into the torchvision head (4096 -> 4096 -> classes, ReLU
and dropout 0.5 between; the dropouts are layers 0 and 1 of the dropout
seam).  ``input_hw`` fixes ``Dense_0``'s input width (flax infers it)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.models.layers import Conv2d, Dense, dropout
from fedml_tpu_torch.models.norms import Norm

# torchvision's configs: conv widths, "M" = max pool
CFGS = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int = 1000,
                 norm: str = "none", dropout_rate: float = 0.5,
                 input_hw: int = 32, in_channels: int = 3):
        super().__init__()
        self.cfg, self.norm = tuple(cfg), norm
        c, hw, k = in_channels, input_hw, 0
        for v in self.cfg:
            if v == "M":
                hw //= 2
                continue
            setattr(self, f"Conv_{k}", Conv2d(c, v, 3, init="fan_out"))
            if norm != "none":
                setattr(self, f"Norm_{k}", Norm(v, norm))
            c, k = v, k + 1
        if hw < 1:
            # vgg11/13/16: k convs and the three dense layers
            raise ValueError(
                f"vgg{k + 3} on a {input_hw}x{input_hw} input: its "
                f"{self.cfg.count('M')} pools leave a {hw}x{hw} map for the "
                f"dense head (it takes {2 ** self.cfg.count('M')}x"
                f"{2 ** self.cfg.count('M')} or larger)")
        self.Dense_0 = Dense(c * hw * hw, 4096)
        self.Dense_1 = Dense(4096, 4096)
        self.Dense_2 = Dense(4096, num_classes)
        self.dropout_rate = dropout_rate
        self.stochastic = dropout_rate > 0.0

    def forward(self, x: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        k = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{k}")(x)
            if self.norm != "none":
                x = getattr(self, f"Norm_{k}")(x)
            x = F.relu(x)
            k += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0],
                                          self.Dense_0.kernel.shape[0])
        x = dropout(F.relu(self.Dense_0(x)), self.dropout_rate, dropout_key,
                    0)
        x = dropout(F.relu(self.Dense_1(x)), self.dropout_rate, dropout_key,
                    1)
        return self.Dense_2(x)


def vgg11(num_classes: int = 1000, norm: str = "none",
          input_hw: int = 32, in_channels: int = 3) -> VGG:
    return VGG(CFGS["A"], num_classes, norm, input_hw=input_hw,
               in_channels=in_channels)


def vgg13(num_classes: int = 1000, norm: str = "none",
          input_hw: int = 32, in_channels: int = 3) -> VGG:
    return VGG(CFGS["B"], num_classes, norm, input_hw=input_hw,
               in_channels=in_channels)


def vgg16(num_classes: int = 1000, norm: str = "none",
          input_hw: int = 32, in_channels: int = 3) -> VGG:
    return VGG(CFGS["D"], num_classes, norm, input_hw=input_hw,
               in_channels=in_channels)


# torchvision's feature indices 3/8/15/22 fall after these conv counts
TAPS = {2: "relu1_2", 4: "relu2_2", 7: "relu3_3", 10: "relu4_3"}


class VGG16Features(nn.Module):
    """VGG16's conv trunk tapped at relu1_2, relu2_2, relu3_3 and relu4_3
    (its first 10 convs, ``Conv_0..Conv_9``); ``forward`` returns the
    taps by name (NCHW).  Weights: a torchvision ``vgg16`` state_dict
    truncated to its first 10 convs, through `utils.torch_import`."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        c, k = in_channels, 0
        for v in CFGS["D"]:
            if v == "M":
                continue
            setattr(self, f"Conv_{k}", Conv2d(c, v, 3, init="fan_out"))
            c, k = v, k + 1
            if k == 10:
                break

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        taps, k = {}, 0
        for v in CFGS["D"]:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"Conv_{k}")(x))
            k += 1
            if k in TAPS:
                taps[TAPS[k]] = x
            if k == 10:
                break
        return taps


def perceptual_loss(feat_params, feat_model: VGG16Features, x1, x2):
    """MSE over the four tapped VGG16 feature maps; NHWC inputs, a
    single channel repeated to RGB.  ``feat_params`` is the flat
    parameter dict (``Conv_k/kernel``, ``Conv_k/bias``)."""
    def rgb(x):
        return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x

    names = {k.replace("/", "."): v for k, v in feat_params.items()}
    f1 = functional_call(feat_model, names, (rgb(x1),))
    f2 = functional_call(feat_model, names, (rgb(x2),))
    loss = 0.0
    for k in ("relu1_2", "relu2_2", "relu3_3", "relu4_3"):
        loss = loss + torch.mean((f1[k] - f2[k]) ** 2)
    return loss
