"""Split ResNets for FedGKT, group knowledge transfer (port of
``fedml_tpu/models/resnet_gkt.py``), built from `models.resnet`'s blocks
and `models.norms.Norm` (GroupNorm by default).

* ``GKTClientResNet``: the CIFAR stem (3x3 conv, 16 planes), ``blocks``
  BasicBlocks at 16 planes, average pool and ``fc``; its forward returns
  ``(logits, feats)``, the pre-pool maps ``[B, H, W, 16]`` that travel to
  the server.
* ``GKTServerResNet``: the stages at 32 and 64 planes (the first block of
  each at stride 2) on the received maps, average pool and ``fc``.

NHWC at the public boundary, NCHW inside; flax's paths (``Conv_0``,
``Norm_0/GroupNorm_0``, ``BasicBlock_3/Conv_1``, ``fc``) and layouts."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.norms import Norm
from fedml_tpu_torch.models.resnet import BasicBlock, _conv


class GKTClientResNet(nn.Module):
    """The edge's small net: stem + stage-1 blocks; emits (logits, feature
    maps)."""

    def __init__(self, blocks: int = 3, num_classes: int = 10,
                 norm: str = "group", in_channels: int = 3):
        super().__init__()
        self.blocks, self.num_classes = blocks, num_classes
        self.Conv_0 = _conv(in_channels, 16, 3)
        self.Norm_0 = Norm(16, norm)
        for i in range(blocks):
            setattr(self, f"BasicBlock_{i}", BasicBlock(16, 16, 1, norm))
        self.fc = Dense(16, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        for i in range(self.blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        logits = self.fc(torch.mean(x, dim=(2, 3)))
        return logits, x.permute(0, 2, 3, 1)     # feats [B, H, W, 16]


class GKTServerResNet(nn.Module):
    """The server's large net on received feature maps: stages 2-3 and
    the head."""

    def __init__(self, layers: Sequence[int] = (9, 9), num_classes: int = 10,
                 norm: str = "group", block=BasicBlock,
                 in_channels: int = 16):
        super().__init__()
        n, cin = 0, in_channels
        for planes, n_blocks in zip((32, 64), layers):
            for i in range(n_blocks):
                setattr(self, f"{block.__name__}_{n}",
                        block(cin, planes, 2 if i == 0 else 1, norm))
                cin = planes * block.expansion
                n += 1
        self.n_blocks, self.block_name = n, block.__name__
        self.fc = Dense(cin, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        return self.fc(torch.mean(x, dim=(2, 3)))
