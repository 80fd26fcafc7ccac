"""Vertical-FL party models (port of ``fedml_tpu/models/vfl.py``).

``VFLFeatureExtractor``: Dense + ReLU over a party's feature shard;
``VFLClassifier``: one Dense producing the party's logit contribution;
``VFLPartyNet``: the two composed, one party's whole local stack.  flax's
paths (``VFLFeatureExtractor_0/Dense_0/kernel``, ...) and layouts, as
`models.layers.Dense` keeps them.  flax infers the input width from the
first batch; here it is given."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense


class VFLFeatureExtractor(nn.Module):
    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.Dense_0 = Dense(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Dense_0(x))


class VFLClassifier(nn.Module):
    """The party's logit head; output_dim 1 for the binary tasks."""

    def __init__(self, input_dim: int, output_dim: int = 1):
        super().__init__()
        self.Dense_0 = Dense(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class VFLPartyNet(nn.Module):
    """extractor -> dense head."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int = 1):
        super().__init__()
        self.VFLFeatureExtractor_0 = VFLFeatureExtractor(input_dim,
                                                         hidden_dim)
        self.VFLClassifier_0 = VFLClassifier(hidden_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.VFLClassifier_0(self.VFLFeatureExtractor_0(x))
