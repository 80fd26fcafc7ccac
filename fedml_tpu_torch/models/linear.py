"""Logistic regression (port of ``fedml_tpu/models/linear.py``).

As in the reference, a sigmoid is applied to the linear output and the
result is used as the logits of the cross-entropy.  ``tp_axis``: the
kernel's output dim may be sharded over that axis (`parallel.mesh.
tp_shard_params`; column-parallel `layers.Dense`)."""

import torch
from torch import nn

from fedml_tpu_torch.models.layers import Dense


class LogisticRegression(nn.Module):
    computes_on_shards = True

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.Dense_0 = Dense(input_dim, output_dim)

    def forward(self, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
        return torch.sigmoid(self.Dense_0(x.reshape(x.shape[0], -1),
                                          tp_axis=tp_axis))
