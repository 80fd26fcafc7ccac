"""Channel norms (port of ``fedml_tpu/models/norms.py``).

``Norm(kind="group")`` is flax's ``nn.GroupNorm`` under flax's path
(``Norm_k/GroupNorm_0/{scale,bias}``): ``channels // channels_per_group``
groups (at least 1), decremented until they divide the channels, epsilon
1e-5, over NCHW activations (a group is a contiguous run of channels, as
flax's over NHWC).  ``kind="none"`` is the identity with no parameters.
``zero_init`` starts the scale at 0 (the last norm of each residual
block, so a block starts as the identity).

flax computes a group's variance as ``E[x^2] - E[x]^2``; this module
uses ``F.group_norm``, which subtracts the mean first.  The two differ by
the cancellation in flax's form (tests/test_torch_resnet.py states the
tolerance that costs).  ``kind="batch"`` (BatchNorm's running statistics,
``Workload.stateful``) is not ported: it is refused by name."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NORM_KINDS = ("group", "none")


def group_count(channels: int, channels_per_group: int) -> int:
    groups = max(1, channels // channels_per_group)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float = 1e-5,
                 zero_init: bool = False, affine: bool = True):
        super().__init__()
        self.groups, self.eps, self.zero_init = groups, eps, zero_init
        self.scale = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def reset_parameters(self, generator=None) -> None:
        if self.scale is not None:
            self.scale.data.fill_(0.0 if self.zero_init else 1.0)
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.scale, self.bias, self.eps)


class Norm(nn.Module):
    def __init__(self, channels: int, kind: str = "group",
                 channels_per_group: int = 32, zero_init: bool = False,
                 affine: bool = True):
        super().__init__()
        if kind == "batch":
            raise NotImplementedError(
                "norm='batch' is not ported: BatchNorm's running statistics "
                "need the stateful workload (Workload.stateful, ROADMAP "
                "Queue 1 item 10); the ResNets default to GroupNorm")
        if kind not in NORM_KINDS:
            raise ValueError(f"unknown norm {kind!r}; have {NORM_KINDS} "
                             f"(and 'batch', not ported)")
        self.kind = kind
        if kind == "group":
            self.GroupNorm_0 = GroupNorm(
                channels, group_count(channels, channels_per_group),
                zero_init=zero_init, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kind == "none" else self.GroupNorm_0(x)
