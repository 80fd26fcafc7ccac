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
tolerance that costs).

``kind="batch"`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
under ``Norm_k/BatchNorm_0``: ``scale`` and ``bias`` are parameters,
the running ``mean`` and ``var`` buffers (the ``batch_stats`` collection
of a stateful workload, `trainer.workload`).  It normalises with the
running statistics unless a `batch_stats_collector` is open; inside one
(a stateful workload's ``loss_fn``, train mode) it normalises with the
batch's statistics over every row, H and W (padded rows included, as in
flax) and records the new running statistics in the collector instead
of writing its buffers, so that ``torch.func.vmap`` and ``grad`` over
clients see a pure function.  flax's conventions, not
``F.batch_norm``'s: the variance is the biased ``E[x^2] - E[x]^2``
clipped at 0, in the normalisation and in the running ``var`` alike, and
``new = 0.9 * running + 0.1 * batch``.

Mixed precision follows flax 0.12's normalisation layers: statistics are
reduced in f32 (`stats`, the input promoted), the normalisation runs in
f32 (``x - mean`` promotes) and the result is cast once to the promoted
type of (x, scale, bias) (`normalize`); running statistics stay f32.
All-f32 calls of GroupNorm keep ``F.group_norm``."""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

NORM_KINDS = ("group", "batch", "none")

# the open collector of the current thread (each thread has its own)
_COLLECTOR: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_collector", default=None)


@contextlib.contextmanager
def batch_stats_collector():
    """Train mode for the `BatchNorm` layers run inside the block: yields
    a dict that maps each layer run to its new ``(mean, var)``."""
    out = {}
    token = _COLLECTOR.set(out)
    try:
        yield out
    finally:
        _COLLECTOR.reset(token)


def stats(x: torch.Tensor, dims):
    """flax's ``_compute_stats`` (fast variance): the mean and ``E[x^2] -
    E[x]^2`` clipped at 0 over ``dims`` (kept), with ``x`` promoted to at
    least f32."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=dims, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, var


def normalize(x: torch.Tensor, mean, var, eps: float, scale=None,
              bias=None, dtype=None, shape=None) -> torch.Tensor:
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in the statistics' f32 (``scale`` and ``bias`` reshaped to
    ``shape`` when given), cast to ``dtype`` or else to the promoted type
    of (x, scale, bias)."""
    mul = torch.rsqrt(var + eps)
    out = x.dtype
    if scale is not None:
        mul = mul * (scale if shape is None else scale.reshape(shape))
        out = torch.promote_types(out, scale.dtype)
    y = (x - mean) * mul
    if bias is not None:
        y = y + (bias if shape is None else bias.reshape(shape))
        out = torch.promote_types(out, bias.dtype)
    return y.to(dtype or out)


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
        if x.dtype == torch.float32 and (
                self.scale is None or self.scale.dtype == self.bias.dtype
                == torch.float32):
            # contiguous: a CPU conv of a permuted (channels-last) input
            # returns channels-last, and `F.group_norm` under a vmap of
            # one client cannot query that layout
            return F.group_norm(x.contiguous(), self.groups, self.scale,
                                self.bias, self.eps)
        n, c = x.shape[:2]
        xg = x.reshape((n, self.groups, c // self.groups) + x.shape[2:])
        mean, var = stats(xg, tuple(range(2, xg.dim())))
        shape = (1, self.groups, c // self.groups) + (1,) * (x.dim() - 2)
        return normalize(xg, mean, var, self.eps, self.scale, self.bias,
                         shape=shape).reshape(x.shape)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis (1) of NCHW (or
    ``[B, C]``) activations; see the module docstring."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9, zero_init: bool = False,
                 affine: bool = True):
        super().__init__()
        self.eps, self.momentum, self.zero_init = eps, momentum, zero_init
        self.scale = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def reset_parameters(self, generator=None) -> None:
        if self.scale is not None:
            self.scale.data.fill_(0.0 if self.zero_init else 1.0)
            self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        collector = _COLLECTOR.get()
        if collector is None:
            mean, var = self.mean, self.var
        else:
            dims = (0,) + tuple(range(2, x.dim()))
            # reduced in f32 (a bf16 input promoted; an f32 one as it is)
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = torch.mean(xf, dim=dims)
            var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean,
                              min=0.0)
            m = self.momentum
            collector[self] = (m * self.mean + (1.0 - m) * mean,
                               m * self.var + (1.0 - m) * var)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in
        # f32, cast to the promoted type of (x, scale, bias)
        return normalize(x, mean.reshape(shape), var.reshape(shape),
                         self.eps, self.scale, self.bias, shape=shape)


class Norm(nn.Module):
    def __init__(self, channels: int, kind: str = "group",
                 channels_per_group: int = 32, zero_init: bool = False,
                 affine: bool = True):
        super().__init__()
        if kind not in NORM_KINDS:
            raise ValueError(f"unknown norm {kind!r}; have {NORM_KINDS}")
        self.kind = kind
        if kind == "group":
            self.GroupNorm_0 = GroupNorm(
                channels, group_count(channels, channels_per_group),
                zero_init=zero_init, affine=affine)
        elif kind == "batch":
            self.BatchNorm_0 = BatchNorm(channels, zero_init=zero_init,
                                         affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "group":
            return self.GroupNorm_0(x)
        return x if self.kind == "none" else self.BatchNorm_0(x)
