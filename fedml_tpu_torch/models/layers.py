"""Dense, conv, attention-projection, norm and embedding layers that keep
flax's parameter layout, flax's ``SAME`` padding, and the dropout masks
of the port's dropout seam.

A conv kernel is stored HWIO and a dense kernel ``[in, out]``, as flax
stores them, and permuted at use.  Keeping the layout makes weights carry
across the two packages by renaming alone, and keeps each element's index
within a leaf equal on both sides, which the fused aggregate's noise
stream is keyed by.  Initialisation follows flax's defaults: LeCun-normal
kernels (truncated normal, variance 1 / fan_in) and zero biases; the
ResNets' convs take ``init="fan_out"`` (truncated normal, variance 2 /
fan_out, flax's ``variance_scaling(2.0, "fan_out", "truncated_normal")``).

flax's ``padding="SAME"`` gives ``ceil(n / stride)`` outputs and pads
``total = (out - 1) * stride + k - n``, the smaller half before and the
larger after: asymmetric at stride 2 (a 7x7 stride-2 conv on 32 pads (2,
3), a 3x3 one on 16 pads (0, 1)), where torch's ``padding=k // 2`` is
symmetric.  `same_pads` computes flax's pads and the layers apply them
with ``F.pad`` when they are not symmetric.

Tensor parallelism: given a ``tp_axis`` (`parallel.mesh.MeshAxis`), a
layer whose leaves are this rank's blocks (`parallel.mesh.Placement`, the
JAX package's ``tp_shard_params`` rule) computes on them.  The layer reads
the placement from its leaves' shapes against its whole ones; a layout it
does not compute on raises ``NotImplementedError``, never runs
replicated in silence.  ``Dense`` sharded on its output dim is
column-parallel (input copied to the axis, the rank's columns, gathered,
the replicated bias added after the gather, where its gradient is whole);
``Embed`` sharded on its features looks up its columns and gathers;
``DenseGeneral`` is the attention's head-parallel pair (see its
docstring).

Mixed precision follows flax's ``promote_dtype``: a layer with a
``dtype`` casts its input and parameters to it; without one, tensors of
mixed float types meet in their promoted type (an all-f32 call casts
nothing).  LayerNorm follows flax's normalisation order under bf16 (see
`norms.normalize`)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.murmur import M32, fmix, index_hash, mul32
from fedml_tpu_torch.models.norms import normalize, stats

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def promote(dtype, *xs):
    """flax's ``promote_dtype(*xs, dtype=dtype)``: every tensor (None kept)
    cast to ``dtype``, or without one to the promoted type of them all; a
    tensor already of that type is returned as it is."""
    present = [x for x in xs if x is not None]
    if dtype is None:
        dtype = present[0].dtype
        for x in present[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
    return tuple(x if x is None or x.dtype == dtype else x.to(dtype)
                 for x in xs)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _unported(layer: str, leaf: str, shape, whole) -> NotImplementedError:
    from fedml_tpu_torch.parallel.mesh import TP_UNPORTED
    return NotImplementedError(
        f"{layer}: {leaf} is a block {tuple(shape)} of {tuple(whole)} in a "
        f"layout this layer does not compute on ({TP_UNPORTED})")


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.in_features, self.out_features = in_features, out_features
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
        x, kernel, bias = promote(self.dtype, x, self.kernel, self.bias)
        whole = (self.in_features, self.out_features)
        if tp_axis is None or tuple(kernel.shape) == whole:
            return x @ kernel + bias
        if (kernel.shape[0] != whole[0]
                or kernel.shape[1] * tp_axis.size != whole[1]
                or bias.shape[0] != whole[1]):
            raise _unported("Dense", "kernel/bias", kernel.shape, whole)
        return tp_axis.gather(tp_axis.copy(x) @ kernel) + bias


def same_pads(n: int, k: int, stride: int):
    """flax's ``SAME`` pads (before, after) of one spatial axis of size
    ``n`` for a window ``k`` at ``stride``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` (NCHW) and the symmetric padding left for the op: flax's
    ``SAME`` pads, applied with ``F.pad`` when they are asymmetric."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[-2], k, stride),
                          same_pads(x.shape[-1], k, stride))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), (stride, stride), padding="SAME")`` on
    NCHW: pads hold -inf."""
    x, pad = pad_same(x, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=pad)


class Conv2d(nn.Module):
    """NCHW activations, HWIO kernel; flax's ``SAME`` (the default) or
    ``VALID`` padding at any stride; ``use_bias``, ``groups`` (flax's
    ``feature_group_count``: the kernel is ``[k, k, in / groups, out]``)
    and the init as flax's ``nn.Conv`` arguments."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: str = "SAME",
                 use_bias: bool = True, init: str = "lecun",
                 groups: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID") or init not in ("lecun",
                                                             "fan_out"):
            raise ValueError(f"padding SAME|VALID and init lecun|fan_out, "
                             f"got {padding!r}, {init!r}")
        k = kernel_size
        self.k, self.stride, self.init = k, stride, init
        self.groups = groups
        self.same = padding == "SAME"
        self.kernel = nn.Parameter(torch.empty(k, k, in_channels // groups,
                                               out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def reset_parameters(self, generator=None) -> None:
        h, w, cin, cout = self.kernel.shape
        if self.init == "lecun":
            lecun_normal_(self.kernel.data, h * w * cin, generator)
        else:
            std = math.sqrt(2.0 / (h * w * cout)) / _TRUNC_STD
            nn.init.trunc_normal_(self.kernel.data, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.same:
            x, pad = pad_same(x, self.k, self.stride)
        x, kernel, bias = promote(None, x, self.kernel, self.bias)
        return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias,
                        stride=self.stride, padding=pad, groups=self.groups)


def dropout(x: torch.Tensor, rate: float, key: Optional[torch.Tensor],
            layer: int) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: ``x / keep`` where the mask keeps an
    element, else 0; the identity without a ``key`` (eval mode).

    The mask is a counter hash, so that it is a function of tensors
    alone and ``vmap`` maps it over a cohort's keys: a salt hashed from
    the key's two words and the ``layer`` index, and per element
    ``fmix(index_hash(i) ^ salt) < keep * 2^32``.  The masks are not
    flax's (flax keys each ``Dropout`` through ``make_rng`` with the
    module path folded in), only their law is."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    salt = fmix(fmix(key[0] ^ mul32(layer + 1, 0x9E3779B9)) ^ key[1]) & M32
    bits = fmix(index_hash(x.numel(), x.device) ^ salt)
    mask = (bits < int(keep * 2.0 ** 32)).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` in the two forms the transformer uses.

    ``in_features -> out_shape``: kernel ``[in, *out_shape]``, bias
    ``out_shape`` (the attention's query/key/value, ``[d_model, H,
    d_head]``).  ``in_shape -> out_features`` with ``contract=len(in_shape)``
    trailing input axes: kernel ``[*in_shape, out]``, bias ``[out]`` (the
    attention's ``out``, ``[H, d_head, d_model]``).  flax initialises the
    kernel LeCun-normal over the flattened contracted axes."""

    def __init__(self, in_shape, out_shape, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel.data, math.prod(self.in_shape), generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
        """``tp_axis`` with the heads sharded (the attention's pair under
        the JAX rule): an in-projection ``[d, H/n, dh]`` gives the rank's
        heads (the caller copies ``x`` to the axis once for q, k and v;
        the bias ``[H, dh]`` stays replicated and the rank adds its heads'
        rows); the out-projection ``[H/n, dh, d]`` is row-parallel, its
        partial products summed over the axis, the bias added once
        after."""
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        x, kernel, bias = promote(self.dtype, x, self.kernel, self.bias)
        whole = self.in_shape + self.out_shape
        if tp_axis is not None and tuple(kernel.shape) != whole:
            return self._on_heads(x, kernel, bias, lead, tp_axis)
        w = kernel.reshape(math.prod(self.in_shape),
                           math.prod(self.out_shape))
        y = x.reshape(lead + (-1,)) @ w
        return y.reshape(lead + self.out_shape) + bias

    def _on_heads(self, x, kernel, bias, lead, tp_axis):
        whole = self.in_shape + self.out_shape
        in_proj = len(self.in_shape) == 1 and len(self.out_shape) == 2
        out_proj = len(self.in_shape) == 2 and len(self.out_shape) == 1
        dim = 1 if in_proj else 0
        ok = ((in_proj or out_proj)
              and kernel.dim() == 3
              and kernel.shape[dim] * tp_axis.size == whole[dim]
              and all(kernel.shape[i] == whole[i]
                      for i in range(3) if i != dim)
              and tuple(bias.shape) == tuple(self.out_shape))
        if not ok:
            raise _unported("DenseGeneral", "kernel", kernel.shape, whole)
        heads = kernel.shape[dim]
        if in_proj:
            w = kernel.reshape(whole[0], heads * whole[2])
            y = (x.reshape(lead + (-1,)) @ w).reshape(
                lead + (heads, whole[2]))
            return y + tp_axis.slice(bias, 0, heads)
        w = kernel.reshape(heads * whole[1], whole[2])
        y = x.reshape(lead + (-1,)) @ w
        return tp_axis.reduce(y) + bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: ``scale`` and ``bias`` over the last axis,
    epsilon 1e-6 (flax's default, not torch's 1e-5).  All-f32 calls run
    ``F.layer_norm``; a bf16 input, parameters or ``dtype`` take flax's
    order (`norms.normalize`)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None and x.dtype == self.scale.dtype \
                == self.bias.dtype == torch.float32:
            return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias,
                                self.eps)
        mean, var = stats(x, (-1,))
        return normalize(x, mean, var, self.eps, self.scale, self.bias,
                         self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is named ``embedding``, ``[num,
    features]``, drawn N(0, 1 / features) (flax's variance scaling with
    an untruncated normal)."""

    def __init__(self, num_embeddings: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.num_embeddings, self.features = num_embeddings, features
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.embedding.data, 0.0,
                        math.sqrt(1.0 / self.embedding.shape[1]),
                        generator=generator)

    def forward(self, ids: torch.Tensor, tp_axis=None) -> torch.Tensor:
        table = self.embedding if self.dtype is None \
            else self.embedding.to(self.dtype)
        if tp_axis is None or table.shape[1] == self.features:
            return F.embedding(ids.long(), table)
        if (table.shape[0] != self.num_embeddings
                or table.shape[1] * tp_axis.size != self.features):
            raise _unported("Embed", "embedding", table.shape,
                            (self.num_embeddings, self.features))
        return tp_axis.gather(F.embedding(ids.long(), table))
