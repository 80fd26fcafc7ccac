"""Switch-style mixture-of-experts FFN (port of ``fedml_tpu/models/moe.py``).

Top-1 routing (Fedus et al. 2021) within fixed-size token groups: an f32
router, capacity-bounded dispatch (a token over its expert's capacity is
dropped and rides the residual connection), and the load-balancing loss
``E * sum_e f_e * P_e`` over the real tokens only (``mask``: pads and
zeroed batch rows are kept out of dispatch and of the statistics; their
output is 0).  The dispatch tensor is ``[G, g, E, C]`` with ``C =
ceil(cf * g / E)``; experts are dense einsums over the explicit ``[E,
...]`` tables ``w1 [E, d, d_ff]``, ``b1``, ``w2 [E, d_ff, d]``, ``b2``
(flax's names and layout, so weights carry across by renaming).

Everything is static-shaped and free of host syncs, so ``torch.func``'s
``vmap(grad)`` and a CUDA-graph capture take it: argmax, cumsum and
one-hots built as ``idx[..., None] == arange(n)`` (``F.one_hot`` raises on
an index out of range and has no batching rule; a position past the
capacity must give an all-zero row, which is the drop).  The balance loss
is returned, not stored: ``forward`` gives ``(y, load_balance)``.  The
JAX package uses no Pallas kernel here (XLA's einsums), so neither does
the port.

Expert parallelism (``ep_axis``, `parallel.expert.ep_shard_params`): the
rank holds ``E/n`` experts' tables, the router whole.  Routing, dispatch,
capacity, drops and the balance loss come from every token, as in one
process; the rank runs its experts' einsums over its slice of the
dispatch tensor and combines their share, and one sum over the axis joins
the shares (its backward the identity).  The experts' input and the
combine weights are copied to the axis (their gradients summed over it),
so the router's and the input's gradients are whole on every rank, the
balance loss's counted once."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, _TRUNC_STD


def _auto_group(n_tok: int, target: int = 512, min_group: int = 64) -> int:
    """Largest divisor of ``n_tok`` in [min_group, target], else n_tok."""
    for g in range(min(target, n_tok), min_group - 1, -1):
        if n_tok % g == 0:
            return g
    return n_tok


def capacity(capacity_factor: float, group: int, experts: int) -> int:
    """Each expert's buffer in a group: ``max(1, ceil(cf * g / E))``,
    computed as the JAX package does (a float floor division)."""
    return max(1, int(-(-capacity_factor * group // experts)))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; all zero outside
    ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


class SwitchFFN(nn.Module):
    """Top-1 MoE FFN: ``[B, T, D] -> ([B, T, D], load_balance)`` with
    ``n_experts`` experts.  ``group_size=0`` picks the largest divisor of
    B*T up to 512; ``dtype`` is the experts' compute dtype (the router
    always runs f32)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int,
                 capacity_factor: float = 1.25, group_size: int = 0,
                 dtype=None):
        super().__init__()
        self.n_experts, self.d_model, self.d_ff = n_experts, d_model, d_ff
        self.capacity_factor = capacity_factor
        self.group_size = group_size
        self.dtype = dtype
        self.router = Dense(d_model, n_experts, dtype=torch.float32)
        self.w1 = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.b1 = nn.Parameter(torch.zeros(n_experts, d_ff))
        self.w2 = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.b2 = nn.Parameter(torch.zeros(n_experts, d_model))

    def reset_parameters(self, generator=None) -> None:
        # flax's lecun_normal over [E, in, out]: fan_in = in x E (the
        # leading axis counts as receptive field)
        for w in (self.w1, self.w2):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / _TRUNC_STD
            nn.init.trunc_normal_(w.data, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        self.b1.data.zero_()
        self.b2.data.zero_()

    def _route(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Top-1 routing in f32, pads excluded: the grouped tokens
        ``[G, g, D]``, the real-token mask ``[G, g]``, the router's
        probabilities ``[G, g, E]``, the one-hot choice ``[G, g, E]``
        (zero on pads), each token's position in its expert's buffer
        ``[G, g]`` and the capacity."""
        b, t, d = x.shape
        n_tok, e = b * t, self.n_experts
        g = self.group_size or _auto_group(n_tok)
        if n_tok % g:
            raise ValueError(f"group_size {g} must divide B*T = {n_tok}")
        n_groups = n_tok // g
        xt = x.reshape(n_groups, g, d)
        m = (torch.ones(n_groups, g, device=x.device) if mask is None
             else mask.reshape(n_groups, g).to(torch.float32))
        probs = torch.softmax(self.router(xt.to(torch.float32)), dim=-1)
        oh = _one_hot(torch.argmax(probs, dim=-1), e) * m[:, :, None]
        pos = torch.cumsum(oh, dim=1) - 1.0
        pos_in_e = torch.sum(pos * oh, dim=-1).to(torch.int32)
        return xt, m, probs, oh, pos_in_e, capacity(self.capacity_factor,
                                                    g, e)

    def _experts(self, ep_axis):
        """The expert tables as this rank holds them, their first expert's
        index, and whether they are a block of the whole."""
        tables = (self.w1, self.b1, self.w2, self.b2)
        local = tables[0].shape[0]
        if ep_axis is None or local == self.n_experts:
            return tables, 0, False
        if (any(t.shape[0] != local for t in tables)
                or local * ep_axis.size != self.n_experts
                or self.router.kernel.shape[1] != self.n_experts):
            from fedml_tpu_torch.parallel.mesh import TP_UNPORTED
            raise NotImplementedError(
                f"SwitchFFN: expert tables of {[t.shape[0] for t in tables]}"
                f" rows and a router of {self.router.kernel.shape[1]} "
                f"columns are not the ep layout ({self.n_experts} experts, "
                f"{ep_axis.size} ranks; {TP_UNPORTED})")
        return tables, ep_axis.index * local, True

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ep_axis=None):
        e = self.n_experts
        (w1, b1, w2, b2), lo, sharded = self._experts(ep_axis)
        xt, m, probs, oh, pos_in_e, cap = self._route(x, mask)
        gate = torch.amax(probs, dim=-1) * m                     # [G, g]

        # load balance (Switch eq. 4) over the real tokens
        denom = torch.clamp(torch.sum(m), min=1.0)
        f_frac = torch.sum(oh, dim=(0, 1)) / denom
        p_mean = torch.sum(probs * m[:, :, None], dim=(0, 1)) / denom
        load_balance = e * torch.sum(f_frac * p_mean)

        # capacity-bounded dispatch [G, g, E, C]: a position past the
        # capacity one-hots to zeros, which is the drop
        disp = oh[..., None] * _one_hot(pos_in_e, cap)[:, :, None, :]

        dt = self.dtype or x.dtype
        # combine weights, gate-weighted; dropped and pad tokens get 0
        comb = (disp * gate[..., None, None]).to(dt)
        if sharded:
            n_loc = w1.shape[0]
            disp = disp[:, :, lo:lo + n_loc]
            comb = ep_axis.slice(comb, 2, n_loc)
            xt = ep_axis.copy(xt)
        xe = torch.einsum("gnec,gnd->gecd", disp.to(dt), xt.to(dt))
        h = torch.einsum("gecd,edf->gecf", xe, w1.to(dt)) \
            + b1.to(dt)[None, :, None, :]
        h = F.gelu(h, approximate="tanh")
        ye = torch.einsum("gecf,efd->gecd", h, w2.to(dt)) \
            + b2.to(dt)[None, :, None, :]
        yt = torch.einsum("gnec,gecd->gnd", comb, ye)
        if sharded:
            yt = ep_axis.reduce(yt)
        return yt.reshape(x.shape).to(x.dtype), load_balance

    def dropped(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """How many real tokens of ``x`` [B, T, D] the routing drops over
        capacity (a device scalar: no host sync)."""
        _, m, _, _, pos_in_e, cap = self._route(x, mask)
        return torch.sum((pos_in_e >= cap).to(torch.float32) * m)
