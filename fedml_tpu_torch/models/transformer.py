"""Decoder-only transformer LM (port of ``fedml_tpu/models/transformer.py``).

Pre-LN blocks (LN -> causal MHA -> residual, LN -> GELU MLP -> residual),
learned positional embeddings, final LN -> vocab head; ``[B, T]`` tokens in,
``[B, T, V]`` per-position logits out (the NWP workload's contract).

Parameters keep flax's auto-names and layouts, so weights carry across by
renaming: ``tok_embed/embedding``, ``pos_embed/embedding``,
``attn_{i}/{query,key,value,out}/{kernel,bias}``, ``LayerNorm_{0..2L}``
(block i owns ``2i`` and ``2i+1``, the final norm is ``2L``),
``Dense_{0..2L-1}`` (block i owns ``2i`` and ``2i+1``) and
``lm_head/{kernel,bias}``.  With ``moe_experts`` > 0 block i's MLP is the
Switch MoE FFN ``moe_{i}`` (`models.moe`: ``router/{kernel,bias}``,
``w1``, ``b1``, ``w2``, ``b2``) and there are no ``Dense_*``; it routes
the positions whose token is not ``pad_id``, and its load-balance terms
come back from ``forward(..., moe_aux=True)`` as ``(logits, sum over
layers)``, which the NWP workload adds to its training loss at
``moe_aux_weight``.

``dtype`` (bf16 mixed precision, as the JAX module's): the embeddings,
every Dense, the LayerNorms' outputs and the attention's output
(``out.astype(x.dtype)``) compute in it; the attention runs on its
q, k, v (the flash kernel's bf16 path under bf16) and the MoE router in
f32.

Attention takes the JAX module's branches in its order: the flash kernel
(``use_flash``, K4 in ``models/flash_attention.py``), then ``block_size``,
then blockwise above ``auto_block_len`` (``_auto_block``), then dense.
``ring_axis`` (a `parallel.mesh.MeshAxis`) comes before all of them:
the sequence is sharded over that axis's ranks, ``positions`` are the
rank's global ones, and attention runs as the exact ring
(`parallel.ring_attention.ring_attention`).

Incremental decode (the serving step, `serve/decode.py`): with ``cache``
(from `init_decode_cache`, JAX's layout ``{"attn_i": {"k", "v"}}``, each
``[slots, cache_len, H, d]``) and per-slot ``positions``, the input is
one token per slot and the call returns ``(logits [B, V], cache)``.  Each
layer writes its k and v at the slot's position and attends the single
query against the whole cache with the JAX module's math: f32 scores,
the ``kv_idx <= position`` mask at -1e30 (a reused slot never reads its
previous occupant's rows), an f32 softmax, einsums rather than SDPA
(XLA's einsums in the JAX package, no Pallas).  The write lands IN PLACE
in the given cache tensors, which come back as the same dict: a
CUDA-graph capture of the step replays over static buffers.  ``positions``
must lie in ``[0, cache_len)``.
``dropout_rate`` drops after each attention and MLP in train mode (a
``dropout_key``, the workload's dropout seam; not flax's masks).

``tp_axis`` (a `parallel.mesh.MeshAxis`): the parameters are this rank's
blocks of a placement over that axis (`parallel.mesh.tp_shard_params` or
`parallel.expert.ep_shard_params`), and every layer computes on what it
holds: the embeddings and each Dense sharded on its output dim are
column-parallel (gathered), the attention is head-parallel on the rank's
H/n heads (flash, ``block_size`` or dense over them) with a row-parallel
out-projection (one sum over the axis a block), and each MoE layer runs
the rank's E/n experts (`models.moe.SwitchFFN`).  A layout no layer
computes on raises ``NotImplementedError``."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.flash_attention import flash_attention
from fedml_tpu_torch.models.layers import (Dense, DenseGeneral, Embed,
                                            LayerNorm, dropout)
from fedml_tpu_torch.models.moe import SwitchFFN
from fedml_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                     full_attention,
                                                     ring_attention)

def _auto_block(t: int, threshold: int, max_block: int = 512,
                min_block: int = 64) -> Optional[int]:
    """Largest kv-block size in [min_block, max_block] dividing ``t``, or
    None when ``t <= threshold`` or no such divisor exists."""
    if t <= threshold:
        return None
    for b in range(min(max_block, t), min_block - 1, -1):
        if t % b == 0:
            return b
    return None


class CausalSelfAttention(nn.Module):
    def __init__(self, n_heads: int, d_model: int,
                 block_size: Optional[int] = None, use_flash: bool = False,
                 auto_block_len: int = 1024, dtype=None):
        super().__init__()
        d_head = d_model // n_heads
        self.block_size = block_size
        self.use_flash = use_flash
        self.auto_block_len = auto_block_len
        self.query = DenseGeneral((d_model,), (n_heads, d_head), dtype)
        self.key = DenseGeneral((d_model,), (n_heads, d_head), dtype)
        self.value = DenseGeneral((d_model,), (n_heads, d_head), dtype)
        self.out = DenseGeneral((n_heads, d_head), (d_model,), dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict] = None,
                ring_axis=None, tp_axis=None) -> torch.Tensor:
        heads = tp_axis is not None \
            and self.query.kernel.shape[1] != self.query.out_shape[0]
        if heads and (cache is not None or ring_axis is not None):
            raise NotImplementedError(
                "head-parallel attention composes with neither decode "
                "(cache=) nor the ring (ring_axis=)")
        # q, k and v from the rank's heads: x copied to the axis once
        ax = tp_axis if heads else None
        xi = tp_axis.copy(x) if heads else x
        q, k, v = self.query(xi, ax), self.key(xi, ax), self.value(xi, ax)
        t = x.shape[1]
        if cache is not None:
            out = _decode_attention(q, k, v, positions, cache)
        elif ring_axis is not None:
            out = ring_attention(q, k, v, positions, positions, ring_axis)
        elif self.use_flash:
            out = flash_attention(q, k, v)
        elif self.block_size is not None:
            out = blockwise_attention(q, k, v, positions, positions,
                                      self.block_size)
        elif (blk := _auto_block(t, self.auto_block_len)) is not None:
            out = blockwise_attention(q, k, v, positions, positions, blk)
        else:
            out = full_attention(q, k, v, positions, positions)
        return self.out(out.to(x.dtype), ax)


def _decode_attention(q, k, v, positions, cache):
    """One query a slot (``q, k, v`` [B, 1, H, d]) against the slot's
    cache rows up to its position, after writing this token's k and v at
    that position (in place)."""
    k_cache, v_cache = cache["k"], cache["v"]          # [B, Tc, H, d]
    slots = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[slots, positions] = k[:, 0].to(k_cache.dtype)
    v_cache[slots, positions] = v[:, 0].to(v_cache.dtype)
    tc = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    mask = (torch.arange(tc, device=q.device)[None, None, None, :]
            <= positions[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())


def init_decode_cache(model: "TransformerLM", slots: int, cache_len: int,
                      dtype=torch.float32, device="cpu") -> dict:
    """A fresh per-layer KV cache for incremental decode: one
    ``{"attn_i": {"k", "v"}}`` entry per layer, each ``[slots, cache_len,
    n_heads, d_head]`` of zeros (the ``kv_idx <= position`` mask never
    reads a row the slot's own steps have not written)."""
    if cache_len > model.max_len:
        raise ValueError(
            f"cache_len {cache_len} exceeds the model's max_len "
            f"{model.max_len}: the positional embedding table has no row "
            f"for those positions; shrink the cache or grow max_len")
    shape = (slots, cache_len, model.n_heads, model.d_model // model.n_heads)
    return {f"attn_{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(model.n_layers)}


class TransformerLM(nn.Module):
    """Per-position next-token logits, causal; flax's defaults (d_model
    128, 4 heads, 2 layers, d_ff 512, max_len 2048, the Switch paper's
    capacity factor 1.25 and alpha 0.01)."""

    computes_on_shards = True

    def __init__(self, vocab_size: int, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 512, max_len: int = 2048,
                 dropout_rate: float = 0.0, dtype=None,
                 block_size: Optional[int] = None,
                 use_flash: bool = False, auto_block_len: int = 1024,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01, pad_id: int = 0):
        super().__init__()
        self.moe_experts = moe_experts
        self.moe_aux_weight = moe_aux_weight
        self.pad_id = pad_id
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.d_model = d_model
        self.max_len = max_len
        self.dropout_rate = float(dropout_rate)
        # dropout after the attention and the MLP of every layer, in train
        # mode (a ``dropout_key``), through the dropout seam
        self.stochastic = self.dropout_rate > 0
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        for i in range(n_layers):
            setattr(self, f"attn_{i}", CausalSelfAttention(
                n_heads, d_model, block_size=block_size, use_flash=use_flash,
                auto_block_len=auto_block_len, dtype=dtype))
            setattr(self, f"LayerNorm_{2 * i}", LayerNorm(d_model,
                                                           dtype=dtype))
            setattr(self, f"LayerNorm_{2 * i + 1}", LayerNorm(d_model,
                                                               dtype=dtype))
            if moe_experts:
                setattr(self, f"moe_{i}", SwitchFFN(
                    moe_experts, d_model, d_ff,
                    capacity_factor=moe_capacity_factor, dtype=dtype))
            else:
                setattr(self, f"Dense_{2 * i}", Dense(d_model, d_ff, dtype))
                setattr(self, f"Dense_{2 * i + 1}", Dense(d_ff, d_model,
                                                          dtype))
        setattr(self, f"LayerNorm_{2 * n_layers}", LayerNorm(d_model,
                                                             dtype=dtype))
        self.lm_head = Dense(d_model, vocab_size, dtype)

    def forward(self, input_seq: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                ring_axis=None, cache=None,
                dropout_key: Optional[torch.Tensor] = None,
                moe_aux: bool = False, tp_axis=None):
        if cache is not None:
            if tp_axis is not None:
                raise NotImplementedError(
                    "decode (cache=) runs on one device's whole tree; "
                    "tp_axis does not compose with it")
            return self._decode(input_seq, positions, ring_axis, cache)
        t = input_seq.shape[1]
        if positions is None:
            positions = torch.arange(t, device=input_seq.device)
        x = self.tok_embed(input_seq, tp_axis) \
            + self.pos_embed(positions, tp_axis)[None]
        load_balance = []
        for i in range(self.n_layers):
            h = getattr(self, f"LayerNorm_{2 * i}")(x)
            h = getattr(self, f"attn_{i}")(h, positions, ring_axis=ring_axis,
                                           tp_axis=tp_axis)
            x = x + dropout(h, self.dropout_rate, dropout_key, 2 * i)
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
            if self.moe_experts:
                h, lb = getattr(self, f"moe_{i}")(
                    h, mask=input_seq != self.pad_id, ep_axis=tp_axis)
                load_balance.append(lb)
            else:
                h = F.gelu(getattr(self, f"Dense_{2 * i}")(h, tp_axis),
                           approximate="tanh")
                h = getattr(self, f"Dense_{2 * i + 1}")(h, tp_axis)
            x = x + dropout(h, self.dropout_rate, dropout_key, 2 * i + 1)
        x = getattr(self, f"LayerNorm_{2 * self.n_layers}")(x)
        logits = self.lm_head(x, tp_axis)
        if moe_aux:
            # Switch eq. 4: each layer's term sums into the loss
            return logits, sum(load_balance, 0.0)
        return logits

    def _decode(self, input_seq, positions, ring_axis, cache):
        """One token a slot (``input_seq`` [B], ``positions`` [B]) through
        the per-layer caches; ``(logits [B, V], cache)``, the cache written
        in place.  Dropout is off, as in the JAX module's decode."""
        if positions is None:
            raise ValueError(
                "decode (cache=) needs per-slot positions: each slot sits "
                "at its own sequence index")
        if ring_axis is not None:
            raise ValueError(
                "decode (cache=) is single-chip attention over the kv "
                "cache; ring_axis does not compose with it")
        tokens = input_seq.reshape(-1)
        x = (self.tok_embed(tokens) + self.pos_embed(positions))[:, None, :]
        for i in range(self.n_layers):
            h = getattr(self, f"LayerNorm_{2 * i}")(x)
            x = x + getattr(self, f"attn_{i}")(h, positions,
                                               cache=cache[f"attn_{i}"])
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
            if self.moe_experts:
                h, _ = getattr(self, f"moe_{i}")(
                    h, mask=tokens[:, None] != self.pad_id)
            else:
                h = F.gelu(getattr(self, f"Dense_{2 * i}")(h),
                           approximate="tanh")
                h = getattr(self, f"Dense_{2 * i + 1}")(h)
            x = x + h
        x = getattr(self, f"LayerNorm_{2 * self.n_layers}")(x)
        return self.lm_head(x)[:, 0, :], cache
