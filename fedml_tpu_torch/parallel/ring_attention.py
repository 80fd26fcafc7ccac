"""Exact causal attention by online softmax (port of the single-device
paths of ``fedml_tpu/parallel/ring_attention.py``).

``full_attention`` is one online-softmax step over the whole key axis;
``blockwise_attention`` walks the keys in blocks with the same (m, l, o)
state, so its scores take O(T * block) memory instead of O(T^2).  Both
keep the JAX file's arithmetic: masked scores are -1e30, a fully masked
block's probabilities are zeroed by ``p * mask``, and the normaliser is
guarded by ``max(l, 1e-30)``.  Layout is ``[B, T, H, d]`` in and out.

``ring_attention`` and the sequence-mesh helpers shard the sequence over
devices; they are refused by name until the model and sequence
parallelism slice (ROADMAP Queue 1 item 14) brings them over
``torch.distributed``."""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def _online_softmax_block(q, k, v, q_pos, kv_pos, m, l, o, causal: bool):
    """Fold one key/value block into the running (m, l, o).

    q [B, Tq, H, d]; k/v [B, Tk, H, d]; positions are global token
    indices.  m, l [B, H, Tq] and o [B, H, Tq, d] are f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
        scores = torch.where(mask, scores, _NEG)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    if causal:
        # a fully masked block has scores == m_new == -1e30, where the exp
        # above is 1: zero those entries explicitly
        p = p * mask
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m_new, l, o


def _init_state(q):
    B, Tq, H, d = q.shape
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Tq, d), dtype=torch.float32, device=q.device)
    return m, l, o


def _finish(l, o):
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def full_attention(q, k, v, q_pos, kv_pos, causal: bool = True
                   ) -> torch.Tensor:
    """Dense attention: one online-softmax block over the whole key axis.
    Returns [B, Tq, H, d] in f32."""
    m, l, o = _init_state(q)
    m, l, o = _online_softmax_block(q, k, v, q_pos, kv_pos, m, l, o, causal)
    return _finish(l, o)


def blockwise_attention(q, k, v, q_pos, kv_pos, block_size: int,
                        causal: bool = True) -> torch.Tensor:
    """Flash-style attention over key/value blocks of ``block_size`` (the
    JAX file's ``lax.scan`` is a loop here; autograd keeps each block's
    scores for the backward).  ``block_size`` must divide the key
    length."""
    Tk = k.shape[1]
    if Tk % block_size:
        raise ValueError(f"block_size {block_size} must divide key length "
                         f"{Tk}")
    m, l, o = _init_state(q)
    for lo in range(0, Tk, block_size):
        hi = lo + block_size
        m, l, o = _online_softmax_block(q, k[:, lo:hi], v[:, lo:hi], q_pos,
                                        kv_pos[lo:hi], m, l, o, causal)
    return _finish(l, o)


_RING_TODO = ("sequence parallelism over a device mesh is not ported yet; "
              "it arrives with parallel/ring_attention.py, sequence.py and "
              "pipeline.py over torch.distributed (ROADMAP Queue 1 item 14)")


def ring_attention(*args, **kwargs):
    """Refused: see ``_RING_TODO``."""
    raise NotImplementedError(f"ring_attention: {_RING_TODO}")


def make_sequence_mesh(*args, **kwargs):
    """Refused: see ``_RING_TODO``."""
    raise NotImplementedError(f"make_sequence_mesh: {_RING_TODO}")


def make_sequence_parallel_apply(*args, **kwargs):
    """Refused: see ``_RING_TODO``."""
    raise NotImplementedError(f"make_sequence_parallel_apply: {_RING_TODO}")
