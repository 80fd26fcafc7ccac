"""Exact causal attention by online softmax (port of
``fedml_tpu/parallel/ring_attention.py``).

``full_attention`` is one online-softmax step over the whole key axis;
``blockwise_attention`` walks the keys in blocks with the same (m, l, o)
state, so its scores take O(T * block) memory instead of O(T^2).  Both
keep the JAX file's arithmetic: masked scores are -1e30, a fully masked
block's probabilities are zeroed by ``p * mask``, and the normaliser is
guarded by ``max(l, 1e-30)``.  Layout is ``[B, T, H, d]`` in and out.

``ring_attention`` shards the sequence over the ranks of a mesh axis
(`parallel.mesh.MeshAxis`, one rank a block of queries): over ``n``
steps the key/value blocks and their global positions travel one rank
forward (`MeshAxis.shift`, a ``batch_isend_irecv`` pair on the axis's
group, whose backward sends the gradient one rank back) and every rank
folds each visiting block into its (m, l, o) state.  The causal ring
visits every block, as the JAX package's does: a fully future block adds
zeros.  ``make_sequence_parallel_apply`` runs a whole `TransformerLM`
that way."""

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


def ring_attention(q, k, v, q_pos, kv_pos, axis,
                   causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence sharded over the mesh axis
    ``axis`` (a `MeshAxis`): ``q`` [B, Tq_local, H, d] and the first
    ``k``, ``v`` [B, Tk_local, H, d] are this rank's blocks, ``q_pos`` and
    ``kv_pos`` their global positions.  Returns [B, Tq_local, H, d] in
    f32.  Every rank of the axis must call it (it is a collective)."""
    n = axis.size
    m, l, o = _init_state(q)
    for s in range(n):
        m, l, o = _online_softmax_block(q, k, v, q_pos, kv_pos, m, l, o,
                                        causal)
        if s != n - 1:
            # k and v travel as one message, their positions beside them
            kv, kv_pos = axis.shift(torch.stack([k, v]), kv_pos)
            k, v = kv[0], kv[1]
    return _finish(l, o)


def local_positions(axis, t_local: int, device) -> torch.Tensor:
    """The global positions of this rank's block of ``t_local`` tokens."""
    return axis.index * t_local + torch.arange(t_local, device=device)


def make_sequence_parallel_apply(model, mesh, axis_name: str = "sequence"):
    """``fn(params, x) -> logits`` running ``model`` (a `TransformerLM`)
    with its sequence sharded over ``mesh``'s ``axis_name``: each rank
    takes its block of the [B, T] tokens (T must divide over the axis),
    computes its global positions and attends by the ring.  Returns this
    rank's block of the logits, [B, T / n, V] (the JAX package returns
    them sharded the same way)."""
    from torch.func import functional_call

    from fedml_tpu_torch.trainer.workload import _module_names
    axis = mesh.axis(axis_name)

    def fn(params, x):
        t = x.shape[1]
        if t % axis.size:
            raise ValueError(f"sequence length {t} not divisible by the "
                             f"mesh {axis_name} axis ({axis.size})")
        t_local = t // axis.size
        x = x[:, axis.index * t_local:(axis.index + 1) * t_local].to(
            mesh.device)
        pos = local_positions(axis, t_local, mesh.device)
        return functional_call(
            model, _module_names({k: v.to(mesh.device)
                                  for k, v in params.items()}),
            (x,), {"positions": pos, "ring_axis": axis})

    return fn


def make_sequence_mesh(n_devices=None, axis_name: str = "sequence",
                       device=None):
    """A one-axis mesh of ``n_devices`` ranks (default: the world's) for
    ring attention."""
    from fedml_tpu_torch.parallel.mesh import Mesh, _check_world, _n_devices
    n = n_devices or _n_devices(None)
    _check_world((n,), n)
    return Mesh({axis_name: n}, device=device)
