"""LSTM language models (port of ``fedml_tpu/models/rnn.py``).

The cell is flax's ``OptimizedLSTMCell`` written in tensor ops, under
flax's paths and layouts: ``OptimizedLSTMCell_k/{ii,if,ig,io}/kernel``
(``[in, hidden]``, no bias) and ``{hi,hf,hg,ho}/{kernel,bias}``
(``[hidden, hidden]``).  A step is ``i, f, o = sigmoid``, ``g = tanh``
of ``(h @ W_h + b_h) + x @ W_i`` per gate, ``c' = f * c + i * g``,
``h' = o * tanh(c')``, from a zero carry for each batch.  The input
projections of all T steps are one matmul before the step loop.

``nn.LSTM`` (cuDNN's RNN) is not used: its weights are not in flax's
layout, and it has no batching rule under ``torch.func.vmap`` over a
cohort's clients.  Initialisation follows flax's: LeCun-normal input
kernels, orthogonal recurrent kernels, zero biases.

``dtype`` (bf16 mixed precision, the JAX models' field): the embedding,
the cell's two projections and the dense heads compute in it, while the
carry stays f32 as flax's (``initialize_carry`` makes it in the f32
``param_dtype``): ``c' = f * c + i * g`` and ``h' = o * tanh(c')`` promote
to f32, so each cell's output is f32 and the next projection casts it."""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.layers import (Dense, Embed, lecun_normal_,
                                            promote)

GATES = ("i", "f", "g", "o")


class _Kernel(nn.Module):
    """A flax ``DenseParams`` holder: ``kernel`` (and ``bias``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool,
                 recurrent: bool):
        super().__init__()
        self.recurrent = recurrent
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def reset_parameters(self, generator=None) -> None:
        if self.recurrent:
            nn.init.orthogonal_(self.kernel.data, generator=generator)
        else:
            lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        if self.bias is not None:
            self.bias.data.zero_()


class OptimizedLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell(hidden)`` run over a whole sequence:
    ``forward(x [B, T, in]) -> h [B, T, hidden]``."""

    def __init__(self, in_features: int, hidden: int, dtype=None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for gate in GATES:
            setattr(self, f"i{gate}", _Kernel(in_features, hidden, False,
                                              False))
            setattr(self, f"h{gate}", _Kernel(hidden, hidden, True, True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_i = torch.cat([getattr(self, f"i{g}").kernel for g in GATES], -1)
        w_h = torch.cat([getattr(self, f"h{g}").kernel for g in GATES], -1)
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in GATES], -1)
        b, t = x.shape[0], x.shape[1]
        n = self.hidden
        xi = torch.matmul(*promote(self.dtype, x, w_i))  # [B, T, 4n]
        h = x.new_zeros(b, n, dtype=torch.float32)       # the f32 carry
        c = x.new_zeros(b, n, dtype=torch.float32)
        _, w_h, b_h = promote(self.dtype, h, w_h, b_h)
        out = []
        for s in range(t):
            z = (torch.matmul(h.to(w_h.dtype), w_h) + b_h) + xi[:, s]
            i = torch.sigmoid(z[:, :n])
            f = torch.sigmoid(z[:, n:2 * n])
            g = torch.tanh(z[:, 2 * n:3 * n])
            o = torch.sigmoid(z[:, 3 * n:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class RNNOriginalFedAvg(nn.Module):
    """Shakespeare next-char model: embed 8 -> 2 x LSTM 256 -> dense vocab
    at every position (``[B, T, V]``).  820,522 parameters at vocab 90."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, dtype=None):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim, dtype)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim,
                                                     hidden_size, dtype)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden_size,
                                                     hidden_size, dtype)
        self.Dense_0 = Dense(hidden_size, vocab_size, dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.OptimizedLSTMCell_0(self.Embed_0(ids))
        return self.Dense_0(self.OptimizedLSTMCell_1(x))


class RNNStackOverflow(nn.Module):
    """StackOverflow next-word model: embed 96 -> LSTM 670 -> dense 96 ->
    dense ``vocab + 3 + oov`` (10,004) at every position.  4,050,748
    parameters."""

    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670,
                 num_layers: int = 1, dtype=None):
        super().__init__()
        extended = vocab_size + 3 + num_oov_buckets
        self.num_layers = num_layers
        self.Embed_0 = Embed(extended, embedding_size, dtype)
        for k in range(num_layers):
            setattr(self, f"OptimizedLSTMCell_{k}", OptimizedLSTMCell(
                embedding_size if k == 0 else latent_size, latent_size,
                dtype))
        self.Dense_0 = Dense(latent_size, embedding_size, dtype)
        self.Dense_1 = Dense(embedding_size, extended, dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.Embed_0(ids)
        for k in range(self.num_layers):
            x = getattr(self, f"OptimizedLSTMCell_{k}")(x)
        return self.Dense_1(self.Dense_0(x))
