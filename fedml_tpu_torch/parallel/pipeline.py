"""Pipeline parallelism: GPipe over a transformer's block stack (port of
``fedml_tpu/parallel/pipeline.py``).

`PipelineLM` is a decoder-only LM whose blocks are one stacked tree:
``embed/...``, ``blocks/...`` (every leaf with a leading ``[L, ...]``
layer axis) and ``final/...``, flat keys under flax's names.  Optimizers,
aggregation and the wire see only that tree; no pipeline layout reaches
them.

The JAX package's stage mesh is ``jax.devices()[:S]`` of the one process
in which its silos run as threads; the port's silos are threads of one
process too, so a stage is a torch device of that process
(`make_stage_mesh`).  Stage ``s`` runs layers ``s·L/S .. (s+1)·L/S - 1``:
its slice of each block leaf is moved to its device at the call, and the
activations (with the pad mask, which MoE routing needs) hand off with
``.to(next stage's device)``.  Autograd carries the gradient back through
the stages.  The schedule is GPipe's fill, steady state and drain over
``n_micro + S - 1`` steps: at step ``t`` stage ``s`` runs microbatch ``t -
s`` when it lies in ``[0, n_micro)`` and idles in the bubble otherwise.
On separate cards the stages of one step run at once (each card's
launches are asynchronous); on one card they run one after another.

With fewer cards than stages the stages share the cards round robin (on
one H100 every stage sits on ``cuda:0``), where the JAX package refuses:
the same reason as ranks sharing a card over gloo.  The Switch balance
loss of a MoE block is counted for real microbatches only and averaged
over them, which is ``apply_seq_with_aux(..., n_micro)``'s definition."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.models.layers import Dense, Embed, LayerNorm
from fedml_tpu_torch.models.moe import SwitchFFN
from fedml_tpu_torch.models.transformer import CausalSelfAttention
from fedml_tpu_torch.trainer.workload import Workload, make_nwp_loss_metrics


def make_stage_mesh(n_stages: int, devices=None, device=None
                    ) -> List[torch.device]:
    """The stages' devices: ``devices`` (torch devices, or their names)
    when given, else every visible card round robin (``cuda:(s %
    count)``), or the CPU for every stage when ``device`` is the CPU."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if devices is not None:
        devices = [torch.device(str(d)) for d in devices]
        if not devices:
            raise ValueError("make_stage_mesh: an empty device list")
        return [devices[s % len(devices)] for s in range(n_stages)]
    if device is not None and torch.device(str(device)).type == "cpu":
        return [torch.device("cpu")] * n_stages
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--platform "
            "cpu) to run the stages on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(n_stages)]


class TransformerBlock(nn.Module):
    """One pre-LN block (LN -> causal MHA -> residual, LN -> FFN ->
    residual), the unit the pipeline distributes; the same wiring as
    `TransformerLM`'s dense blocks, under flax's names (``LayerNorm_0``,
    ``attn``, ``LayerNorm_1``, ``Dense_0``/``Dense_1`` or ``moe``).
    ``forward`` returns ``(y, balance)``: the Switch balance term, 0 for
    the dense FFN."""

    def __init__(self, n_heads: int, d_model: int, d_ff: int, dtype=None,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.moe_experts = moe_experts
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype)
        self.attn = CausalSelfAttention(n_heads, d_model, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d_model, dtype=dtype)
        if moe_experts:
            self.moe = SwitchFFN(moe_experts, d_model, d_ff,
                                 capacity_factor=moe_capacity_factor,
                                 dtype=dtype)
        else:
            self.Dense_0 = Dense(d_model, d_ff, dtype)
            self.Dense_1 = Dense(d_ff, d_model, dtype)

    def forward(self, x, positions, mask=None):
        x = x + self.attn(self.LayerNorm_0(x), positions)
        h = self.LayerNorm_1(x)
        if self.moe_experts:
            h, balance = self.moe(h, mask=mask)
        else:
            h = self.Dense_1(F.gelu(self.Dense_0(h), approximate="tanh"))
            balance = torch.zeros((), device=x.device)
        return x + h, balance


class _Embed(nn.Module):
    def __init__(self, vocab_size, d_model, max_len, dtype):
        super().__init__()
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)

    def forward(self, toks, positions):
        return self.tok_embed(toks) + self.pos_embed(positions)[None]


class _Final(nn.Module):
    def __init__(self, vocab_size, d_model, dtype):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype)
        self.lm_head = Dense(d_model, vocab_size, dtype)

    def forward(self, x):
        return self.lm_head(self.LayerNorm_0(x))


def _sub(params: Tree, prefix: str) -> Tree:
    """``params``' leaves under ``prefix/``, the prefix dropped and
    ``/`` -> ``.`` (``functional_call``'s names)."""
    n = len(prefix) + 1
    return {k[n:].replace("/", "."): v for k, v in params.items()
            if k.startswith(prefix + "/")}


class PipelineLM(nn.Module):
    """Decoder-only LM over an explicit stacked-blocks tree, built for
    pipelining (flax's defaults: d_model 128, 4 heads, 4 layers, d_ff 512,
    max_len 2048).  ``apply_seq`` is the one-device forward (a loop over
    the layers); ``make_pp_apply`` the same function as a GPipe pipeline
    over stage devices."""

    def __init__(self, vocab_size: int, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 4, d_ff: int = 512, max_len: int = 2048,
                 dtype=None, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01, pad_id: int = 0):
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_layers, self.max_len = n_layers, max_len
        self.moe_experts = moe_experts
        self.moe_aux_weight = moe_aux_weight
        self.pad_id = pad_id
        self.stochastic = False
        self.embed = _Embed(vocab_size, d_model, max_len, dtype)
        self.block = TransformerBlock(n_heads, d_model, d_ff, dtype=dtype,
                                      moe_experts=moe_experts,
                                      moe_capacity_factor=moe_capacity_factor)
        self.final = _Final(vocab_size, d_model, dtype)

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> Tree:
        """Fresh parameters in JAX's leaf order, drawn on the CPU from
        ``generator``: the embeddings, ``n_layers`` draws of the block
        stacked on a leading axis, the final norm and head."""
        def draw(module, prefix):
            for m in module.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)
            return {f"{prefix}/{k.replace('.', '/')}": p.detach().clone()
                    for k, p in module.named_parameters()}

        layers = [draw(self.block, "blocks") for _ in range(self.n_layers)]
        params = {**draw(self.embed, "embed"),
                  **{k: torch.stack([lay[k] for lay in layers])
                     for k in layers[0]},
                  **draw(self.final, "final")}
        return {k: params[k].to(device) for k in tree_keys(params)}

    # -- the pieces ------------------------------------------------------------
    def _embed_apply(self, params, toks, positions):
        return functional_call(self.embed, _sub(params, "embed"),
                               (toks, positions))

    def _final_apply(self, params, x):
        return functional_call(self.final, _sub(params, "final"), (x,))

    def _run_blocks(self, blocks: Tree, x, positions, mask=None):
        """The layers of ``blocks`` (leaves ``[n, ...]``) over ``x`` in
        order; ``(out, sum of the layers' balance terms)``."""
        n = next(iter(blocks.values())).shape[0]
        balance = torch.zeros((), device=x.device)
        for i in range(n):
            x, b = functional_call(self.block,
                                   {k: v[i] for k, v in blocks.items()},
                                   (x, positions, mask))
            balance = balance + b
        return x, balance

    def _pad_mask(self, toks):
        return None if not self.moe_experts \
            else (toks != self.pad_id).to(torch.float32)

    def _micro(self, params, toks, n_micro):
        b, t = toks.shape
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible into {n_micro} "
                             f"microbatches")
        positions = torch.arange(t, device=toks.device)
        x = self._embed_apply(params, toks, positions)
        mask = self._pad_mask(toks)
        return (positions, list(x.chunk(n_micro)),
                [None] * n_micro if mask is None
                else list(mask.chunk(n_micro)))

    # -- the one-device forward ------------------------------------------------
    def apply_seq(self, params: Tree, toks: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T, V] on one device."""
        return self.apply_seq_with_aux(params, toks)[0]

    def apply_seq_with_aux(self, params: Tree, toks: torch.Tensor,
                           n_micro: int = 1):
        """``(logits, balance)`` with the batch in ``n_micro``
        microbatches (Switch routing statistics are per routing call):
        ``balance`` is the mean over microbatches of each one's sum over
        the layers, the pipelined forward's parity twin."""
        positions, xs, ms = self._micro(params, toks, n_micro)
        blocks = _sub(params, "blocks")
        outs, bals = zip(*(self._run_blocks(blocks, x, positions, m)
                           for x, m in zip(xs, ms)))
        y = torch.cat(outs)
        return (self._final_apply(params, y),
                torch.mean(torch.stack(bals)))

    # -- the pipeline ----------------------------------------------------------
    def check_stages(self, n_stages: int) -> None:
        if self.n_layers % n_stages:
            raise ValueError(f"n_layers={self.n_layers} not divisible by "
                             f"n_stages={n_stages}")

    def pp_shard_params(self, params: Tree, stages: Sequence,
                        n_stages: Optional[int] = None) -> Tree:
        """The tree on the first stage's device, its shape unchanged (the
        pipelined and the sequential params are one tree); each call of
        `make_pp_apply`'s function moves a stage's layers to it."""
        self.check_stages(n_stages or len(stages))
        home = torch.device(str(stages[0]))
        return {k: v.to(home) for k, v in params.items()}

    def make_pp_apply(self, stages: Sequence, n_micro: int,
                      with_aux: bool = False):
        """``fn(params, toks) -> logits`` (``(logits, balance)`` with
        ``with_aux``) running the block stack as a GPipe pipeline over
        the devices ``stages`` (`make_stage_mesh`); the batch must divide
        into ``n_micro`` microbatches.  The embeddings and the head run
        on the tokens' device."""
        stages = [torch.device(str(d)) for d in stages]
        n_stages = len(stages)
        self.check_stages(n_stages)
        per = self.n_layers // n_stages

        def fn(params, toks):
            positions, xs, ms = self._micro(params, toks, n_micro)
            home = toks.device
            blocks = _sub(params, "blocks")
            stage_blocks = [{k: v[s * per:(s + 1) * per].to(dev)
                             for k, v in blocks.items()}
                            for s, dev in enumerate(stages)]
            stage_pos = [positions.to(dev) for dev in stages]
            # (activation, mask) waiting at each stage's input
            inbox: List[Any] = [None] * n_stages
            outs: List[Any] = [None] * n_micro
            balance = torch.zeros((), device=home)
            for ti in range(n_micro + n_stages - 1):
                nxt: List[Any] = [None] * n_stages
                for s, dev in enumerate(stages):
                    mi = ti - s
                    if not 0 <= mi < n_micro:
                        continue            # the bubble: nothing to run
                    if s == 0:
                        x = xs[mi].to(dev)
                        m = None if ms[mi] is None else ms[mi].to(dev)
                    else:
                        x, m = inbox[s]
                    y, b = self._run_blocks(stage_blocks[s], x,
                                            stage_pos[s], m)
                    balance = balance + b.to(home)
                    if s == n_stages - 1:
                        outs[mi] = y.to(home)
                    else:
                        to = stages[s + 1]
                        nxt[s + 1] = (y.to(to),
                                      None if m is None else m.to(to))
                inbox = nxt
            logits = self._final_apply(params, torch.cat(outs))
            return (logits, balance / n_micro) if with_aux else logits

        return fn


@dataclasses.dataclass(frozen=True)
class _PPWorkload(Workload):
    """A workload over `PipelineLM`'s explicit tree (its init draws the
    stacked blocks)."""

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> Tree:
        return self.model.init(generator, device)


def _nwp_workload_over(plm: PipelineLM, forward_aux, pad_id: int
                       ) -> Workload:
    """The NWP loss and metrics (`make_nwp_loss_metrics`) over
    ``forward_aux(params, toks) -> (logits, balance)``: the balance term
    enters the training loss at ``plm.moe_aux_weight``."""
    if plm.moe_experts and pad_id != plm.pad_id:
        raise ValueError(
            f"pad_id={pad_id} disagrees with the model's routing pad_id="
            f"{plm.pad_id}; build PipelineLM(pad_id={pad_id}) instead")

    def fwd(params, x, rng=None, train=False):
        logits, balance = forward_aux(params, x)
        return logits, (plm.moe_aux_weight * balance if plm.moe_experts
                        else None)

    loss_fn, metric_fn = make_nwp_loss_metrics(fwd, pad_id)
    return _PPWorkload(model=plm, loss_fn=loss_fn, metric_fn=metric_fn,
                       grad_clip_norm=None)


def make_pp_nwp_workload(plm: PipelineLM, stages: Sequence, n_micro: int,
                         pad_id: int = 0) -> Workload:
    """The next-word workload whose forward is the GPipe pipeline over
    ``stages``: a silo trains through it with the plain local trainer
    (silo-local training; the vmapped cohort engine cannot take it)."""
    return _nwp_workload_over(
        plm, plm.make_pp_apply(stages, n_micro, with_aux=True), pad_id)


def make_seq_nwp_workload(plm: PipelineLM, pad_id: int = 0,
                          n_micro: int = 1) -> Workload:
    """The one-device twin of `make_pp_nwp_workload` (same tree,
    ``apply_seq_with_aux`` forward); a MoE model's balance loss matches
    only under the pipeline's ``n_micro``."""
    return _nwp_workload_over(
        plm, lambda p, x: plm.apply_seq_with_aux(p, x, n_micro), pad_id)
