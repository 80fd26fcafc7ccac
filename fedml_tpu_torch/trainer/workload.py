"""Client workload contract (port of ``fedml_tpu/trainer/workload.py``).

A ``Workload`` bundles an ``nn.Module`` with pure functions over a flat
parameter dict (``loss_fn``, ``metric_fn``), so local training can take
gradients with ``torch.func`` and map over a stacked client axis.  Batches
are dicts ``{"x": [B, ...], "y": [B], "mask": [B]}``; the mask keeps padded
rows out of loss, gradient and metrics.

The dropout seam: ``loss_fn(params, batch, rng)`` with ``rng`` an int64
``[2]`` tensor (one threefry key's words, `core.prng`) runs the model in
train mode with dropout masks hashed from that key; without ``rng`` the
model runs deterministic, as in eval.  The key is an input like any
other, so ``torch.func.vmap`` maps it over a cohort without touching
torch's global generator.  A workload whose model draws masks is
``stochastic``; the local trainers give it one key a step.

Mixed precision (``compute_dtype=torch.bfloat16``), as the JAX package's:
the master parameters, their gradients and the client optimizer stay
f32; ``loss_fn`` casts the float parameters (a stateful workload's
``batch_stats`` excepted) and a float ``x`` to the compute dtype, the
casts are differentiable (gradients come back f32), and the cross-entropy
is taken on f32 logits.  cuBLAS's bf16 GEMMs reduce in f32 on this path
(``allow_bf16_reduced_precision_reduction`` off), as XLA's bf16 dots
accumulate in f32."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.models.norms import BatchNorm, batch_stats_collector

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# client optimizers, written out so they match optax's arithmetic
# ---------------------------------------------------------------------------

class SGD:
    """optax.sgd(lr): the update is ``-lr * g``."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: Tree) -> Dict:
        return {}

    def update(self, grads: Tree, state: Dict, params: Tree):
        return {k: (-self.lr) * g for k, g in grads.items()}, state


class AMSGrad:
    """optax ``add_decayed_weights(wd) -> scale_by_amsgrad() ->
    scale(-lr)``.  optax takes the running max over the *bias-corrected*
    second moment, where ``torch.optim.Adam(amsgrad=True)`` takes it over
    the raw one, so torch's optimizer cannot stand in for it."""

    def __init__(self, lr: float, wd: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, b1, b2, eps

    def init(self, params: Tree) -> Dict:
        z = {k: torch.zeros_like(v) for k, v in params.items()}
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": z, "nu": dict(z), "nu_max": dict(z)}

    def update(self, grads: Tree, state: Dict, params: Tree):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), c)
        mu, nu, nu_max, updates = {}, {}, {}, {}
        for k in tree_keys(grads):
            g = grads[k] + self.wd * params[k]
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            nu_max[k] = torch.maximum(state["nu_max"][k], nu[k] / bc2)
            u = (mu[k] / bc1) / (torch.sqrt(nu_max[k]) + self.eps)
            updates[k] = (-self.lr) * u
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "nu_max": nu_max}


def make_client_optimizer(name: str, lr: float, wd: float = 0.0):
    """"sgd" -> plain SGD(lr); anything else -> AMSGrad with coupled
    weight decay."""
    if name == "sgd":
        return SGD(lr)
    return AMSGrad(lr, wd)


# ---------------------------------------------------------------------------
# the workload
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """``loss_fn(params, batch, rng=None) -> (loss, aux)``;
    ``metric_fn(params, batch) -> dict of summable metrics`` (including
    ``correct``, ``loss_sum`` and ``total``).  ``stochastic``: the model
    draws dropout masks in train mode (``loss_fn`` given an ``rng``).
    ``stateful``: params are ``params/...`` and ``batch_stats/...`` and
    ``loss_fn``'s aux carries the new statistics as ``"state"``."""
    model: nn.Module
    loss_fn: Callable[..., tuple]
    metric_fn: Callable[[Tree, Batch], Dict[str, torch.Tensor]]
    grad_clip_norm: Optional[float] = None
    stochastic: bool = False
    stateful: bool = False

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> Tree:
        """Fresh parameters in JAX's leaf order, drawn on the CPU from
        ``generator`` (so one seed gives the same weights on any device);
        a stateful workload's running means 0 and variances 1."""
        return init_module(self.model, generator, device, self.stateful)


def generator_of(rng, seed: int = 0) -> torch.Generator:
    """The CPU generator a run draws its weights from: ``rng`` itself, a
    generator seeded with ``rng`` (an int), or with ``seed`` (None)."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(seed if rng is None else int(rng))


def init_module(model: nn.Module, generator: Optional[torch.Generator] = None,
                device="cpu", stateful: bool = False) -> Tree:
    """A module's fresh parameters as a flat dict keyed by the flax path,
    in JAX's leaf order, drawn on the CPU from ``generator``; ``stateful``:
    ``params/...`` and the running statistics as ``batch_stats/...``."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    params = {k.replace(".", "/"): p.detach().clone()
              for k, p in model.named_parameters()}
    if stateful:
        params = {**{f"params/{k}": v for k, v in params.items()},
                  **{"batch_stats/" + k.replace(".", "/"):
                     b.detach().clone()
                     for k, b in model.named_buffers()}}
    return {k: params[k].to(device) for k in tree_keys(params)}


def is_trained(path: str) -> bool:
    """Whether a leaf of a stateful tree is trained (``params/...``), not
    a running statistic."""
    return path.startswith("params/")


def _module_names(params: Tree) -> Dict[str, torch.Tensor]:
    """Flat params -> ``functional_call``'s names: a stateful tree's
    collection prefix dropped, ``/`` -> ``.``."""
    return {(k.split("/", 1)[1] if k.startswith(("params/", "batch_stats/"))
             else k).replace("/", "."): v for k, v in params.items()}


def apply_model(model: nn.Module, params: Tree, x: torch.Tensor,
                rng: Optional[torch.Tensor] = None,
                forward_kwargs: Optional[dict] = None) -> torch.Tensor:
    """The model's forward over ``params``; with ``rng`` (a key's words)
    in train mode, its dropout masks keyed by it; ``forward_kwargs`` go
    to the forward as they are (``tp_axis``)."""
    kwargs = dict(forward_kwargs or {})
    if rng is not None:
        kwargs["dropout_key"] = rng
    return functional_call(model, _module_names(params), (x,), kwargs)


def batch_norm_paths(model: nn.Module) -> Dict[nn.Module, str]:
    """Each BatchNorm layer of ``model`` and its path (``Norm_0/
    BatchNorm_0``)."""
    return {m: name.replace(".", "/") for name, m in model.named_modules()
            if isinstance(m, BatchNorm)}


def check_stateful(model: nn.Module, stateful: bool) -> Dict[nn.Module, str]:
    """A model with BatchNorm layers trains only as a stateful workload
    (its running statistics are params), and only such a model makes
    one; returns the layers' paths."""
    paths = batch_norm_paths(model)
    if bool(paths) != stateful:
        raise ValueError(
            f"stateful={stateful} with a model that has "
            f"{len(paths)} BatchNorm layers: BatchNorm's running statistics "
            f"ride a stateful workload (stateful=True), and only they do")
    return paths


def train_state(paths: Dict[nn.Module, str], stats: Dict) -> Tree:
    """A train-mode forward's new running statistics (the collector's
    ``{layer: (mean, var)}``) as ``batch_stats/...`` leaves."""
    out = {}
    for layer, (mean, var) in stats.items():
        out[f"batch_stats/{paths[layer]}/mean"] = mean
        out[f"batch_stats/{paths[layer]}/var"] = var
    return out


def is_stochastic(model: nn.Module) -> bool:
    """Whether the model draws dropout masks in train mode."""
    return bool(getattr(model, "stochastic", False))


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cast_floats(tree: Tree, dtype) -> Tree:
    """Float leaves cast to ``dtype`` (integer leaves untouched)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def compute_dtype_of(name) -> Optional[torch.dtype]:
    """``--compute_dtype``'s value ("" or None: f32) as a torch dtype."""
    if not name:
        return None
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"--compute_dtype {name!r} is not a float dtype")
    return dtype


def _mixed_precision(compute_dtype) -> Optional[torch.dtype]:
    """The workload's compute dtype; under one, cuBLAS's bf16 GEMMs
    reduce in f32 (the choice is the port's, once, for its bf16 path)."""
    dtype = compute_dtype_of(compute_dtype)
    if dtype is not None:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    return dtype


def ClassificationWorkload(model: nn.Module, num_classes: int,
                           grad_clip_norm: Optional[float] = 1.0,
                           stateful: bool = False,
                           compute_dtype=None,
                           forward_kwargs: Optional[dict] = None
                           ) -> Workload:
    """Softmax cross-entropy on logits, mean over valid rows; metrics sum
    top-1 (and top-5 above 5 classes) hits, loss and row count.
    ``stateful=True`` for BatchNorm models (see the module docstring).
    ``compute_dtype``: ``loss_fn`` runs the model in it (see the module
    docstring); ``metric_fn`` evaluates in f32, as the JAX package's.
    ``forward_kwargs``: passed to every forward (``{"tp_axis": axis}``
    runs the model on a placement's blocks, `parallel.mesh`)."""
    paths = check_stateful(model, stateful)
    dtype = _mixed_precision(compute_dtype)
    fk = dict(forward_kwargs or {})

    def _cast(params, x):
        if dtype is None:
            return params, x
        params = {k: v if k.startswith("batch_stats/") else
                  (v.to(dtype) if v.is_floating_point() else v)
                  for k, v in params.items()}
        return params, (x.to(dtype) if x.is_floating_point() else x)

    def _ce(params, batch, rng=None, train=False):
        x = batch["x"]
        if train:
            params, x = _cast(params, x)
        logits = apply_model(model, params, x, rng, fk).to(torch.float32)
        ce = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        return logits, ce

    def loss_fn(params, batch, rng=None):
        if stateful:
            with batch_stats_collector() as stats:
                _, ce = _ce(params, batch, rng, train=True)
        else:
            _, ce = _ce(params, batch, rng, train=True)
        loss = _masked_mean(ce, batch["mask"])
        aux = {"loss": loss}
        if stateful:
            # the running statistics rejoin the f32 master tree
            aux["state"] = cast_floats(train_state(paths, stats),
                                       torch.float32)
        return loss, aux

    def metric_fn(params, batch):
        logits, ce = _ce(params, batch)
        y, mask = batch["y"].long(), batch["mask"]
        pred = torch.argmax(logits, dim=-1)
        out = {"correct": torch.sum((pred == y) * mask),
               "loss_sum": torch.sum(ce * mask),
               "total": torch.sum(mask)}
        if num_classes > 5:
            top5 = torch.topk(logits, 5, dim=-1).indices
            in5 = torch.any(top5 == y[..., None], dim=-1)
            out["correct_top5"] = torch.sum(in5 * mask)
        return out

    return Workload(model=model, loss_fn=loss_fn, metric_fn=metric_fn,
                    grad_clip_norm=grad_clip_norm,
                    stochastic=is_stochastic(model), stateful=stateful)


def make_nwp_loss_metrics(forward, pad_id: int = 0):
    """The NWP loss and metric semantics (``make_nwp_loss_metrics`` of the
    JAX package): per-position cross-entropy averaged over the non-pad
    positions of valid rows, plus the forward's extra loss in training,
    and summable ``correct`` / ``loss_sum`` / ``total`` metrics.
    ``forward(params, x, rng=None, train=False) -> (logits [B, T, V],
    extra loss or None)``; ``rng`` keys dropout."""

    def _position_mask(batch):
        return (batch["y"] != pad_id).to(torch.float32) \
            * batch["mask"][:, None]

    def _ce(params, batch, rng=None, train=False):
        logits, extra = forward(params, batch["x"], rng, train)
        logits = logits.to(torch.float32)
        b, t, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * t, v),
                             batch["y"].reshape(b * t).long(),
                             reduction="none").reshape(b, t)
        return logits, ce, extra

    def loss_fn(params, batch, rng=None):
        _, ce, extra = _ce(params, batch, rng, train=True)
        m = _position_mask(batch)
        loss = torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
        if extra is not None:
            loss = loss + extra
        return loss, {"loss": loss}

    def metric_fn(params, batch):
        logits, ce, _ = _ce(params, batch)
        m = _position_mask(batch)
        pred = torch.argmax(logits, dim=-1)
        return {"correct": torch.sum((pred == batch["y"].long()) * m),
                "loss_sum": torch.sum(ce * m),
                "total": torch.sum(m)}

    return loss_fn, metric_fn


def NWPWorkload(model: nn.Module, pad_id: int = 0,
                grad_clip_norm: Optional[float] = None,
                compute_dtype=None,
                forward_kwargs: Optional[dict] = None) -> Workload:
    """Next-word/char prediction over ``[B, T, V]`` logits.
    ``compute_dtype``: the parameters are cast to it in training and in
    evaluation alike (the JAX package's forward), and the model must be
    built with the same ``dtype`` for its layers to compute in it.  A
    model with MoE layers adds ``moe_aux_weight x`` the sum of their
    load-balance terms to the training loss (evaluation ignores it).
    ``forward_kwargs``: as `ClassificationWorkload`'s."""
    dtype = _mixed_precision(compute_dtype)
    moe = bool(getattr(model, "moe_experts", 0))
    fk = dict(forward_kwargs or {})

    def forward(params, x, rng=None, train=False):
        if dtype is not None:
            params = cast_floats(params, dtype)
        if moe and train:
            kwargs = {**fk, "moe_aux": True}
            if rng is not None:
                kwargs["dropout_key"] = rng
            logits, load_balance = functional_call(
                model, _module_names(params), (x,), kwargs)
            return logits, model.moe_aux_weight * load_balance
        return apply_model(model, params, x, rng, fk), None

    loss_fn, metric_fn = make_nwp_loss_metrics(forward, pad_id)
    return Workload(model=model, loss_fn=loss_fn, metric_fn=metric_fn,
                    grad_clip_norm=grad_clip_norm,
                    stochastic=is_stochastic(model))


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def TagPredictionWorkload(model: nn.Module,
                          grad_clip_norm: Optional[float] = None
                          ) -> Workload:
    """Multi-label tag prediction (``stackoverflow_lr``): binary
    cross-entropy with logits, averaged over the tags and the valid rows;
    evaluation predicts ``logits > 0`` (sigmoid > 0.5) and sums the
    exact-match hits (``correct``), the loss, the rows and each row's
    precision and recall (``precision_sum``, ``recall_sum``)."""

    def _bce(params, batch):
        logits = apply_model(model, params, batch["x"]).to(torch.float32)
        return logits, torch.mean(_sigmoid_bce(logits, batch["y"]), dim=-1)

    def loss_fn(params, batch, rng=None):
        _, bce = _bce(params, batch)
        loss = _masked_mean(bce, batch["mask"])
        return loss, {"loss": loss}

    def metric_fn(params, batch):
        logits, bce = _bce(params, batch)
        y, mask = batch["y"], batch["mask"]
        pred = (logits > 0.0).to(torch.float32)
        exact = torch.all(pred == y, dim=-1).to(torch.float32)
        tp = torch.sum(y * pred, dim=-1)
        precision = tp / (torch.sum(pred, dim=-1) + 1e-13)
        recall = tp / (torch.sum(y, dim=-1) + 1e-13)
        return {"correct": torch.sum(exact * mask),
                "loss_sum": torch.sum(bce * mask),
                "total": torch.sum(mask),
                "precision_sum": torch.sum(precision * mask),
                "recall_sum": torch.sum(recall * mask)}

    return Workload(model=model, loss_fn=loss_fn, metric_fn=metric_fn,
                    grad_clip_norm=grad_clip_norm,
                    stochastic=is_stochastic(model))
