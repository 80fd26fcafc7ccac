"""Local training of one client (port of ``fedml_tpu/trainer/local_sgd.py``).

``train(params, data)`` runs ``epochs * S`` optimizer steps over the
client's S batches, in order, with a fresh optimizer state on every call
(the reference builds its optimizer inside ``train`` each round).  The body
is written so that ``torch.func.vmap`` can map it over a stacked client
axis: gradients come from ``torch.func.grad``, and the data-dependent
choices (clipping, skipping a fully padded batch) are ``torch.where``, not
Python branches.

A stochastic workload (dropout) trains with one key a step: ``train(params,
data, rng)`` takes ``rng`` ``[epochs * S, 2]``, the JAX trainer's chain
``rng, dropout_rng = split(rng)`` from the client's key, derived outside
the vmap by ``train.rng_inputs(client_keys [C, 2], S)`` (`with_rng_inputs`).
A deterministic workload's trainers have ``rng_inputs = None`` and take no
key.

A stateful workload (BatchNorm) trains its ``params/...`` leaves only:
gradients, the FedProx term, the clip and the optimizer (its weight
decay included) see those.  The running statistics ride beside them,
taking each step's ``aux["state"]`` (kept as they were on a fully padded
batch, like the weights), and the output is the whole tree again."""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import grad

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree, tree_global_norm, tree_keys
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.trainer.workload import Workload, is_trained


def clip_by_global_norm(grads: Tree, max_norm: float,
                        sq_norm=None) -> Tree:
    """optax.clip_by_global_norm: keep the gradient when its global norm
    is below ``max_norm``, else ``g / norm * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  ``sq_norm(grads)``: the squared
    norm of a tree whose leaves are blocks of a placement
    (`parallel.mesh.Placement.sq_norm`)."""
    norm = (torch.sqrt(sq_norm(grads)) if sq_norm is not None
            else tree_global_norm(grads))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


def _select(cond: torch.Tensor, new, old):
    """``new`` where ``cond`` else ``old``, leaf by leaf over nested
    dicts."""
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)


def with_rng_inputs(train, workload: Workload, epochs: int):
    """Mark ``train`` as keyed when ``workload`` draws dropout masks:
    ``train.rng_inputs(client_keys, S)`` gives each client its ``[epochs *
    S, 2]`` step keys; None otherwise."""
    train.rng_inputs = ((lambda keys, num_steps: prng.step_keys(
        keys, epochs * num_steps)) if workload.stochastic else None)
    return train


def step_grad(grad_fn, params, batch, rng, step: int, *extra):
    """``grad_fn(params, batch, *extra)`` at one step, with that step's
    dropout key last when the trainer is keyed."""
    return (grad_fn(params, batch, *extra) if rng is None
            else grad_fn(params, batch, *extra, rng[step]))


def split_state(params: Tree, stateful: bool) -> Tuple[Tree, Tree]:
    """(trained leaves, running statistics) of a tree; a stateless
    workload's tree is all trained."""
    if not stateful:
        return params, {}
    return ({k: v for k, v in params.items() if is_trained(k)},
            {k: v for k, v in params.items() if not is_trained(k)})


def join_state(trained: Tree, state: Tree) -> Tree:
    """The inverse of `split_state`, in JAX's leaf order."""
    if not state:
        return trained
    tree = {**trained, **state}
    return {k: tree[k] for k in tree_keys(tree)}


def instrument_train_fn(train_fn, epochs: int = 1, registry=None):
    """Wrap a ``train(params, data, ...)`` callable with the trainer
    telemetry of the JAX package (``trainer/local_sgd.py:33-90``):

    * ``fedml_trainer_compile_seconds`` — the FIRST call's wall time (the
      kernel builds and cuDNN's algorithm picks of the first round);
    * ``fedml_trainer_train_seconds`` — every later call's wall time,
      the device synchronised before the clock stops (asynchronous
      launches must not hide the work);
    * ``fedml_trainer_examples_total`` — valid (mask=1) examples consumed,
      ``epochs * mask.sum()`` a call.

    The wrapper forwards a ``_cache_size`` probe, so the recompile
    sentry can register the instrumented function directly; the device
    observatory's wrapper (``PerfRecorder.instrument_jit``) composes
    INSIDE this one.  With telemetry disabled this returns ``train_fn``
    unchanged — zero wrapper, zero cost."""
    reg = registry if registry is not None else telemetry.get_registry()
    if not reg.enabled:
        return train_fn
    h_compile = reg.histogram("fedml_trainer_compile_seconds")
    h_train = reg.histogram("fedml_trainer_train_seconds")
    c_examples = reg.counter("fedml_trainer_examples_total")
    # claimed under a lock: silos on their own threads may make their
    # first calls together, and one sample belongs in the compile family
    state = {"first": True}
    state_lock = threading.Lock()
    epochs = max(int(epochs), 1)

    def instrumented(params, data, *rest):
        t0 = time.perf_counter()
        out = train_fn(params, data, *rest)
        devices = {v.device for v in (out[0] if isinstance(out, tuple)
                                      else out).values()
                   if isinstance(v, torch.Tensor) and v.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        with state_lock:
            first, state["first"] = state["first"], False
        (h_compile if first else h_train).observe(dt)
        mask = data.get("mask") if isinstance(data, dict) else None
        if mask is not None:
            m = mask.sum().item() if torch.is_tensor(mask) \
                else float(np.asarray(mask).sum())
            c_examples.inc(epochs * float(m))
        return out

    cache_size = getattr(train_fn, "_cache_size", None)
    if cache_size is not None:
        instrumented._cache_size = cache_size
    return instrumented


def make_local_trainer(workload: Workload, optimizer, epochs: int,
                       prox_mu: float = 0.0, grad_reduce=None,
                       placement=None):
    """Returns ``train(params, data) -> (new_params, metrics)`` over data
    leaves ``[S, B, ...]`` with ``mask`` ``[S, B]``.  ``prox_mu`` adds
    FedProx's proximal gradient ``mu * (w - w_global)`` each step (the
    global is the params the call started from), before the clip.

    ``grad_reduce(grads) -> grads`` runs right after the backward pass,
    before the proximal term, the clip and the step: sequence-parallel
    training sums each rank's partial gradient over the ``sequence`` axis
    there (`parallel.sequence`), so every rank takes the same step.

    ``placement``: the params are this rank's blocks of a tensor- or
    expert-parallel placement; the clip takes the global norm over the
    whole tree (`parallel.mesh.Placement.sq_norm`)."""
    sq_norm = placement.sq_norm if placement is not None else None

    stateful = workload.stateful

    def _loss(trained, batch, state, *rng):
        return workload.loss_fn({**trained, **state}, batch, *rng)

    grad_fn = grad(_loss, has_aux=True)

    def train(params: Tree, data: Dict[str, torch.Tensor], rng=None
              ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        params, state = split_state(params, stateful)
        opt_state = optimizer.init(params)
        init_params = params
        num_steps = data["mask"].shape[0]
        losses = []
        for step in range(epochs * num_steps):
            batch = {k: v[step % num_steps] for k, v in data.items()}
            grads, aux = step_grad(grad_fn, params, batch, rng, step, state)
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            if prox_mu:
                grads = {k: g + prox_mu * (params[k] - init_params[k])
                         for k, g in grads.items()}
            if workload.grad_clip_norm is not None:
                grads = clip_by_global_norm(grads, workload.grad_clip_norm,
                                            sq_norm)
            updates, new_state = optimizer.update(grads, opt_state, params)
            new_params = {k: (params[k] + updates[k]).to(params[k].dtype)
                          for k in params}
            # a fully padded batch leaves params, running statistics and
            # optimizer state as they were (SGD's gradient is 0 there
            # anyway; Adam's eps would still move them)
            got_data = torch.sum(batch["mask"]) > 0
            params = _select(got_data, new_params, params)
            if stateful:
                state = _select(got_data, aux["state"], state)
            opt_state = _select(got_data, new_state, opt_state)
            losses.append(aux["loss"])
        return (join_state(params, state),
                {"train_loss_per_step": torch.stack(losses)})

    train.workload = workload
    return with_rng_inputs(train, workload, epochs)


# rows one forward of the evaluator takes at most; a larger stack is
# evaluated in chunks of its steps axis, as the JAX package scans it
EVAL_ROWS = 16384


def make_evaluator(workload: Workload):
    """Returns ``evaluate(params, data) -> summed metrics`` over ``[..., S,
    B]`` batch stacks.  The metrics are sums, so the leading axes fold into
    one batch: the whole stack at once up to `EVAL_ROWS` rows, else chunks
    of the steps axis ``S`` of at most that many rows, summed."""

    def metrics(params, data, lead):
        return workload.metric_fn(params, {
            k: v.reshape((-1,) + tuple(v.shape[lead:]))
            for k, v in data.items()})

    def evaluate(params: Tree, data: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        lead = data["mask"].dim()
        rows = data["mask"].numel()
        with torch.no_grad():
            if lead < 2 or rows <= EVAL_ROWS:
                return metrics(params, data, lead)
            axis = lead - 2
            steps = data["mask"].shape[axis]
            chunk = max(1, EVAL_ROWS // (rows // steps))
            total = None
            for lo in range(0, steps, chunk):
                part = {k: v.narrow(axis, lo, min(chunk, steps - lo))
                        for k, v in data.items()}
                m = metrics(params, part, lead)
                total = m if total is None else {k: total[k] + m[k]
                                                 for k in total}
            return total

    return evaluate
