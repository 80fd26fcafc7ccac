"""Federated long-context training: data × sequence parallelism over
``torch.distributed`` (port of ``fedml_tpu/parallel/sequence.py``).

A cohort trains over a ``[clients, sequence]`` mesh of ranks
(`parallel.mesh.make_sp_mesh`): the cohort's rows split over the
``clients`` axis as in the cohort engine, and inside each client's local
SGD the transformer's sequence splits over ``sequence``, attending by the
exact ring (`parallel.ring_attention.ring_attention`).

The two pieces that are easy to get wrong, as in the JAX package:

* the per-position cross-entropy is normalised by the GLOBAL count of
  valid positions (a sum over the axis that carries no gradient), so
  every rank reports the same loss;
* each rank's backward yields only its PARTIAL gradient (its own logits'
  share of the loss), and the local trainer sums the partial gradients
  over ``sequence`` before the step (``grad_reduce``,
  `trainer.local_sgd.make_local_trainer`), so every rank of a client takes
  the same step and the copies never drift.  The loss that is
  differentiated is the rank's own share: a sum that carried a gradient
  there as well would count the gradient twice.

``torch.func.vmap`` cannot carry a collective, so a rank trains its
clients one after another (the ``client_axis="scan"`` form)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.parallel.cohort import bcast, train_cohort
from fedml_tpu_torch.parallel.mesh import _as_tensor, make_sp_mesh
from fedml_tpu_torch.parallel.ring_attention import local_positions
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import Workload, _module_names

__all__ = ["make_sp_nwp_workload", "make_sp_mesh", "make_sp_cohort_step"]


def make_sp_nwp_workload(model, mesh, axis_name: str = "sequence",
                         pad_id: int = 0,
                         grad_clip_norm: Optional[float] = None) -> Workload:
    """Next-token workload over a sequence-sharded `TransformerLM`: a
    batch's token axis is this rank's block of the sequence, its global
    positions come from the rank's index on ``axis_name``, and the counts
    and sums reduce over the axis.  ``loss_fn`` differentiates the rank's
    share ``sum(ce * m) / count`` and reports the whole loss in its aux;
    ``metric_fn``'s sums are the whole sequence's.  Dropout stays off
    (per-rank masks would decorrelate along the sequence)."""
    axis = mesh.axis(axis_name)

    def _position_mask(batch):
        return (batch["y"] != pad_id).to(torch.float32) \
            * batch["mask"][:, None]

    def _ce(params, batch):
        x = batch["x"]
        pos = local_positions(axis, x.shape[-1], x.device)
        logits = functional_call(model, _module_names(params), (x,),
                                 {"positions": pos, "ring_axis": axis})
        logits = logits.to(torch.float32)
        b, t, v = logits.shape
        ce = F.cross_entropy(logits.reshape(b * t, v),
                             batch["y"].reshape(b * t).long(),
                             reduction="none").reshape(b, t)
        return logits, ce

    def loss_fn(params, batch, rng=None):
        _, ce = _ce(params, batch)
        m = _position_mask(batch)
        part = torch.sum(ce * m)
        count = torch.clamp(axis.sum_no_grad(torch.sum(m)), min=1.0)
        loss = axis.sum_no_grad(part) / count
        return part / count, {"loss": loss}

    def metric_fn(params, batch):
        logits, ce = _ce(params, batch)
        m = _position_mask(batch)
        pred = torch.argmax(logits, dim=-1)
        return {
            "correct": axis.sum_no_grad(
                torch.sum((pred == batch["y"].long()) * m)),
            "loss_sum": axis.sum_no_grad(torch.sum(ce * m)),
            "total": axis.sum_no_grad(torch.sum(m)),
        }

    return Workload(model=model, loss_fn=loss_fn, metric_fn=metric_fn,
                    grad_clip_norm=grad_clip_norm)


def make_sp_cohort_step(workload: Workload, optimizer, epochs: int, mesh,
                        axis_name: str = "sequence"):
    """One federated round over the ``[clients, sequence]`` mesh:
    ``step(params, cohort, seed_words) -> (new_global, metrics)`` with the
    cohort's leaves ``[C, S, B, ...]`` whole on every rank.  A rank takes
    its block of clients and its block of the token axis of ``x`` and
    ``y``, trains its clients in turn (keyed by their global slots), and
    the weighted mean sums over both axes with the sequence copies
    divided out (``ratio / n_seq``), as the JAX package's does; the
    per-client metrics come back gathered over ``clients``."""
    local_train = make_local_trainer(
        workload, optimizer, epochs,
        grad_reduce=lambda g: mesh.allsum(g, axis_name))
    n_cli = mesh.shape["clients"]
    n_seq = mesh.shape[axis_name]

    def step(params, cohort, seed_words=(0, 0)):
        C = cohort["num_samples"].shape[0]
        T = cohort["x"].shape[-1]
        if C % n_cli:
            raise ValueError(f"cohort size {C} not divisible by the mesh "
                             f"clients axis ({n_cli})")
        if T % n_seq:
            raise ValueError(f"sequence length {T} not divisible by the "
                             f"mesh sequence axis ({n_seq})")
        lc, lt = C // n_cli, T // n_seq
        c, s = mesh.axis_index("clients"), mesh.axis_index(axis_name)
        rows = slice(c * lc, (c + 1) * lc)
        cols = slice(s * lt, (s + 1) * lt)
        local = {k: (_as_tensor(v)[rows, ..., cols] if k in ("x", "y")
                     else _as_tensor(v)[rows]).to(mesh.device)
                 for k, v in cohort.items()}
        params = {k: v.to(mesh.device) for k, v in params.items()}
        stacked, metrics = train_cohort(local_train, params, local,
                                        seed_words, client_axis="scan",
                                        index_offset=c * lc)
        w = local["num_samples"].to(torch.float32)
        total = mesh.allsum(torch.sum(w), "clients")
        ratio = w / torch.clamp(total, min=1.0) / n_seq
        sums = mesh.allsum(
            {k: torch.sum(x.to(torch.float32) * bcast(ratio, x.dim()), 0)
             for k, x in stacked.items()}, mesh.axis_names)
        new_global = {k: sums[k].to(x.dtype) for k, x in stacked.items()}
        return new_global, mesh.all_gather_rows(metrics, "clients")

    return step
