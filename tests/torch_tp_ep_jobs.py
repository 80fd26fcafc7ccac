"""Rank job of the port's tensor- and expert-parallel tests
(`test_torch_tp_ep.py`).

`parallel.launch.spawn_ranks` runs `tp_ep_job` on each of 4 gloo ranks
on the CPU.  The parent hands every case's inputs in ``spec`` (JAX's
weights and data as numpy) and holds what the ranks return (whole trees:
the gathered globals and gradients, the logits) against the JAX package's
unsharded functions.  Imports no JAX: the ranks run the port alone."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _np(tree) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _tensors(tree):
    import torch
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _lr_step(case, mesh, clip):
    """The dp x tp cohort step of LR from the case's init (JAX's rule at
    ``min_size``): the gathered global and this rank's sha256."""
    from fedml_tpu_torch.models import LogisticRegression
    from fedml_tpu_torch.parallel.cohort import make_cohort_step
    from fedml_tpu_torch.parallel.mesh import params_sha256, tp_shard_params
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                                  make_client_optimizer)
    axis = mesh.axis("model")
    wl = ClassificationWorkload(LogisticRegression(*case["dims"]),
                                case["dims"][1], grad_clip_norm=clip,
                                forward_kwargs={"tp_axis": axis})
    params = _tensors(case["params"])
    _, placement = tp_shard_params(params, mesh, min_size=case["min_size"])
    local = make_local_trainer(wl, make_client_optimizer("sgd", case["lr"]),
                               1, placement=placement)
    step = make_cohort_step(local, mesh=mesh, placement=placement)
    out, _ = step(params, _tensors(case["cohort"]), case["seed_words"])
    return {"params": _np(out), "sha": params_sha256(out),
            "spec": {k: placement.spec(k) for k in params}}


def _grads_on(model, params, placement, axis, batch, moe: bool):
    """The NWP loss's gradients on this rank's blocks, gathered whole."""
    import torch
    from torch.func import grad
    from fedml_tpu_torch.trainer.workload import NWPWorkload
    wl = NWPWorkload(model, forward_kwargs={"tp_axis": axis})
    blocks = placement.shard(params)
    g = grad(lambda p: wl.loss_fn(p, batch)[0])(blocks)
    return _np(placement.gather(g))


def _lm_forward(model, params, placement, axis, toks):
    import torch
    from fedml_tpu_torch.trainer.workload import apply_model
    with torch.no_grad():
        return apply_model(model, placement.shard(params), toks,
                           forward_kwargs={"tp_axis": axis}).numpy()


def _tp_transformer(case, mesh):
    """The head-parallel transformer on the model axis of ``mesh``: its
    logits and the NWP loss's gradients."""
    import torch
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel.mesh import tp_shard_params
    model = TransformerLM(**case["model"])
    axis = mesh.axis("model")
    params = _tensors(case["params"])
    _, placement = tp_shard_params(params, mesh, min_size=case["min_size"])
    toks = torch.tensor(case["tokens"])
    batch = {"x": toks, "y": torch.roll(toks, -1, dims=1),
             "mask": torch.ones(toks.shape[0])}
    return {"logits": _lm_forward(model, params, placement, axis, toks),
            "grads": _grads_on(model, params, placement, axis, batch, False),
            "spec": {k: placement.spec(k) for k in params},
            "tp_ms": mesh.collective_ms("tp")}


def _ep_lm(case, mesh):
    """The MoE LM with its experts over ``mesh``'s experts axis: logits
    and the NWP loss's gradients (the balance loss included)."""
    import torch
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel.expert import ep_shard_params
    model = TransformerLM(**case["model"])
    axis = mesh.axis("experts")
    params = _tensors(case["params"])
    _, placement = ep_shard_params(params, mesh, case["model"]["moe_experts"])
    toks = torch.tensor(case["tokens"])
    batch = {"x": toks, "y": torch.roll(toks, -1, dims=1),
             "mask": torch.ones(toks.shape[0])}
    return {"logits": _lm_forward(model, params, placement, axis, toks),
            "grads": _grads_on(model, params, placement, axis, batch, True)}


def _dp_ep_round(case, mesh):
    """The dp x ep round of the MoE LM on ``[clients, experts]``."""
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel.cohort import make_cohort_step
    from fedml_tpu_torch.parallel.expert import ep_shard_params
    from fedml_tpu_torch.parallel.mesh import params_sha256
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import (NWPWorkload,
                                                  make_client_optimizer)
    model = TransformerLM(**case["model"])
    wl = NWPWorkload(model, forward_kwargs={"tp_axis": mesh.axis("experts")})
    params = _tensors(case["params"])
    _, placement = ep_shard_params(params, mesh, case["model"]["moe_experts"])
    local = make_local_trainer(wl, make_client_optimizer("sgd", case["lr"]),
                               1, placement=placement)
    step = make_cohort_step(local, mesh=mesh, placement=placement)
    out, _ = step(params, _tensors(case["cohort"]), case["seed_words"])
    return {"params": _np(out), "sha": params_sha256(out)}


def tp_ep_job(spec: Dict[str, Any]):
    """Every case on this rank, in one order on every rank (each mesh
    builds its subgroups collectively): the dp x tp LR step on ``[2, 2]``
    (and clipped), the tp transformer on that mesh's model axis, the ep
    LM on a 4-rank experts axis, the dp x ep round on ``[2, 2]``."""
    import torch
    from fedml_tpu_torch.parallel.expert import (make_dp_ep_mesh,
                                                 make_expert_mesh)
    from fedml_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    tp_mesh = make_mesh(client_axis=2, model_axis=2, device="cpu")
    out: Dict[str, Any] = {"coords": dict(tp_mesh.coords)}
    out["lr"] = _lr_step(spec["lr"], tp_mesh, None)
    out["lr_clip"] = _lr_step(spec["lr"], tp_mesh, spec["lr"]["clip"])
    out["tp"] = _tp_transformer(spec["tp"], tp_mesh)
    out["ep"] = _ep_lm(spec["ep"], make_expert_mesh(4, device="cpu"))
    out["dp_ep"] = _dp_ep_round(spec["dp_ep"],
                                make_dp_ep_mesh(2, 2, device="cpu"))
    return out
