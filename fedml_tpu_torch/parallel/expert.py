"""Expert parallelism over ``torch.distributed`` (port of
``fedml_tpu/parallel/expert.py``): the Switch MoE's expert tables split
over an ``experts`` axis of ranks.

In the JAX package ep is a placement: the expert tables' leading ``[E]``
dim goes on the ``experts`` mesh axis and GSPMD inserts the collectives.
Here a rank holds its ``E/n`` experts (`ep_shard_params` returns them with
their `parallel.mesh.Placement`) and `models.moe.SwitchFFN`, given the
axis, runs them: the router stays replicated, so dispatch, capacity, drops
and the balance loss come from every token as in one process; the rank's
experts compute their share of the combine, and one sum over the axis a
MoE layer joins the shares (the cohort's rows lie on ``clients`` only, so
every rank of the axis holds the same tokens, as in the JAX package's
layout).  The dp x ep round is `parallel.cohort.make_cohort_step` with
the placement."""

from __future__ import annotations

from typing import Dict, Optional

from fedml_tpu_torch.parallel.mesh import (Mesh, Placement, _check_world,
                                           _n_devices)

__all__ = ["make_expert_mesh", "make_dp_ep_mesh", "ep_shard_params"]


def make_expert_mesh(n_experts_axis: int, devices=None, device=None) -> Mesh:
    """The 1-D ``[experts]`` mesh (pure ep; `make_dp_ep_mesh` for the
    federated form) over the world's ranks."""
    n = _n_devices(devices)
    if n < n_experts_axis:
        raise ValueError(f"need {n_experts_axis} devices for the experts "
                         f"axis, have {n}")
    _check_world((n_experts_axis,), n_experts_axis)
    return Mesh({"experts": n_experts_axis}, device=device)


def make_dp_ep_mesh(client_axis: int, expert_axis: int, devices=None,
                    device=None) -> Mesh:
    """The ``[clients, experts]`` mesh of dp x ep federated MoE training:
    cohort rows on ``clients``, expert tables on ``experts`` (contiguous
    ranks)."""
    n = client_axis * expert_axis
    have = _n_devices(devices)
    if have < n:
        raise ValueError(f"need {n} devices for a [{client_axis}, "
                         f"{expert_axis}] mesh, have {have}")
    _check_world((client_axis, expert_axis), n)
    return Mesh({"clients": client_axis, "experts": expert_axis},
                device=device)


def ep_shard_params(params, mesh: Mesh, n_experts: int,
                    axis: str = "experts"):
    """This rank's shards of the MoE expert tables and their `Placement`
    (JAX's gate): a leaf inside a ``moe_*`` module, not its ``router``,
    whose leading dim is ``n_experts`` shards that dim on ``axis``;
    everything else is replicated.  ``params``: a flat dict
    (``"moe_0/w1"``)."""
    n = mesh.shape[axis]
    if n_experts % n:
        raise ValueError(f"n_experts={n_experts} not divisible by the "
                         f"{axis} mesh axis ({n})")
    dims: Dict[str, Optional[int]] = {}
    for k, x in params.items():
        parts = k.split("/")
        in_moe = any(p.startswith("moe_") for p in parts)
        is_router = "router" in parts
        dims[k] = (0 if in_moe and not is_router and x.dim() >= 1
                   and x.shape[0] == n_experts else None)
    placement = Placement(mesh, axis, dims,
                          {k: tuple(v.shape) for k, v in params.items()})
    return placement.shard(params), placement
