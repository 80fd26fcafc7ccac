"""Rank jobs of the port's mesh tests (`test_torch_mesh.py`,
`test_torch_mesh_algorithms.py`, `test_torch_topology_gossip.py`).

`parallel.launch.spawn_ranks` runs one of these on every rank of a gloo
group on the CPU; each returns plain numpy results, which the tests hold
against the JAX package and the port's single-process runs.  Imports no
JAX: the ranks run the port alone."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _np(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v) for k, v in tree.items()}


def fed_data(xs, ys, batch: int, classes: int):
    from fedml_tpu_torch.data.stacking import FederatedData, stack_client_data
    train = stack_client_data(xs, ys, batch)
    return FederatedData(client_num=len(xs), class_num=classes, train=train,
                         test=train)


def lr_workload(dim: int, classes: int, clip=None):
    from fedml_tpu_torch.models import LogisticRegression
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload
    return ClassificationWorkload(LogisticRegression(dim, classes),
                                  num_classes=classes, grad_clip_norm=clip)


# name -> (module, class, config class) of the port's algorithms
ALGOS = {
    "fedavg": ("fedavg", "FedAvg", "FedAvgConfig"),
    "fedprox": ("fedprox", "FedProx", "FedProxConfig"),
    "fedopt": ("fedopt", "FedOpt", "FedOptConfig"),
    "fednova": ("fednova", "FedNova", "FedNovaConfig"),
    "scaffold": ("scaffold", "Scaffold", "ScaffoldConfig"),
    "feddyn": ("feddyn", "FedDyn", "FedDynConfig"),
    "ditto": ("ditto", "Ditto", "DittoConfig"),
    "fedac": ("fedac", "FedAC", "FedACConfig"),
    "dp_fedavg": ("dp_fedavg", "DPFedAvg", "DPFedAvgConfig"),
    "fedavg_robust": ("fedavg_robust", "FedAvgRobust", "FedAvgRobustConfig"),
}


def algo_state(name: str, algo) -> list:
    """The algorithm's per-client or server state as a list of arrays."""
    def arrs(tree):
        return [np.asarray(tree[k]) if isinstance(tree[k], np.ndarray)
                else tree[k].detach().cpu().numpy()
                for k in sorted(tree, key=lambda k: k.split("/"))]
    if name == "scaffold":
        return arrs(algo.c_global) + arrs(algo.c_locals)
    if name == "feddyn":
        return arrs(algo.h_state) + arrs(algo.lam_locals)
    if name == "ditto":
        return arrs(algo.v_locals)
    if name == "fedac":
        return arrs(algo._x_state)
    if name == "fednova":
        return arrs(algo._gmf_buf)
    return []


def run_algo(case: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """One case ``{algo, cfg, data: (xs, ys, batch, classes), dim, init}``
    through the port: the final params, the state, ε for DP."""
    import importlib
    import torch
    from fedml_tpu_torch.parallel.mesh import params_sha256
    mod, cls, cfg_cls = ALGOS[case["algo"]]
    m = importlib.import_module(f"fedml_tpu_torch.algorithms.{mod}")
    xs, ys, batch, classes = case["data"]
    data = fed_data(xs, ys, batch, classes)
    algo = getattr(m, cls)(lr_workload(case["dim"], classes, case.get("clip")),
                           data, getattr(m, cfg_cls)(**case["cfg"]),
                           device="cpu", mesh=mesh)
    params = algo.run(params={k: torch.tensor(np.array(v))
                              for k, v in case["init"].items()})
    out = {"params": _np(params), "state": algo_state(case["algo"], algo),
           "sha256": params_sha256(params)}
    if case["algo"] == "dp_fedavg":
        out["epsilon"] = algo.accountant.epsilon()
        out["dp_rounds"] = algo.accountant.steps
    return out


def algorithms_job(world: int, cases: Dict[str, Dict[str, Any]],
                   cli: Dict[str, list]):
    """Every case on this rank's 1-D ``clients`` mesh of ``world`` ranks,
    then each ``cli`` argv through the CLI's ``main`` on the same ranks
    (its summary)."""
    from fedml_tpu_torch.experiments.main import main
    from fedml_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world, device="cpu")
    out = {name: run_algo(case, mesh) for name, case in cases.items()}
    out.update({f"cli_{name}": main(argv) for name, argv in cli.items()})
    return out


def mesh_job(world: int, spec: Dict[str, Any]):
    """The mesh module's cases on this rank (see `test_torch_mesh.py`)."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
    from fedml_tpu_torch.algorithms.hierarchical import (HierarchicalConfig,
                                                         HierarchicalFedAvg)
    from fedml_tpu_torch.data.stacking import stack_client_data
    from fedml_tpu_torch.parallel.cohort import make_cohort_step
    from fedml_tpu_torch.parallel.mesh import (make_mesh, make_two_level_mesh,
                                               params_sha256, stage_global)
    from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
    from fedml_tpu_torch.trainer.workload import make_client_optimizer
    mesh = make_mesh(world, device="cpu")
    out: Dict[str, Any] = {"rank": mesh.rank, "coords": dict(mesh.coords)}

    # the sharded cohort step on one cohort of 8 clients
    c = spec["cohort"]
    wl = lr_workload(c["dim"], c["classes"])
    train = stack_client_data(c["xs"], c["ys"], batch_size=c["batch"])
    local = make_local_trainer(wl, make_client_optimizer("sgd", 0.1), 1)
    step = make_cohort_step(local, mesh=mesh)
    init = {k: torch.tensor(np.array(v)) for k, v in c["init"].items()}
    block = stage_global(train, mesh, "clients")
    out["block_rows"] = [block.global_rows, block["num_samples"].shape[0]]
    out["block_num_samples"] = block["num_samples"].numpy().tolist()
    new, _ = step(init, train, (0, 5))
    out["cohort_step"] = _np(new)
    out["cohort_step_sha256"] = params_sha256(new)

    # FedAvg on the mesh: the rounds and the chunked evaluation
    f = spec["fedavg"]
    data = fed_data(f["xs"], f["ys"], f["batch"], f["classes"])
    algo = FedAvg(lr_workload(f["dim"], f["classes"]), data,
                  FedAvgConfig(**f["cfg"]), device="cpu", mesh=mesh)
    params = algo.run(params={k: torch.tensor(np.array(v))
                              for k, v in f["init"].items()})
    out["fedavg"] = _np(params)
    out["fedavg_sha256"] = params_sha256(params)
    out["fedavg_history"] = algo.history
    out["fedavg_collective_ms"] = algo.collective_times
    out["eval_chunked"] = algo.evaluate_global(
        {k: torch.tensor(np.array(v)) for k, v in f["init"].items()})

    # the defenses' hook on the mesh (clip; clip + noise)
    for defense in ("norm_diff_clipping", "weak_dp"):
        r = dict(spec["robust"], cfg=dict(spec["robust"]["cfg"],
                                          defense=defense))
        res = run_algo(r, mesh)
        out[f"robust_{defense}"] = res["params"]
        out[f"robust_{defense}_sha256"] = res["sha256"]

    # hierarchical FL: the group loop over the client mesh, and the
    # two-level [groups, clients] mesh
    h = spec["hierarchical"]
    hdata = fed_data(h["xs"], h["ys"], h["batch"], h["classes"])
    meshes = {"clients": mesh,
              "two_level": make_two_level_mesh(2, world // 2, device="cpu")}
    for label, m in meshes.items():
        hier = HierarchicalFedAvg(lr_workload(h["dim"], h["classes"]), hdata,
                                  HierarchicalConfig(**h["cfg"]), mesh=m,
                                  device="cpu")
        p = hier.run(params={k: torch.tensor(np.array(v))
                             for k, v in h["init"].items()})
        out[f"hier_{label}"] = _np(p)
        out[f"hier_{label}_sha256"] = params_sha256(p)
    out["two_level_coords"] = dict(meshes["two_level"].coords)
    return out


def failing_job(bad_rank: int):
    """Raise on ``bad_rank``; the others wait at a collective."""
    import torch
    from fedml_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")
    if mesh.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} gives up")
    return mesh.allsum(torch.ones(1)).item()


def gossip_job(world: int, spec: Dict[str, Any]):
    """The ring gossip on this rank's 1-D ``clients`` mesh of ``world``
    ranks, one node a rank (see `test_torch_topology_gossip.py`): the
    gossip run from the given stack, the weighted mean over the axis of
    the rank's tree, and the one-node-a-rank refusal."""
    import torch
    from fedml_tpu_torch.algorithms.decentralized import (
        DecentralizedConfig, DecentralizedGossip)
    from fedml_tpu_torch.core.pytree import tree_weighted_psum_mean
    from fedml_tpu_torch.parallel.mesh import make_mesh, params_sha256
    mesh = make_mesh(world, device="cpu")
    g = spec["gossip"]
    data = fed_data(g["xs"], g["ys"], g["batch"], g["classes"])
    algo = DecentralizedGossip(lr_workload(g["dim"], g["classes"]), data,
                               DecentralizedConfig(**g["cfg"]), mesh=mesh,
                               device="cpu")
    stacked = algo.run({k: torch.tensor(np.array(v))
                        for k, v in g["init"].items()})
    out: Dict[str, Any] = {"gossip": _np(stacked),
                           "gossip_sha256": params_sha256(stacked),
                           "history": algo.history,
                           "p2p_ms": mesh.collective_ms("p2p")}
    p = spec["psum"]
    local = {k: torch.tensor(np.array(v[mesh.rank]))
             for k, v in p["trees"].items()}
    out["psum_mean"] = _np(tree_weighted_psum_mean(
        local, torch.tensor(p["weights"][mesh.rank]), mesh.axis("clients")))
    extra = fed_data(g["xs"] + g["xs"][:1], g["ys"] + g["ys"][:1],
                     g["batch"], g["classes"])
    try:
        DecentralizedGossip(lr_workload(g["dim"], g["classes"]), extra,
                            DecentralizedConfig(**g["cfg"]), mesh=mesh,
                            device="cpu")
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out
