"""Rank jobs of the port's sequence-parallel and wave-mesh tests
(`test_torch_sequence.py`, `test_torch_wave_mesh.py`).

`parallel.launch.spawn_ranks` runs one of these on every rank of a gloo
group on the CPU; each returns plain numpy results, which the tests hold
against the JAX package and the port's one-process runs.  Imports no
JAX: the ranks run the port alone."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _np(tree) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _tensors(tree):
    import torch
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def ring_case(axis, case: Dict[str, Any], causal: bool):
    """``ring_attention`` on this rank's blocks of ``case``'s q, k, v
    [B, T, H, d]: its output block and the gradients of ``sum(o * ct)``
    with respect to its q, k and v blocks."""
    import torch
    from fedml_tpu_torch.parallel.ring_attention import ring_attention
    t = case["q"].shape[1] // axis.size
    lo, hi = axis.index * t, (axis.index + 1) * t
    q, k, v = (torch.tensor(case[n][:, lo:hi]).requires_grad_(True)
               for n in ("q", "k", "v"))
    pos = torch.arange(lo, hi)
    out = ring_attention(q, k, v, pos, pos, axis, causal=causal)
    torch.sum(out * torch.tensor(case["ct"][:, lo:hi])).backward()
    return {"o": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _transformer(spec):
    from fedml_tpu_torch.models import TransformerLM
    return TransformerLM(**spec["model"])


def sequence_job(world: int, spec: Dict[str, Any]):
    """The sequence-parallel cases on this rank: the ring over a
    ``world``-rank sequence axis (causal and full), the transformer's
    sequence-parallel forward, on 4 ranks the dp x sp round on the
    ``[2, 2]`` mesh, and on 2 the ``--mesh_sequence`` CLI (``spec["cli"]``)
    on this group."""
    import torch
    from fedml_tpu_torch.parallel.mesh import make_sp_mesh, params_sha256
    from fedml_tpu_torch.parallel.ring_attention import (
        make_sequence_mesh, make_sequence_parallel_apply)
    from fedml_tpu_torch.parallel.sequence import (make_sp_cohort_step,
                                                   make_sp_nwp_workload)
    from fedml_tpu_torch.trainer.workload import make_client_optimizer
    # the cases are small: one thread a rank beside the test workers
    torch.set_num_threads(1)
    mesh = make_sequence_mesh(device="cpu")
    axis = mesh.axis("sequence")
    out: Dict[str, Any] = {"index": axis.index, "size": axis.size}
    for causal in (True, False):
        out[f"ring_{causal}"] = ring_case(axis, spec["ring"], causal)
    out["ring_p2p_ms"] = mesh.collective_ms("p2p")

    sp = spec["sp_apply"]
    model = _transformer(sp)
    fn = make_sequence_parallel_apply(model, mesh)
    with torch.no_grad():
        out["sp_logits"] = fn(_tensors(sp["params"]),
                              torch.tensor(sp["tokens"])).numpy()

    if world == 4:
        c = spec["sp_step"]
        sp_mesh = make_sp_mesh(2, 2, device="cpu")
        model = _transformer(c)
        step = make_sp_cohort_step(
            make_sp_nwp_workload(model, sp_mesh),
            make_client_optimizer("sgd", c["lr"]), 1, sp_mesh)
        new, metrics = step(_tensors(c["params"]), _tensors(c["cohort"]))
        out["sp_step"] = _np(new)
        out["sp_step_sha256"] = params_sha256(new)
        out["sp_step_loss"] = metrics["train_loss_per_step"].numpy()
        out["sp_coords"] = dict(sp_mesh.coords)
        out["sp_collective_ms"] = sp_mesh.collective_ms()
        out["sp_p2p_ms"] = sp_mesh.collective_ms("p2p")
    if world == 2:
        from fedml_tpu_torch.experiments.main import main
        out["cli"] = main(spec["cli"])
    return out


def _lr_wave_engine(case, mesh=None, **over):
    from fedml_tpu_torch.algorithms.cross_device import (CrossDevice,
                                                         CrossDeviceConfig)
    from fedml_tpu_torch.data import load_data
    from fedml_tpu_torch.experiments.models import (create_workload,
                                                    sample_shape_of)
    data = load_data("mnist", batch_size=4, num_clients=24, seed=0)
    wl = create_workload("lr", "mnist", data.class_num,
                         sample_shape_of(data))
    return CrossDevice(wl, data, CrossDeviceConfig(**{**case["cfg"],
                                                      **over}),
                       device="cpu", mesh=mesh)


def wave_mesh_job(world: int, spec: Dict[str, Any]):
    """The wave mesh on this rank: the engine under ``client_axis``
    "scan" and "vmap" on the ``world``-rank clients mesh, and the same
    engine on one rank in this process (its threads as the mesh run's);
    then the device section's memory read over the mesh, each rank's
    snapshot stood in by rank-numbered figures."""
    import torch
    from fedml_tpu_torch.obs import device as device_obs
    from fedml_tpu_torch.parallel.mesh import make_mesh, params_sha256
    torch.set_num_threads(1)
    mesh = make_mesh(world, device="cpu")
    out: Dict[str, Any] = {"rank": mesh.rank}
    case = spec["waves"]
    init = _tensors(case["init"])
    for axis in ("scan", "vmap"):
        algo = _lr_wave_engine(case, mesh, client_axis=axis)
        params = algo.run(params=dict(init))
        out[f"mesh_{axis}"] = _np(params)
        out[f"mesh_{axis}_sha256"] = params_sha256(params)
        out[f"mesh_{axis}_gather_ms"] = algo.collective_times
        one = _lr_wave_engine(case, client_axis=axis).run(params=dict(init))
        out[f"one_{axis}"] = _np(one)

    # the device section: each rank's card stood in by rank-numbered
    # watermarks (the CPU has no allocator to read)
    def snapshot(device=None):
        r = mesh.rank
        return [{"id": r, "platform": "cuda", "kind": "stand-in",
                 "source": "memory_stats", "bytes_in_use": 1000 * (r + 1),
                 "peak_bytes": 5000 * (r + 1), "bytes_limit": 80000}]

    device_obs.device_memory_snapshot = snapshot
    torch.cuda.get_device_name = lambda idx=None: f"card {idx}"
    rec = device_obs.DeviceRecorder(device="cpu", peak_tflops=10.0,
                                    mesh=mesh)
    rec.round_start()
    out["device_section"] = rec.round_snapshot(1.0)
    alone = device_obs.DeviceRecorder(device="cpu", peak_tflops=10.0)
    alone.round_start()
    out["device_section_alone"] = alone.round_snapshot(1.0)
    return out
