"""The port's wave mesh (``--algo cross_device --mesh_clients``) and the
device section on a mesh, against the JAX package's mesh wave
(``tests/test_cross_device.py:106-115``) and the port's one-rank engine.

Two ranks (a gloo group on the CPU) start once for the module and run
`torch_parallel_jobs.wave_mesh_job`, while this process runs JAX's engine
on a 2-device mesh from the same init.  Limits:

* the ranks' globals byte-equal;
* the mesh engine against the port's one-rank engine: bit for bit under
  ``client_axis="scan"``, as JAX's test holds it (each client trains
  alone, and the one-rank engine runs in the rank's own process, with
  its thread count: the CPU's kernels split a reduction by the threads,
  so an engine in another process would differ in the last bits); under
  ``vmap`` within 1e-6, the wave-chunking limit of
  ``test_torch_cross_device.py`` (a vmapped element's bits depend on the
  width of the tensor it sits in, here a rank's half of the wave);
* against JAX's 2-device mesh engine: the FedAvg oracle's limits of
  ``test_torch_cross_device.py`` (atol 2e-5, rtol 2e-4);
* the device section's memory on 2 ranks: one entry a rank (rank 0's
  watermarks and rank 1's, each stood in by its own figures), their sums,
  and the MFU's peak times the distinct cards, from one ``all_reduce``.
"""

import concurrent.futures

import jax
import numpy as np
import pytest

import torch_parallel_jobs as jobs
from fedml_tpu.algorithms.cross_device import CrossDevice as JCrossDevice
from fedml_tpu.algorithms.cross_device import \
    CrossDeviceConfig as JCrossDeviceConfig
from fedml_tpu.data import load_data as j_load_data
from fedml_tpu.experiments.models import create_workload as j_create_workload
from fedml_tpu.experiments.models import sample_shape_of
from fedml_tpu.parallel.mesh import make_mesh as j_make_mesh
from fedml_tpu_torch.core.pytree import flatten_nested
from fedml_tpu_torch.parallel.launch import spawn_ranks

WORLD = 2
VMAP_TOL = 1e-6
JAX_ATOL, JAX_RTOL = 2e-5, 2e-4
JOIN_S = 120
CFG = dict(comm_round=2, client_num_per_round=12, epochs=1, batch_size=4,
           wave_size=6, seed=0, frequency_of_the_test=10, lr=0.1)


@pytest.fixture(scope="module")
def runs(devices):
    """The ranks' results (spawned from a worker thread) and meanwhile
    JAX's 2-device mesh engine, from JAX's init."""
    jdata = j_load_data("mnist", batch_size=4, num_clients=24, seed=0)
    jwl = j_create_workload("lr", "mnist", jdata.class_num,
                            sample_shape_of(jdata))
    p0 = jwl.init(jax.random.key(4), jax.tree.map(
        lambda v: v[0, 0], {k: jdata.train[k] for k in ("x", "y", "mask")}))
    init = flatten_nested(jax.tree.map(np.asarray, p0))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, jobs.wave_mesh_job, WORLD,
                          (WORLD, {"waves": {"cfg": CFG, "init": init}}),
                          "cpu", JOIN_S)
        mesh = j_make_mesh(client_axis=WORLD, devices=devices[:WORLD])
        want = JCrossDevice(jwl, jdata, JCrossDeviceConfig(**CFG),
                            mesh=mesh).run(params=p0)
        return (fut.result(), init,
                flatten_nested(jax.tree.map(np.asarray, want)))


@pytest.mark.parametrize("axis", ["scan", "vmap"])
def test_wave_mesh_equals_one_rank(runs, axis):
    ranks, init, _ = runs
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert len({r[f"mesh_{axis}_sha256"] for r in ranks}) == 1
    for r in ranks:
        got, one = r[f"mesh_{axis}"], r[f"one_{axis}"]
        assert got.keys() == one.keys()
        for k in got:
            if axis == "scan":
                assert np.array_equal(got[k], one[k]), k
            else:
                np.testing.assert_allclose(got[k], one[k], atol=VMAP_TOL,
                                           rtol=0, err_msg=k)
        assert len(r[f"mesh_{axis}_gather_ms"]) == CFG["comm_round"]
        assert all(ms > 0 for ms in r[f"mesh_{axis}_gather_ms"])


def test_wave_mesh_matches_jax_mesh_engine(runs):
    ranks, init, want = runs
    got = ranks[0]["mesh_scan"]
    moved = max(np.abs(want[k] - init[k]).max() for k in want)
    assert moved > 100 * JAX_ATOL
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=JAX_ATOL,
                                   rtol=JAX_RTOL, err_msg=k)


def test_device_section_sums_over_the_ranks(runs):
    """Every rank reads both ranks' watermarks in rank order, their sums
    and the peak of two cards; a recorder without the mesh reads its own
    card alone."""
    ranks = runs[0]
    for r in ranks:
        sec = r["device_section"]
        mem = sec["memory"]
        assert [e["id"] for e in mem] == [0, 1]
        assert [e["card"] for e in mem] == [0, 1]
        assert [e["bytes_in_use"] for e in mem] == [1000, 2000]
        assert [e["peak_bytes"] for e in mem] == [5000, 10000]
        assert [e["round_peak_bytes"] for e in mem] == [1000, 2000]
        assert all(e["bytes_limit"] == 80000 for e in mem)
        assert [e["kind"] for e in mem] == ["card 0", "card 1"]
        assert sec["memory_total"] == {"bytes_in_use": 3000,
                                       "peak_bytes": 15000,
                                       "round_peak_bytes": 3000}
        assert sec["peak_tflops"] == 20.0
        alone = r["device_section_alone"]
        assert [e["bytes_in_use"] for e in alone["memory"]] == [
            1000 * (r["rank"] + 1)]
        assert alone["peak_tflops"] == 10.0 and "memory_total" not in alone
