"""The port's sequence parallelism over ``torch.distributed`` against the
JAX package's (``tests/test_ring_attention.py``).

The ranks of each world size (2 and 4: a gloo group on the CPU) start
once for the module and run every case of
`torch_parallel_jobs.sequence_job`, while this process runs the JAX
package on the conftest's CPU devices from the same inputs (numpy-seeded)
and weights (JAX's init, carried with `utils/jax_params.py`).  Limits:

* ``ring_attention`` on 2 and 4 ranks, causal and full, its output and
  the gradients with respect to q, k and v against JAX's ring on a
  4-device mesh and JAX's ``full_attention``: 1e-5;
* the transformer's sequence-parallel forward against JAX's
  ``make_sequence_parallel_apply`` and the dense forward: 1e-5;
* the dp x sp round on the ``[2 clients, 2 sequence]`` mesh against
  JAX's ``make_sp_cohort_step`` on ``make_sp_mesh(2, 2)`` and the dense
  cohort: 1e-4, the bound of JAX's own test
  (``tests/test_ring_attention.py:212-249``); the 4 ranks' globals
  byte-equal;
* the ``--mesh_sequence 2 --num_processes 2`` CLI on 2 ranks against the
  dense one-process run: the losses within 1e-4 relative, the ranks'
  globals byte-equal.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_jobs as jobs
from fedml_tpu.data.stacking import stack_client_data
from fedml_tpu.models import TransformerLM as JTransformerLM
from fedml_tpu.parallel.cohort import compat_shard_map
from fedml_tpu.parallel.cohort import make_cohort_step as j_cohort_step
from fedml_tpu.parallel.ring_attention import full_attention as j_full
from fedml_tpu.parallel.ring_attention import \
    make_sequence_mesh as j_seq_mesh
from fedml_tpu.parallel.ring_attention import \
    make_sequence_parallel_apply as j_sp_apply
from fedml_tpu.parallel.ring_attention import ring_attention as j_ring
from fedml_tpu.parallel.sequence import make_sp_cohort_step as j_sp_step
from fedml_tpu.parallel.sequence import make_sp_mesh as j_sp_mesh
from fedml_tpu.parallel.sequence import make_sp_nwp_workload as j_sp_wl
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local
from fedml_tpu.trainer.workload import NWPWorkload as JNWPWorkload
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.experiments.main import main
from fedml_tpu_torch.parallel.launch import spawn_ranks
from fedml_tpu_torch.utils.jax_params import params_to_numpy

WORLDS = (2, 4)
ATOL = 1e-5                    # the ring and the sp forward
STEP_ATOL = 1e-4               # the dp x sp round (JAX's own bound)
JOIN_S = 120
SP_MODEL = dict(vocab_size=50, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=64)
STEP_MODEL = dict(vocab_size=30, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                  max_len=16)
CLI = ["--algo", "fedavg", "--model", "transformer", "--dataset",
       "shakespeare", "--client_num_in_total", "2",
       "--client_num_per_round", "2", "--batch_size", "16", "--lr", "1.0",
       "--comm_round", "1", "--platform", "cpu", "--log_stdout", "false"]


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _flat(params):
    from fedml_tpu_torch.core.pytree import flatten_nested
    return flatten_nested(_np_tree(params))


def _ring_case():
    rng = np.random.RandomState(1)
    q, k, v, ct = (rng.randn(2, 32, 2, 8).astype(np.float32)
                   for _ in range(4))
    return {"q": q, "k": k, "v": v, "ct": ct}


def _sp_apply_case():
    model = JTransformerLM(**SP_MODEL)
    toks = np.random.RandomState(2).randint(0, 50, (2, 32)).astype(np.int32)
    params = model.init(jax.random.key(0), jnp.asarray(toks))["params"]
    return model, params, {"model": SP_MODEL, "tokens": toks,
                           "params": _flat(params)}


def _sp_step_case():
    model = JTransformerLM(**STEP_MODEL)
    rng = np.random.RandomState(7)
    xs = [rng.randint(1, 30, (6, 16)).astype(np.int32) for _ in range(4)]
    ys = [np.concatenate([x[:, 1:], x[:, :1]], axis=1) for x in xs]
    cohort = stack_client_data(xs, ys, batch_size=3)
    wl = JNWPWorkload(model)
    params = wl.init(jax.random.key(0), jax.tree.map(
        lambda v: jnp.asarray(v[0, 0]),
        {k: cohort[k] for k in ("x", "y", "mask")}))
    return model, wl, params, cohort, {
        "model": STEP_MODEL, "params": _flat(params), "lr": 0.1,
        "cohort": {k: np.asarray(v) for k, v in cohort.items()}}


@pytest.fixture(scope="module")
def cases():
    """The cases' inputs and JAX's models and weights (built here, not at
    import: every test worker imports this module)."""
    c = {"ring": _ring_case()}
    c["sp_jmodel"], c["sp_jparams"], c["sp_apply"] = _sp_apply_case()
    (c["step_jmodel"], c["step_jwl"], c["step_jparams"], c["step_cohort"],
     c["sp_step"]) = _sp_step_case()
    return c


def _j_ring_refs(ring):
    """JAX's ring on a 4-device mesh and its full attention: outputs and
    the vjp of ``sum(o * ct)`` (causal and full)."""
    q, k, v = (jnp.asarray(ring[n]) for n in ("q", "k", "v"))
    ct = jnp.asarray(ring["ct"])
    pos = jnp.arange(q.shape[1])
    mesh = j_seq_mesh(4)
    refs = {}
    for causal in (True, False):
        ring = jax.jit(compat_shard_map(
            lambda q, k, v, pos: j_ring(q, k, v, pos, pos, "sequence",
                                        causal=causal),
            mesh=mesh,
            in_specs=(P(None, "sequence"), P(None, "sequence"),
                      P(None, "sequence"), P("sequence")),
            out_specs=P(None, "sequence")))
        for name, fn in (("ring", lambda q, k, v: ring(q, k, v, pos)),
                         ("full", lambda q, k, v: j_full(
                             q, k, v, pos, pos, causal=causal))):
            o, vjp = jax.vjp(fn, q, k, v)
            dq, dk, dv = vjp(ct)
            refs[(name, causal)] = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    return refs


def _j_refs(devices, c):
    refs = {"ring": _j_ring_refs(c["ring"])}
    toks = jnp.asarray(c["sp_apply"]["tokens"])
    refs["dense_logits"] = np.asarray(c["sp_jmodel"].apply(
        {"params": c["sp_jparams"]}, toks))
    for d in WORLDS:
        refs[f"sp_logits{d}"] = np.asarray(j_sp_apply(
            c["sp_jmodel"], j_seq_mesh(d))(c["sp_jparams"], toks))
    cohort = {k: jnp.asarray(v) for k, v in c["step_cohort"].items()}
    opt = j_opt("sgd", c["sp_step"]["lr"])
    dense, dense_m = j_cohort_step(j_local(c["step_jwl"], opt, 1))(
        c["step_jparams"], cohort, jax.random.key(1))
    sp, sp_m = j_sp_step(j_sp_wl(c["step_jmodel"]), opt, epochs=1,
                         mesh=j_sp_mesh(2, 2, devices=devices[:4]))(
        c["step_jparams"], cohort, jax.random.key(1))
    refs["step_dense"] = _flat(dense)
    refs["step_sp"] = _flat(sp)
    refs["step_dense_loss"] = np.asarray(dense_m["train_loss_per_step"])
    refs["step_sp_loss"] = np.asarray(sp_m["train_loss_per_step"])
    return refs


@pytest.fixture(scope="module")
def runs(devices, cases):
    """Every rank's results at 2 and 4 ranks (spawned from worker
    threads), and meanwhile the JAX package's results and the dense
    one-process CLI run."""
    spec = {"ring": cases["ring"], "sp_apply": cases["sp_apply"],
            "sp_step": cases["sp_step"],
            "cli": CLI + ["--mesh_sequence", "2", "--num_processes", "2"]}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {d: pool.submit(spawn_ranks, jobs.sequence_job, d, (d, spec),
                               "cpu", JOIN_S) for d in WORLDS}
        refs = _j_refs(devices, cases)
        refs["cli_dense"] = main(CLI)
        return {d: f.result() for d, f in futs.items()}, refs


def _cat(ranks, key, part):
    """The ranks' blocks of a [B, T, ...] result, put back along T."""
    return np.concatenate([r[key][part] for r in ranks], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(runs, world, causal):
    """The ring and its dQ, dK, dV on ``world`` ranks against JAX's ring
    on 4 devices and JAX's full attention (1e-5)."""
    ranks, refs = runs[0][world], runs[1]
    assert [r["index"] for r in ranks] == list(range(world))
    for part in ("o", "dq", "dk", "dv"):
        got = _cat(ranks, f"ring_{causal}", part)
        for ref in ("ring", "full"):
            np.testing.assert_allclose(
                got, np.asarray(refs["ring"][(ref, causal)][part]),
                atol=ATOL, rtol=0, err_msg=f"{part} vs JAX {ref}")
    assert all(r["ring_p2p_ms"] > 0 for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_apply_matches_jax(runs, world):
    """The whole transformer with its sequence on ``world`` ranks against
    JAX's sequence-parallel forward and the dense one (1e-5)."""
    ranks, refs = runs[0][world], runs[1]
    got = np.concatenate([r["sp_logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, refs[f"sp_logits{world}"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, refs["dense_logits"], atol=ATOL, rtol=0)


def test_sp_cohort_step_matches_jax(runs, cases):
    """The dp x sp round on ``[2 clients, 2 sequence]``: the ranks'
    globals byte-equal, within 1e-4 of JAX's sp round and of the dense
    cohort, the per-step losses too; the ranks sit on the grid row-major
    with the sequence axis contiguous."""
    ranks, refs = runs[0][4], runs[1]
    assert len({r["sp_step_sha256"] for r in ranks}) == 1
    assert [r["sp_coords"] for r in ranks] == [
        {"clients": c, "sequence": s} for c in (0, 1) for s in (0, 1)]
    got = ranks[0]["sp_step"]
    assert got.keys() == refs["step_sp"].keys()
    moved = max(np.abs(refs["step_dense"][k]
                       - cases["sp_step"]["params"][k]).max() for k in got)
    assert moved > 10 * STEP_ATOL
    for ref in ("step_sp", "step_dense"):
        for k in got:
            np.testing.assert_allclose(got[k], refs[ref][k],
                                       atol=STEP_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(ranks[0]["sp_step_loss"],
                                   refs[f"{ref}_loss"], atol=STEP_ATOL)
    assert all(r["sp_p2p_ms"] > 0 and r["sp_collective_ms"] > r["sp_p2p_ms"]
               for r in ranks)


def test_sequence_cli_matches_dense_run(runs):
    """``--mesh_sequence 2 --num_processes 2`` on 2 ranks (one client
    block, the sequence in halves) against the dense one-process run:
    the losses within 1e-4 relative, the ranks byte-equal, the ring's
    time reported."""
    sp, dense = runs[0][2][0]["cli"], runs[1]["cli_dense"]
    assert sp["mesh_shape"] == "clients=1xsequence=2"
    assert sp["dist_backend"] == "gloo" and sp["world_size"] == 2
    hashes = sp["rank_params_sha256"].split(",")
    assert len(hashes) == 2 and len(set(hashes)) == 1
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(sp[k], dense[k], rtol=1e-4)
    assert sp["collective_ms_p2p_per_round"] > 0


def test_sp_refusals(cases):
    """JAX's errors: the cohort and the sequence must divide over the
    mesh; a mesh must match the ranks; decode does not take a ring."""
    from fedml_tpu_torch.models import TransformerLM
    from fedml_tpu_torch.parallel import mesh as mesh_lib
    from fedml_tpu_torch.parallel.ring_attention import make_sequence_mesh
    from fedml_tpu_torch.parallel.sequence import (make_sp_cohort_step,
                                                   make_sp_nwp_workload)
    from fedml_tpu_torch.trainer.workload import make_client_optimizer
    with pytest.raises(ValueError, match=r"mesh 2x2 != 1 devices"):
        mesh_lib.make_sp_mesh(2, 2, device="cpu")
    one = mesh_lib.Mesh({"clients": 1, "sequence": 1}, device="cpu")
    model = TransformerLM(**STEP_MODEL)
    step = make_sp_cohort_step(make_sp_nwp_workload(model, one),
                               make_client_optimizer("sgd", 0.1), 1, one)
    two = mesh_lib.Mesh({"clients": 2, "sequence": 1}, device="cpu")
    step2 = make_sp_cohort_step(make_sp_nwp_workload(model, two),
                                make_client_optimizer("sgd", 0.1), 1, two)
    cohort = {k: torch.tensor(np.asarray(v)) for k, v in
              cases["sp_step"]["cohort"].items()}
    with pytest.raises(ValueError, match="not divisible by the mesh clients"):
        step2(jobs._tensors(cases["sp_step"]["params"]),
              {k: v[:3] for k, v in cohort.items()})
    seq3 = mesh_lib.Mesh({"clients": 1, "sequence": 3}, device="cpu")
    step3 = make_sp_cohort_step(make_sp_nwp_workload(model, seq3),
                                make_client_optimizer("sgd", 0.1), 1, seq3)
    with pytest.raises(ValueError, match="not divisible by the mesh seq"):
        step3(jobs._tensors(cases["sp_step"]["params"]), cohort)
    # a [1, 1] mesh is the dense cohort step, clients one after another
    new, _ = step(jobs._tensors(cases["sp_step"]["params"]), cohort)
    assert all(torch.isfinite(v).all() for v in new.values())
    ring = make_sequence_mesh(1, device="cpu").axis("sequence")
    with pytest.raises(ValueError, match="ring_axis does not compose"):
        model(torch.zeros(2, dtype=torch.int32), positions=torch.zeros(
            2, dtype=torch.int64), ring_axis=ring,
            cache={"attn_0": {}})


def test_sp_params_carry_round_trip(cases):
    """The transformer's tree carries to the port and back unchanged."""
    want = cases["sp_apply"]["params"]
    flat = _flat(params_to_numpy(jobs._tensors(want)))
    assert flat.keys() == want.keys()
    for k in flat:
        assert np.array_equal(flat[k], want[k])
