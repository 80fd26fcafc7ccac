"""Serving a `PipelineLM` (``--serve_port`` with ``--mesh_stages``): the
registry's predict path over the stacked-blocks tree
(`serve.registry.pipeline_apply`) against the JAX package's served
function, its pipeline workload's ``apply`` (JAX ``experiments/main.py:
1314-1315``, ``parallel/pipeline.py:335``), and the CLI answering
``/predict`` with each published version while it trains."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np

from fedml_tpu.parallel.pipeline import PipelineLM as JPipelineLM
from fedml_tpu.parallel.pipeline import make_pp_nwp_workload as j_pp_wl
from fedml_tpu.parallel.pipeline import make_stage_mesh as j_stage_mesh
from fedml_tpu_torch.parallel.pipeline import PipelineLM
from fedml_tpu_torch.serve import ModelRegistry
from fedml_tpu_torch.serve.registry import pipeline_apply

MODEL = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=16)


def test_registry_predict_equals_jax_pipeline_apply(devices):
    """A 2-stage tree carried from JAX (nested numpy, as the actor
    publishes it): the registry's logits equal JAX's ``_PPWorkload.apply``
    over 2 stages at atol 1e-5."""
    jlm = JPipelineLM(**MODEL)
    toks = np.random.RandomState(4).randint(1, 32, (4, 16)).astype(np.int32)
    jp = jax.jit(jlm.init)(jax.random.key(0), jnp.asarray(toks))
    want = np.asarray(j_pp_wl(jlm, j_stage_mesh(2, devices=devices),
                              n_micro=2).apply(jp, jnp.asarray(toks)))
    registry = ModelRegistry(pipeline_apply(PipelineLM(**MODEL)),
                             device="cpu")
    registry.publish(jax.tree.map(np.asarray, jp), 0)
    got = registry.current().predict(toks)
    assert got.shape == (4, 16, MODEL["vocab_size"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _post(port, path, payload):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_a_pipeline_lm_while_training():
    """``--algo cross_silo --mesh_stages 2 --serve_port N`` on the CPU:
    after each closed round the frontend answers ``/predict`` with that
    round's version and logits of the LM's shape."""
    t_main = importlib.import_module("fedml_tpu_torch.experiments.main")
    answers = []
    real = t_main.ServeWhileTrain.publish

    def publish(self, params, version):
        real(self, params, version)
        answers.append(_post(self.port, "/predict",
                             {"x": self._sample_x.tolist(),
                              "deadline_ms": 10000}))

    t_main.ServeWhileTrain.publish = publish
    try:
        out = t_main.main([
            "--algo", "cross_silo", "--silo_backend", "local", "--model",
            "transformer", "--dataset", "shakespeare",
            "--client_num_in_total", "4", "--client_num_per_round", "2",
            "--batch_size", "2", "--mesh_stages", "2", "--comm_round", "2",
            "--serve_port", str(_free_port()), "--platform", "cpu",
            "--log_stdout", "false"])
    finally:
        t_main.ServeWhileTrain.publish = real
    assert out["params_finite"] and out["stage_devices"] == "cpu,cpu"
    assert [s for s, _ in answers] == [200, 200]
    assert [b["version"] for _, b in answers] == [0, 1]
    logits = np.asarray(answers[-1][1]["y"])
    assert logits.shape[-1] == 90 and np.isfinite(logits).all()
