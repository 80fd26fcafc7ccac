"""The PyTorch port stands alone: every module of ``fedml_tpu_torch``, and
``chip_smoke.py``, imports with JAX and the JAX package blocked, and the
GPU entry points refuse to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "fedml_tpu")

_IMPORT_ALL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of it raises ImportError
import importlib, pkgutil
import fedml_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(fedml_tpu_torch.__path__,
                                              "fedml_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in {BLOCKED!r} and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_without_jax():
    out = _run(["-c", _IMPORT_ALL])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 45


SLICE_MODULES = ("fedml_tpu_torch.core.prng", "fedml_tpu_torch.core.murmur",
                 "fedml_tpu_torch.secure", "fedml_tpu_torch.secure.field",
                 "fedml_tpu_torch.secure.secagg",
                 "fedml_tpu_torch.secure.fused_mask",
                 "fedml_tpu_torch.algorithms.turboaggregate")


def test_secure_slice_modules_import_without_jax():
    """The secure-aggregation slice's modules, each named, import with JAX
    and the JAX package blocked (its numpy field module included: the port
    keeps its own copy)."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {SLICE_MODULES!r}:\n"
            f"    importlib.import_module(m)\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


CROSS_SILO_MODULES = (
    "fedml_tpu_torch.obs.telemetry", "fedml_tpu_torch.comm.message",
    "fedml_tpu_torch.comm.transport", "fedml_tpu_torch.comm.local",
    "fedml_tpu_torch.comm.actors", "fedml_tpu_torch.core.stream_agg",
    "fedml_tpu_torch.core.fused_agg", "fedml_tpu_torch.robust.admission",
    "fedml_tpu_torch.robust.degrade", "fedml_tpu_torch.parallel.mesh",
    "fedml_tpu_torch.shard_spine.plan", "fedml_tpu_torch.shard_spine.agg",
    "fedml_tpu_torch.shard_spine.admission",
    "fedml_tpu_torch.shard_spine.spine",
    "fedml_tpu_torch.algorithms.cross_silo",
    "fedml_tpu_torch.experiments.main")


def test_cross_silo_slice_modules_import_without_jax():
    """The cross-silo slice's modules, each named, import with JAX and the
    JAX package blocked (the wire and telemetry modules are numpy and
    stdlib in the JAX package too: the port keeps its own copies)."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {CROSS_SILO_MODULES!r}:\n"
            f"    importlib.import_module(m)\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


TRANSFORMER_MODULES = (
    "fedml_tpu_torch.parallel.ring_attention",
    "fedml_tpu_torch.models.layers", "fedml_tpu_torch.models.flash_attention",
    "fedml_tpu_torch.models.transformer", "fedml_tpu_torch.trainer.workload",
    "fedml_tpu_torch.data.registry", "fedml_tpu_torch.experiments.models",
    "fedml_tpu_torch.experiments.config", "fedml_tpu_torch.utils.jax_params")


def test_transformer_slice_modules_import_without_jax():
    """The transformer slice's modules, each named, import with JAX and the
    JAX package blocked, and importing them builds no kernel (the flash
    kernel's library is built at its first launch)."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {TRANSFORMER_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"fa = sys.modules['fedml_tpu_torch.models.flash_attention']\n"
            f"assert fa._lib_handle is None\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_gpu():
    """No GPU here: chip_smoke.py must exit non-zero and print no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    out = _run([str(ROOT / "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cli_refuses_without_gpu_unless_cpu_asked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    out = _run(["-m", "fedml_tpu_torch", "--comm_round", "1"])
    assert out.returncode != 0
    assert "--platform cpu" in out.stderr


FAULT_TOLERANCE_MODULES = (
    "fedml_tpu_torch.comm", "fedml_tpu_torch.comm.chaos",
    "fedml_tpu_torch.comm.resilient", "fedml_tpu_torch.comm.mqtt_wire",
    "fedml_tpu_torch.comm.mqtt_broker", "fedml_tpu_torch.comm.mqtt_client",
    "fedml_tpu_torch.comm.mqtt_transport",
    "fedml_tpu_torch.comm.grpc_transport",
    "fedml_tpu_torch.utils.journal", "fedml_tpu_torch.robust.faultline",
    "fedml_tpu_torch.utils.checkpoint",
    "fedml_tpu_torch.algorithms.cross_silo",
    "fedml_tpu_torch.experiments.main")


def test_fault_tolerance_modules_import_without_jax_or_grpc():
    """The fault-tolerance and transport modules, each named, import with
    JAX and the JAX package blocked, and none of them — the gRPC
    transport's module included — imports ``grpc`` (it is imported when a
    `GrpcTransport` is built)."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {FAULT_TOLERANCE_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"assert 'grpc' not in sys.modules\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
