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
    "fedml_tpu_torch.parallel.sequence", "fedml_tpu_torch.parallel.pipeline",
    "fedml_tpu_torch.parallel.expert", "fedml_tpu_torch.models.moe",
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


SECAGG_ALGORITHM_MODULES = (
    "fedml_tpu_torch.secure.protocol", "fedml_tpu_torch.server_opt",
    "fedml_tpu_torch.server_opt.optimizer", "fedml_tpu_torch.core.privacy",
    "fedml_tpu_torch.algorithms.fedopt", "fedml_tpu_torch.algorithms.fedprox",
    "fedml_tpu_torch.algorithms.fednova",
    "fedml_tpu_torch.algorithms.scaffold",
    "fedml_tpu_torch.algorithms.feddyn", "fedml_tpu_torch.algorithms.ditto",
    "fedml_tpu_torch.algorithms.fedac",
    "fedml_tpu_torch.algorithms.dp_fedavg",
    "fedml_tpu_torch.robust.admission",
    "fedml_tpu_torch.algorithms.cross_silo",
    "fedml_tpu_torch.experiments.main")


def test_secagg_and_algorithm_modules_import_without_jax():
    """Live SecAgg, the server-optimizer seam, the RDP accountant and the
    stateful algorithms, each named, import with JAX, optax and the JAX
    package blocked (optax's update rules and the numpy accountant are the
    port's own copies)."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {SECAGG_ALGORITHM_MODULES!r}:\n"
            f"    importlib.import_module(m)\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


CROSS_DEVICE_MODULES = (
    "fedml_tpu_torch.device_cohort", "fedml_tpu_torch.device_cohort.waves",
    "fedml_tpu_torch.algorithms.cross_device",
    "fedml_tpu_torch.core.sampling", "fedml_tpu_torch.core.prng",
    "fedml_tpu_torch.models.norms", "fedml_tpu_torch.models.resnet",
    "fedml_tpu_torch.models.cnn", "fedml_tpu_torch.models.layers",
    "fedml_tpu_torch.parallel.cohort", "fedml_tpu_torch.trainer.local_sgd",
    "fedml_tpu_torch.data.registry", "fedml_tpu_torch.experiments.models",
    "fedml_tpu_torch.experiments.main")


def test_cross_device_slice_modules_import_without_jax():
    """The cross-device slice's modules (the waves, the engine, the
    samplers, the GroupNorm ResNets and CNNDropOut), each named, import
    with JAX and the JAX package blocked."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {CROSS_DEVICE_MODULES!r}:\n"
            f"    importlib.import_module(m)\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


ZOO_MODULES = (
    "fedml_tpu_torch.models.rnn", "fedml_tpu_torch.models.mobilenet",
    "fedml_tpu_torch.models.norms", "fedml_tpu_torch.trainer.workload",
    "fedml_tpu_torch.trainer.local_sgd",
    "fedml_tpu_torch.algorithms.centralized",
    "fedml_tpu_torch.algorithms.fedavg_robust",
    "fedml_tpu_torch.utils.checkpoint", "fedml_tpu_torch.utils.jax_params",
    "fedml_tpu_torch.experiments.models",
    "fedml_tpu_torch.experiments.main")


def test_zoo_slice_modules_import_without_jax():
    """The model-zoo slice's modules (the LSTMs, the MobileNets,
    BatchNorm and the stateful workload, the centralized runner), each
    named, import with JAX and the JAX package blocked."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {ZOO_MODULES!r}:\n"
            f"    importlib.import_module(m)\nprint('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


LIVE_MACHINERY_MODULES = (
    "fedml_tpu_torch.robust.degrade", "fedml_tpu_torch.robust.adversary",
    "fedml_tpu_torch.data.edge_case", "fedml_tpu_torch.comm.compress",
    "fedml_tpu_torch.comm.ingest", "fedml_tpu_torch.algorithms.async_fl",
    "fedml_tpu_torch.algorithms.hierarchical",
    "fedml_tpu_torch.server_opt.optimizer",
    "fedml_tpu_torch.algorithms.cross_device",
    "fedml_tpu_torch.experiments.main")


def test_live_machinery_modules_import_without_jax():
    """The live machinery (the reliability tracker, the adversary and its
    pixel trigger, wire compression, the ingest pipeline, async_fl and the
    hierarchical engine and edge tier), each named, import with JAX and
    the JAX package blocked, and importing them starts no ingest worker
    and touches no CUDA stream."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib, threading\n"
            f"for m in {LIVE_MACHINERY_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"assert not [t for t in threading.enumerate()\n"
            f"            if t.name.startswith('ingest-fold')]\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


OBSERVABILITY_MODULES = (
    "fedml_tpu_torch.obs", "fedml_tpu_torch.obs.trace",
    "fedml_tpu_torch.obs.critical_path", "fedml_tpu_torch.obs.perf",
    "fedml_tpu_torch.obs.device", "fedml_tpu_torch.obs.health",
    "fedml_tpu_torch.obs.report", "fedml_tpu_torch.obs.trend",
    "fedml_tpu_torch.server_opt.controller")


def test_observability_modules_import_without_jax():
    """The observability slice (spans, the perf and health ledgers, the
    device observatory, the report, the trend gate, the controller),
    each named, imports with JAX and the JAX package blocked; importing
    it starts no sampler thread and enables no tracer or registry."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib, threading\n"
            f"for m in {OBSERVABILITY_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"from fedml_tpu_torch.obs import telemetry, trace\n"
            f"assert trace.get_tracer() is None\n"
            f"assert not telemetry.get_registry().enabled\n"
            f"assert not [t for t in threading.enumerate()\n"
            f"            if t.name.startswith('perf-rss')]\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


MIXED_PRECISION_MODULES = (
    "fedml_tpu_torch.models.moe", "fedml_tpu_torch.models.efficientnet",
    "fedml_tpu_torch.models.vgg", "fedml_tpu_torch.utils.torch_import",
    "fedml_tpu_torch.models.flash_attention",
    "fedml_tpu_torch.models.transformer", "fedml_tpu_torch.models.norms",
    "fedml_tpu_torch.models.rnn", "fedml_tpu_torch.trainer.workload",
    "fedml_tpu_torch.experiments.models")


def test_mixed_precision_slice_modules_import_without_jax():
    """The mixed-precision slice (the MoE FFN, EfficientNet, VGG, the
    checkpoint importer, the bf16 flash kernels' wrappers), each named,
    imports with JAX and the JAX package blocked, builds no kernel, and
    counts the bf16 kernels' launches apart from the f32 ones."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {MIXED_PRECISION_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"fa = sys.modules['fedml_tpu_torch.models.flash_attention']\n"
            f"assert fa._lib_handle is None\n"
            f"assert sorted(fa.launch_counts) == sorted(\n"
            f"    n for names in fa.KERNELS.values() for n in names)\n"
            f"assert 'flash_fwd_bf16' in fa.launch_counts\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


SERVING_MODULES = (
    "fedml_tpu_torch.serve", "fedml_tpu_torch.serve.registry",
    "fedml_tpu_torch.serve.batcher", "fedml_tpu_torch.serve.server",
    "fedml_tpu_torch.serve.pool", "fedml_tpu_torch.serve.release",
    "fedml_tpu_torch.serve.decode", "fedml_tpu_torch.models.transformer",
    "fedml_tpu_torch.algorithms.cross_silo",
    "fedml_tpu_torch.algorithms.cross_device",
    "fedml_tpu_torch.experiments.main")


def test_serving_modules_import_without_jax():
    """The serving slice (registry, micro-batcher, HTTP frontend and
    pool, the release gate, continuous-batching decode), each named,
    imports with JAX, flax, optax and the JAX package blocked; importing
    it starts no server, batcher or watcher thread."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib, threading\n"
            f"for m in {SERVING_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"assert not [t for t in threading.enumerate()\n"
            f"            if t.name.startswith('serve')]\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


DATA_MODULES = (
    "fedml_tpu_torch.core.partition", "fedml_tpu_torch.core.prng",
    "fedml_tpu_torch.data", "fedml_tpu_torch.data.text",
    "fedml_tpu_torch.data.leaf", "fedml_tpu_torch.data.synthetic",
    "fedml_tpu_torch.data.stacking", "fedml_tpu_torch.data.tff_h5",
    "fedml_tpu_torch.data.cifar", "fedml_tpu_torch.data.augment",
    "fedml_tpu_torch.data.imagenet", "fedml_tpu_torch.data.edge_case",
    "fedml_tpu_torch.data.uci", "fedml_tpu_torch.data.tabular",
    "fedml_tpu_torch.data.registry", "fedml_tpu_torch.trainer.workload",
    "fedml_tpu_torch.experiments.models",
    "fedml_tpu_torch.experiments.config",
    "fedml_tpu_torch.experiments.main")
FILE_FORMAT_LIBS = ("h5py", "PIL", "pandas")


def test_data_slice_modules_import_without_jax_or_file_libraries():
    """The data layer (the partitioners, every loader, augmentation, the
    registry, tag prediction, the CLI), each named, imports with JAX and
    the JAX package blocked and with h5py, PIL and pandas blocked too:
    they are imported when a file of theirs is read, and the machine with
    the card may have none of them.  The registry's twins still load."""
    blocked = BLOCKED + FILE_FORMAT_LIBS
    code = (f"import sys\nfor name in {blocked!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {DATA_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"from fedml_tpu_torch.data import load_data\n"
            f"fd = load_data('stackoverflow_lr', num_clients=2,\n"
            f"               samples_per_client=3)\n"
            f"assert fd.train['y'].shape[-1] == 500\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


LONG_TAIL_MODULES = (
    "fedml_tpu_torch.core.topology", "fedml_tpu_torch.core.pytree",
    "fedml_tpu_torch.algorithms.backdoor",
    "fedml_tpu_torch.algorithms.decentralized",
    "fedml_tpu_torch.algorithms.decentralized_online",
    "fedml_tpu_torch.algorithms.split_nn",
    "fedml_tpu_torch.algorithms.vertical_fl",
    "fedml_tpu_torch.algorithms.fedgkt",
    "fedml_tpu_torch.algorithms.base_framework",
    "fedml_tpu_torch.models.vfl", "fedml_tpu_torch.models.resnet_gkt",
    "fedml_tpu_torch.experiments.main")


def test_long_tail_modules_import_without_jax():
    """The decentralized, split and vertical slice (the topology, the
    pytree helpers, backdoor, gossip, online DSGD/PushSum, SplitNN,
    vertical FL, FedGKT, the base framework, their models and the CLI),
    each named, imports with JAX and the JAX package blocked, and the
    base framework's demo runs there."""
    code = (f"import sys\nfor name in {BLOCKED!r}:\n"
            f"    sys.modules[name] = None\nimport importlib\n"
            f"for m in {LONG_TAIL_MODULES!r}:\n"
            f"    importlib.import_module(m)\n"
            f"from fedml_tpu_torch.algorithms.base_framework import "
            f"run_base_framework_demo\n"
            f"assert run_base_framework_demo(3, 2) == [3, 3]\n"
            f"print('ok')\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
