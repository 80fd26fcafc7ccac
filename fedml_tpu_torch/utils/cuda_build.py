"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``fedml_tpu_torch/csrc/`` (``*.cu``, which may include
the shared ``*.cuh`` headers beside them) compiles, at first use, into a
shared library with a plain C interface for ``sm_90a`` (Hopper).  The
library is cached in ``build/kernels/`` at the repository root (or
``$FEDML_TORCH_BUILD_DIR``) under a name that hashes the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.

Nothing is imported or compiled when this module is imported: the CPU
path never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("FEDML_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "fedml_tpu_torch are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """The cached library's path: it hashes the source, every shared
    header under ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is cached."""
    lib = library_path(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.fedml_lib, proc.fedml_tmp = lib, tmp
    return proc


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    proc.fedml_lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{proc.fedml_lib.name}:\n{log}")
    os.replace(proc.fedml_tmp, proc.fedml_lib)


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not cached, all ``nvcc``
    processes started together; returns the library paths."""
    names = list(names)
    with _lock:
        procs = [p for p in (_start(n) for n in names) if p is not None]
        for p in procs:
            _finish(p)
    return {n: library_path(n) for n in names}


def all_kernel_sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
