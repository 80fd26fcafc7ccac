"""Per-round metrics sink (port of ``fedml_tpu/utils/metrics.py``).

* ``metrics.jsonl`` — one JSON object per ``log()`` call;
* ``summary.json`` — last value per key, written atomically every
  ``flush_summary_every`` events and on ``close()``.

``run_dir=None`` keeps everything in memory (``sink.events``).
``profiler_trace(dir)`` wraps a run in ``torch.profiler`` (the JAX
package's ``--profile_dir``)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _jsonable(v: Any) -> Any:
    """Scalar coercion (tensor / numpy scalars -> Python numbers)."""
    if isinstance(v, np.generic) or (hasattr(v, "item")
                                     and getattr(v, "ndim", None) == 0):
        return v.item()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


class MetricsSink:
    def __init__(self, run_dir: Optional[str] = None, stdout: bool = False,
                 name: str = "run", flush_summary_every: int = 25):
        self.run_dir = run_dir
        self.stdout = stdout
        self.name = name
        self.flush_summary_every = max(int(flush_summary_every), 1)
        self.summary: Dict[str, Any] = {}
        self.events = []
        self._t0 = time.time()
        self._fh = None
        self._since_flush = 0
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a",
                            buffering=1)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        event = {k: _jsonable(v) for k, v in metrics.items()}
        if step is not None:
            event["step"] = int(step)
        event["_runtime_s"] = round(time.time() - self._t0, 3)
        self.summary.update(
            {k: v for k, v in event.items() if not k.startswith("_")})
        self.events.append(event)
        if self._fh is not None:
            self._fh.write(json.dumps(event) + "\n")
            self._since_flush += 1
            if self._since_flush >= self.flush_summary_every:
                self._write_summary()
        if self.stdout:
            logger.info("[%s] %s", self.name, event)

    def _write_summary(self) -> None:
        if self.run_dir is None:
            return
        path = os.path.join(self.run_dir, "summary.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.summary, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        self._since_flush = 0

    def close(self) -> None:
        self._write_summary()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def stats_from_metrics(m, prefix: str = "") -> Dict[str, float]:
    """Summable metric dict {correct, loss_sum, total, correct_top5?} ->
    reported stats {acc, loss, acc_top5?}."""
    total = max(float(m["total"]), 1.0)
    out = {f"{prefix}acc": float(m["correct"]) / total,
           f"{prefix}loss": float(m["loss_sum"]) / total}
    if "correct_top5" in m:
        out[f"{prefix}acc_top5"] = float(m["correct_top5"]) / total
    return out


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str], device=None):
    """Capture a ``torch.profiler`` trace into ``trace_dir`` as a Chrome
    trace (``trace-<pid>.json``, viewable in ui.perfetto.dev), with the
    CUDA activities on a CUDA ``device``.  ``None`` disables tracing with
    zero overhead."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace-{os.getpid()}.json"))
