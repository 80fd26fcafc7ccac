"""Versioned model registry with atomic hot swap (port of
``fedml_tpu/serve/registry.py``).

The federation produces a new global every round; a request must never
see half of one.  The live state is one immutable `ServedModel` snapshot
(params, apply_fn, version) swapped by a single reference assignment, so
a reader that took the snapshot keeps a consistent triple however many
swaps land mid-request.

Feeds: ``publish(params, version)`` (the live actors' serve-while-train
hook, ``publish=registry.publish``) and `CheckpointWatcher`, a thread
polling a `utils.checkpoint.RoundCheckpointer` directory, tolerant of a
step GC'd between list and load and of a torn step (crc manifest).

Controls: ``pin(version)`` freezes serving on a vetted version while
publishes keep landing in history; ``rollback()`` steps back one promoted
version and pins there; ``unpin()`` follows the newest promoted version.

Release states: every history entry is **promoted** (vetted, or published
on the ungated path) or a **canary** (``publish(..., canary=True)`` by
`serve.release.ReleaseController`: in history for shadow evaluation but
never live until ``promote()``).  ``rollback()`` only lands on promoted
versions and fails loudly past the promoted horizon; pending canaries are
never evicted.

The registry owns the serving device: ``publish`` copies every leaf of
the params tree (numpy arrays or tensors, nested dicts kept) onto it
once, so no request pays a host-to-device copy of the weights and no
snapshot aliases a buffer the training loop will overwrite.
`ServedModel.predict` runs ``apply_fn`` under ``torch.inference_mode()``
on that device; `module_apply` builds a thread-safe ``apply_fn`` over a
model module, `pipeline_apply` one over a ``PipelineLM``'s stacked tree.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

Pytree = Any


def to_device(tree: Pytree, device: torch.device) -> Pytree:
    """A copy of ``tree`` (nested dicts of arrays or tensors) with every
    leaf a tensor on ``device``; never a view of the caller's buffers."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return torch.tensor(np.array(tree), device=device)


def module_apply(model: torch.nn.Module) -> Callable:
    """``apply_fn(params, x)`` over ``model``'s forward in eval mode, for
    flat (``"Dense_0/kernel"``) or nested params.  Calls are serialized:
    ``functional_call`` swaps the module's parameters in place, so two
    threads (pool workers, the release gate) must not run it at once."""
    from fedml_tpu_torch.core.pytree import flatten_nested
    from fedml_tpu_torch.trainer.workload import apply_model
    lock = threading.Lock()

    def apply_fn(params, x):
        flat = flatten_nested(params)
        with lock:
            return apply_model(model, flat, x)

    return apply_fn


def pipeline_apply(plm) -> Callable:
    """``apply_fn(params, x)`` over a `parallel.pipeline.PipelineLM`'s
    stacked tree (flat ``"blocks/..."`` keys or nested): the one-device
    forward ``apply_seq``, the logits the JAX package serves through its
    pipeline workload's ``apply`` (the same in one stage or S).  Calls are
    serialized, as `module_apply`'s: the layers run through
    ``functional_call`` on the model's modules."""
    from fedml_tpu_torch.core.pytree import flatten_nested
    lock = threading.Lock()

    def apply_fn(params, x):
        flat = flatten_nested(params)
        with lock:
            return plm.apply_seq(flat, x)

    return apply_fn


class ServedModel:
    """One immutable serving snapshot.  Readers hold the OBJECT, never the
    registry's mutable slot — consistency by construction."""
    __slots__ = ("params", "apply_fn", "version", "device")

    def __init__(self, params: Pytree, apply_fn: Callable, version: int,
                 device: torch.device = torch.device("cpu")):
        self.params = params
        self.apply_fn = apply_fn
        self.version = int(version)
        self.device = device

    def predict(self, rows) -> np.ndarray:
        """``apply_fn`` over a batch of host rows on the snapshot's
        device, under ``torch.inference_mode()``; the output on the host
        (f32 for a half-precision head)."""
        with torch.inference_mode():
            x = torch.tensor(np.asarray(rows)).to(self.device)
            out = self.apply_fn(self.params, x)
            if out.dtype in (torch.bfloat16, torch.float16):
                out = out.float()
            return out.cpu().numpy()

    def __repr__(self):
        return f"ServedModel(version={self.version})"


class ModelRegistry:
    """Monotonic version store + the single live-model slot.

    Writers (publish/pin/rollback) serialize on a lock; readers call
    ``current()`` lock-free — the live slot is swapped by one reference
    assignment (atomic under the GIL), and every snapshot is immutable.
    """

    def __init__(self, apply_fn: Callable, history: int = 4, device=None):
        """``device``: where the snapshots' params live and ``predict``
        runs (``None``: the GPU, raising without one; ``"cpu"`` asks for
        the host)."""
        if history < 2:
            raise ValueError(f"history must keep >= 2 versions for "
                             f"rollback; got {history}")
        self._apply_fn = apply_fn
        self.device = resolve_device(device)
        self._max_history = history
        self._lock = threading.Lock()
        self._history: "OrderedDict[int, ServedModel]" = OrderedDict()
        self._state: dict = {}  # version -> "promoted" | "canary"
        self._pinned: Optional[int] = None
        self._live: Optional[ServedModel] = None
        reg = telemetry.get_registry()
        self._g_version = reg.gauge("fedml_serve_model_version_total")
        self._c_swap = reg.counter("fedml_serve_hot_swap_total")
        self._c_rollback = reg.counter("fedml_serve_rollback_total")

    # -- read path (request hot path) ---------------------------------------
    def current(self) -> Optional[ServedModel]:
        """The live snapshot, or None before the first publish."""
        return self._live

    @property
    def version(self) -> Optional[int]:
        m = self._live
        return None if m is None else m.version

    @property
    def pinned(self) -> Optional[int]:
        return self._pinned

    def versions(self) -> list:
        with self._lock:
            return list(self._history)

    def state(self, version: int) -> str:
        """Release state of a history entry: "promoted" | "canary"."""
        with self._lock:
            if version not in self._history:
                raise KeyError(f"version {version} not in registry "
                               f"history {list(self._history)}")
            return self._state[version]

    def canaries(self) -> list:
        """Versions still awaiting a release verdict."""
        with self._lock:
            return [v for v in self._history
                    if self._state[v] == "canary"]

    def get(self, version: int) -> ServedModel:
        """The snapshot for ``version`` (shadow replay reads the canary
        without ever touching the live slot)."""
        with self._lock:
            if version not in self._history:
                raise KeyError(f"version {version} not in registry "
                               f"history {list(self._history)}")
            return self._history[version]

    # -- write path ---------------------------------------------------------
    def publish(self, params: Pytree, version: int,
                canary: bool = False) -> bool:
        """Register a new model version; hot-swap it live unless a pin is
        holding an older version.  Returns True when the version was NEW
        (stale/duplicate publishes — e.g. a watcher and a train hook both
        feeding the registry — are ignored, preserving monotonicity).

        ``canary=True`` (the release gate's entry path): the version
        lands in history but NEVER swaps the live slot — it serves only
        shadow traffic until ``promote()`` or ``discard()`` resolves it.
        """
        version = int(version)
        with self._lock:
            if self._history and version <= next(reversed(self._history)):
                return False
        # the copy runs outside the lock: a reader never waits on it
        snapshot = ServedModel(to_device(params, self.device),
                               self._apply_fn, version, self.device)
        with self._lock:
            if self._history and version <= next(reversed(self._history)):
                return False
            self._history[version] = snapshot
            self._state[version] = "canary" if canary else "promoted"
            self._evict_locked()
            if not canary and self._pinned is None:
                self._live = snapshot
                self._c_swap.inc()
            if self._live is not None:  # gauge tracks the SERVING version
                self._g_version.set(self._live.version)
        log.info("registry: published version %d%s", version,
                 " (canary, not live)" if canary else
                 (" (pinned, not live)" if self._pinned is not None
                  else ""))
        return True

    def _evict_locked(self) -> None:
        # evict oldest-first but NEVER the pinned, live, or a pending
        # canary version: a long serve-while-train run publishing past a
        # pin must not make the pinned model un-rollback-able, and a
        # canary awaiting its verdict must not vanish mid-evaluation
        while len(self._history) > self._max_history:
            protected = {self._pinned}
            if self._live is not None:
                protected.add(self._live.version)
            protected.update(v for v in self._history
                             if self._state[v] == "canary")
            evict = next((k for k in self._history
                          if k not in protected), None)
            if evict is None:
                break
            del self._history[evict]
            self._state.pop(evict, None)

    def promote(self, version: int) -> int:
        """Resolve a canary as vetted: mark it promoted, swap it live,
        and pin there (the promoted horizon — on the gated path serving
        only ever moves by an explicit verdict).  Idempotent when the
        version is already promoted AND live (the crash-at-
        ``canary_promote`` respawn re-drives the verdict safely).
        The swap is ONE lock-guarded reference assignment, so a process
        killed anywhere around it leaves the registry either fully
        pre-promote or fully post-promote — never between."""
        with self._lock:
            if version not in self._history:
                raise KeyError(f"version {version} not in registry "
                               f"history {list(self._history)}; cannot "
                               f"promote")
            if self._state[version] == "promoted":
                if self._live is not None \
                        and self._live.version == version:
                    return version  # respawn replay: already done
                live = None if self._live is None else self._live.version
                raise RuntimeError(
                    f"version {version} is promoted but not live "
                    f"(live={live}); "
                    f"promote() resolves canaries — use pin() to move "
                    f"serving between vetted versions")
            self._state[version] = "promoted"
            self._pinned = version
            self._live = self._history[version]
            self._c_swap.inc()
            self._g_version.set(version)
        log.info("registry: PROMOTED canary version %d (live, pinned)",
                 version)
        return version

    def discard(self, version: int) -> None:
        """Resolve a canary as rejected: drop it from history.  The live
        slot never moved for a canary, so this IS the rollback — serving
        stays on the last promoted version.  Promoted versions cannot be
        discarded (serving history is the rollback chain)."""
        with self._lock:
            if version not in self._history:
                raise KeyError(f"version {version} not in registry "
                               f"history {list(self._history)}; cannot "
                               f"discard")
            if self._state[version] != "canary":
                raise RuntimeError(
                    f"version {version} is promoted; discard() resolves "
                    f"canaries only — promoted history is the rollback "
                    f"chain")
            del self._history[version]
            del self._state[version]
        log.warning("registry: discarded canary version %d", version)

    def pin(self, version: int) -> None:
        """Freeze serving on ``version`` (must still be in history and
        promoted — a pin can never put an unvetted canary live).
        Publishes keep landing in history but stop swapping live."""
        with self._lock:
            if version not in self._history:
                raise KeyError(
                    f"version {version} not in registry history "
                    f"{list(self._history)}; cannot pin")
            if self._state[version] != "promoted":
                raise RuntimeError(
                    f"version {version} is an unvetted canary; pin() "
                    f"serves promoted versions only — resolve it via "
                    f"promote()/discard() first")
            self._pinned = version
            self._live = self._history[version]
            self._g_version.set(version)

    def unpin(self) -> None:
        """Resume following the newest PROMOTED version (a pending
        canary is never served by unpinning past it)."""
        with self._lock:
            self._pinned = None
            newest = next(
                (v for v in reversed(self._history)
                 if self._state[v] == "promoted"), None)
            if newest is not None:
                self._live = self._history[newest]
                self._g_version.set(newest)

    def rollback(self) -> int:
        """Step the live model back to the previous PROMOTED version and
        pin there (so the next publish doesn't instantly re-roll).
        Canary entries are skipped — rollback must never land serving on
        an unvetted model — and rolling past the promoted horizon (no
        older promoted version in history) fails loudly instead of
        serving whatever happens to be oldest.  Returns the version now
        live."""
        with self._lock:
            if self._live is None:
                raise RuntimeError("rollback before any publish")
            versions = list(self._history)
            idx = versions.index(self._live.version)
            target = next(
                (v for v in reversed(versions[:idx])
                 if self._state[v] == "promoted"), None)
            if target is None:
                promoted = [v for v in versions
                            if self._state[v] == "promoted"]
                raise RuntimeError(
                    f"no promoted version older than {self._live.version} "
                    f"in history {versions} (promoted horizon: "
                    f"{promoted}); cannot rollback onto an unvetted "
                    f"canary")
            self._pinned = target
            self._live = self._history[target]
            self._g_version.set(target)
            self._c_rollback.inc()
        log.warning("registry: rolled back to version %d (pinned)", target)
        return target


def _list_steps(ckpt_dir: str) -> list:
    """Integer-named child dirs = completed steps (the checkpointer writes
    a tmp-named dir and renames it, so a digit-named dir is durable)."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names if n.isdigit())


class CheckpointWatcher:
    """Background thread: poll a `RoundCheckpointer` directory, publish
    new rounds into a `ModelRegistry`.

    Each load opens a FRESH read-side `RoundCheckpointer`, never the
    live writer's.  A step that vanishes between list and load — the
    checkpointer's ``keep_last_n`` GC racing us — is counted and skipped,
    never fatal; it is marked seen so the watcher doesn't spin on it.

    Torn-file hardening: the writer stamps every step with a checksum
    manifest (`utils.checkpoint.manifest_path`, written by
    `utils.journal.atomic_write`).  When a manifest exists, the loaded
    params must match its crc32 (`utils.journal.tree_crc`) — a truncated
    ``state.npz``, a half-written manifest, or any torn read skips and
    warns (``outcome="corrupt"``) instead of crashing the watcher or
    serving garbage.  A step with NO manifest loads unverified.
    """

    def __init__(self, registry: ModelRegistry, ckpt_dir: str,
                 poll_s: float = 0.5, param_key: str = "params"):
        self.registry = registry
        self.ckpt_dir = ckpt_dir
        self.poll_s = poll_s
        self.param_key = param_key
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen = -1  # highest step already published or skipped
        reg = telemetry.get_registry()
        self._c_loads = reg.counter("fedml_serve_checkpoint_load_total",
                                    outcome="ok")
        self._c_vanished = reg.counter("fedml_serve_checkpoint_load_total",
                                       outcome="vanished")
        self._c_corrupt = reg.counter("fedml_serve_checkpoint_load_total",
                                      outcome="corrupt")

    def poll_once(self) -> int:
        """One list-and-load sweep (the thread's loop body; also the
        deterministic test surface).  Returns how many new versions were
        published."""
        published = 0
        for step in _list_steps(self.ckpt_dir):
            if step <= self._seen:
                continue
            params = self._load(step)
            self._seen = max(self._seen, step)
            if params is not None:
                self.registry.publish(params, step)
                self._c_loads.inc()
                published += 1
        return published

    def _load(self, step: int):
        from fedml_tpu_torch.utils.checkpoint import (RoundCheckpointer,
                                                      manifest_path)
        from fedml_tpu_torch.utils.journal import tree_crc
        # the atomic-rename + checksum contract, verified BEFORE serving:
        # a manifest that exists but cannot be parsed is a torn write —
        # the step is suspect, never loaded (fail safe, keep serving)
        want_crc = None
        mpath = manifest_path(self.ckpt_dir, step)
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                want_crc = int(manifest["crc"][self.param_key])
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._c_corrupt.inc()
                log.warning("watcher: step %d manifest torn/unreadable "
                            "(%s: %s); skipping the step",
                            step, type(e).__name__, e)
                return None
        try:
            ck = RoundCheckpointer(self.ckpt_dir)
            try:
                state = ck.restore(step)
            finally:
                ck.close()
            params = state[self.param_key]
        except (FileNotFoundError, KeyError) as e:
            # the step was GC'd between list and load, or is from a
            # different state schema — skip it, keep serving
            self._c_vanished.inc()
            log.warning("watcher: step %d unreadable (%s: %s); skipping",
                        step, type(e).__name__, e)
            return None
        except Exception as e:  # noqa: BLE001 — a truncated npz file
            # raises whatever its decoder hits (ValueError, OSError,
            # zipfile errors...); every flavor of half-written
            # checkpoint must skip-and-warn, never crash or serve garbage
            self._c_corrupt.inc()
            log.warning("watcher: step %d failed to load (%s: %s); "
                        "skipping the step", step, type(e).__name__, e)
            return None
        if want_crc is not None:
            got = tree_crc(params)
            if got != want_crc:
                self._c_corrupt.inc()
                log.warning("watcher: step %d params crc %d != manifest "
                            "%d (torn/partial checkpoint); skipping",
                            step, got, want_crc)
                return None
        return params

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-ckpt-watcher")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must outlive
                log.exception("watcher: poll failed; retrying")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
