"""Device & compile observatory: the card-level third of the flight
recorder (the port's redesign of ``fedml_tpu/obs/device.py`` for the
H100; the ledger's ``device`` section keeps the JAX package's schema).

Three instruments, riding the `PerfRecorder` round cadence (one
``device`` section per ``perf.jsonl`` line):

* **the card's memory watermarks** — ``torch.cuda.memory_stats`` of the
  recorder's one card (``bytes_in_use`` and ``peak_bytes`` are the caching
  allocator's allocated bytes now and at their peak, ``bytes_limit`` the
  card's memory from ``torch.cuda.mem_get_info``), and ``null`` on the
  CPU: the JAX package sums ``jax.live_arrays()`` there, and PyTorch has
  no honest twin of that sum, so the port never fabricates one.  On a
  mesh (``mesh=``: the wave mesh's ranks, a card each) the section reads
  every rank's card, as the JAX package reads every local device: one
  ``all_reduce`` at the round's read gathers each rank's watermarks, the
  section lists one entry a rank and their sums (``memory_total``), and
  the MFU's peak is the per-card peak times the distinct cards.
* **a named compile ledger** — every instrumented hot callable records
  the wall time of each call that BUILT something for a new signature:
  a call that grew the callable's ``_cache_size`` probe (CUDA-graph
  captures, kernel libraries loaded), or, where there is no
  probe, the first call of an argument signature.  The device is
  synchronised only on such a call, so its wall time is not hidden
  behind asynchronous launches; the steady path never synchronises.
  The `RecompileSentry` reads the same signatures, so a recompile
  verdict NAMES the argument whose shape changed.
* **achieved FLOP/s and an honest MFU gauge** — the FLOPs of each new
  ``(fn, signature)`` are counted once, on its first eager call, under
  ``torch.utils.flop_counter.FlopCounterMode`` (never inside a CUDA-graph
  capture; a grouped convolution's weight gradient, the vmapped wave's
  case, counted per group), or come from the kernel work table below for callables whose
  work runs in the hand-written kernels (``ctypes`` calls the flop
  counter cannot see) or in elementwise passes it does not count.  The
  round's sum is quoted against ONE peak table keyed on
  ``torch.cuda.get_device_name()``: the dense bf16 spec-sheet peak, so
  ``mfu`` is <= 1.0 by construction.

The kernel work table is the one ``chip_smoke.py`` reads for its
kernels' bounds (bytes and operations), so the bench and the live gauge
count one work.

Honesty contract: an unmeasurable quantity ledgers ``null``, never 0; a
signature whose FLOPs are unknown (the flop counter saw no operation it
counts, and no table entry was given) marks the round ``flops_complete:
false``, and the reported sum is then a lower bound.  Like the rest of
``obs/`` this module is stdlib-only at import time — torch loads inside
the probes.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

# dense bf16 tensor-core peak by card (NVIDIA data sheets, SXM parts,
# without sparsity), matched as a substring of the lower-cased
# ``torch.cuda.get_device_name()``
PEAK_TFLOPS_BY_KIND = (("h200", 989.4), ("h100", 989.4), ("a100", 312.0))

# unknown device: keep the H100 assumption.  On the CPU this is an upper
# bound many orders above the silicon, which keeps the gauge <= 1.0 by
# construction there (and useless as a utilization number — the ledger
# labels backend "cpu" so nobody quotes it as one).
DEFAULT_PEAK_TFLOPS = 989.4

MFU_PROVENANCE = ("flop_counter_mode_and_kernel_work_table_of_registered_"
                  "hot_callables / shared_device_name_peak_table")


def _device_name(dev) -> str:
    if dev is None:
        return ""
    if isinstance(dev, str):
        return dev
    try:
        import torch
        dev = torch.device(dev)
        if dev.type == "cuda" and torch.cuda.is_available():
            return torch.cuda.get_device_name(dev)
    except (RuntimeError, TypeError, ValueError):
        pass
    return str(dev)


def peak_tflops_for_device(dev) -> float:
    """Peak dense bf16 TF/s for ``dev`` (a torch device, a device name,
    or None: the env override or the default)."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env)
    kind = _device_name(dev).lower().replace(" ", "")
    for key, peak in PEAK_TFLOPS_BY_KIND:
        if key in kind:
            return peak
    return DEFAULT_PEAK_TFLOPS


def peak_source_for_device(dev) -> str:
    """Where the peak came from — ledgered beside every MFU."""
    if os.environ.get("BENCH_PEAK_TFLOPS"):
        return "BENCH_PEAK_TFLOPS env override"
    name = _device_name(dev)
    kind = name.lower().replace(" ", "")
    for key, _ in PEAK_TFLOPS_BY_KIND:
        if key in kind:
            return (f"device name table ({key}: NVIDIA data sheet, dense "
                    f"bf16 without sparsity, a spec figure)")
    return (f"device name table default (no entry for {name!r} — the "
            f"H100's spec-sheet dense bf16 peak as an upper bound)")


# ---------------------------------------------------------------------------
# the kernel work table (chip_smoke.py reads these for its bounds)
# ---------------------------------------------------------------------------

def robust_agg_work(n: int, sizes, sigma: float):
    """Bytes and operations of K1's aggregate over leaves of ``sizes``
    elements for ``n`` clients: x read once, g read and out written once,
    the scales and ratios; per (client, element) 5 f32 operations, and at
    sigma > 0 the noise: two murmur finalisers and two shifts (20 integer
    operations), 30 f32 operations (the uniforms, the log series and its
    select, the square root's and the cosine's scaling, sigma), lg2, rsqrt,
    cos and two int -> float conversions on the special-function units;
    per element the index hash (10 integer operations)."""
    d = sum(sizes)
    pairs = n * d
    ops = {"fp32": pairs * (30 + 5 if sigma else 5)}
    if sigma:
        ops.update(int=pairs * 20 + d * 10, sfu=pairs * 5)
    return 4 * (pairs + 2 * d + 2 * n), ops


def clip_norm_work(n: int, sizes):
    """The norm pass over weight leaves of ``sizes`` elements: x and g
    read once, the scales written; a subtract, a square and an add per
    (client, element)."""
    d = sum(sizes)
    return 4 * (n * d + d + n), {"fp32": 3 * n * d}


def secagg_mask_work(rows: int, n: int, d: int):
    """Bytes and operations of K3 for ``rows`` client rows of an
    ``n``-client group over ``d`` elements: x read and the ring values
    written once, the weights; per (row, element) the quantize (4 f32
    operations, one float -> int conversion).  A whole group of up to 16
    (rows == n) takes the each-pair-once form: per element one index hash
    (10 integer operations) and 11 per pair (the finaliser, an xor, an add
    and a subtract); otherwise per (row, element) the index hash and 10 per
    partner."""
    if rows == n <= 16:
        int_ops = d * (10 + 11 * n * (n - 1) // 2)
    else:
        int_ops = rows * d * (10 + 10 * (n - 1))
    return (4 * (2 * rows * d + rows),
            {"fp32": 4 * rows * d, "int": int_ops, "sfu": rows * d})


def shard_finalize_bounds(d: int, sigma: float):
    """Bytes and operations K2 must move and do over a ``d``-element
    shard: the accumulator read once and the output written once; per
    element one f32 division and, at sigma > 0, the noise as K1 counts it
    per (client, element) — the index hash, two murmur finalisers and two
    shifts (30 integer operations), 30 f32 operations and 5 on the
    special-function units — plus its multiply and add (2 f32)."""
    ops = {"fp32": d * (1 + (32 if sigma else 0))}
    if sigma:
        ops.update(int=d * 30, sfu=d * 5)
    return 8 * d, ops


def flash_work(b: int, h: int, t: int, d: int):
    """Per K4 kernel at ``[B, H, T, d]``: ``(bytes, tensor-core operations,
    exps)`` — each input read once and each output written once ([B, H,
    T, d] rows, [B, H, T] m, l, di), the causal half's multiply-adds (2
    operations each: 4 d per visible (query, key) pair forward, 8 d for
    dK/dV, 6 d for dQ) and one exp per visible pair."""
    rows, vecs = 4 * b * h * t * d, 4 * b * h * t
    pairs = b * h * t * (t + 1) / 2
    return {"flash_fwd": (4 * rows + 2 * vecs, 4 * d * pairs, pairs),
            "flash_bwd_dkv": (6 * rows + 3 * vecs, 8 * d * pairs, pairs),
            "flash_bwd_dq": (5 * rows + 3 * vecs, 6 * d * pairs, pairs)}


def flash_bf16_work(b: int, h: int, t: int, d: int):
    """Per bf16 K4 kernel (``flash_fwd_bf16`` ...) at ``[B, H, T, d]``:
    ``(bytes, bf16 tensor-core operations, exps)`` as `flash_work` counts
    them, with the [B, H, T, d] rows at 2 bytes an element (m, l and di
    stay f32).  Their bound is the larger of the bytes over 3.35 TB/s,
    the products over the 989.4 TF/s bf16 rate and the exps over the
    SFU."""
    rows, vecs = 2 * b * h * t * d, 4 * b * h * t
    f32 = flash_work(b, h, t, d)
    return {f"{name}_bf16": (n_rows * rows + n_vecs * vecs, ops, pairs)
            for (name, (_, ops, pairs)), (n_rows, n_vecs) in zip(
                f32.items(), ((4, 2), (6, 3), (5, 3)))}


def kernel_flops(name: str, **shape) -> float:
    """Floating-point operations of one call of a hand-written kernel
    (or of the eager elementwise passes around them), from the work table
    above: the f32 arithmetic each counts (integer hashing and the
    special-function units' conversions are not FLOPs).

    * ``robust_agg`` (K1): ``n``, ``sizes``, ``sigma``;
    * ``clip_norm`` (K1n): ``n``, ``sizes``;
    * ``secagg_mask`` (K3): ``rows``, ``n``, ``d``;
    * ``shard_finalize`` (K2): ``d``, ``sigma`` — the f32 part of
      ``shard_finalize_bounds``: the division, and at sigma > 0 the
      Gaussian's 30 f32 operations (as K1 counts them) plus its multiply
      and add;
    * ``flash_fwd``/``flash_bwd_dkv``/``flash_bwd_dq`` (K4) and their
      ``_bf16`` kernels: ``b``, ``h``, ``t``, ``d``;
    * ``stream_fold``: ``d``, ``clip`` — one multiply-add per element,
      and under a clip the norm pass (subtract, square, add) and the clip
      (subtract, multiply-add);
    * ``stream_finalize``: ``d``, ``sigma`` — the eager divide and noise,
      counted as K2's;
    * ``arena_screen``: ``d`` — the ingest arena's sum of squares
      (subtract, square, add; the finite check is no FLOP).
    """
    if name == "robust_agg":
        return float(robust_agg_work(shape["n"], shape["sizes"],
                                     shape["sigma"])[1]["fp32"])
    if name == "clip_norm":
        return float(clip_norm_work(shape["n"], shape["sizes"])[1]["fp32"])
    if name == "secagg_mask":
        return float(secagg_mask_work(shape["rows"], shape["n"],
                                      shape["d"])[1]["fp32"])
    if name in ("shard_finalize", "stream_finalize"):
        return float(shard_finalize_bounds(shape["d"],
                                           shape["sigma"])[1]["fp32"])
    if name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        return float(flash_work(shape["b"], shape["h"], shape["t"],
                                shape["d"])[name][1])
    if name in ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"):
        return float(flash_bf16_work(shape["b"], shape["h"], shape["t"],
                                     shape["d"])[name][1])
    if name == "stream_fold":
        return float(shape["d"] * (2 + (6 if shape["clip"] else 0)))
    if name == "arena_screen":
        return float(3 * shape["d"])
    raise KeyError(f"no work-table entry for {name!r}")


# ---------------------------------------------------------------------------
# call signatures (the observable projection of what keys a build)
# ---------------------------------------------------------------------------

def _leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def call_signature(args, kwargs=None) -> Tuple[tuple, ...]:
    """Flat shape/dtype tokens for a call's arguments: two calls with
    equal signatures need nothing new built, and a signature CHANGE names
    what did.  Tokens are raw ``(dtype_name, shape)`` tuples (rendered
    only when a compile or a verdict happens); Python scalars token by
    TYPE only, so a round index passed as a plain int never mints a new
    signature."""
    toks = []
    for leaf in _leaves((args, kwargs or {}), []):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            name = str(getattr(dtype, "name", dtype))
            toks.append((name.replace("torch.", ""),
                         tuple(int(d) for d in shape)))
        elif isinstance(leaf, (bool, int, float, complex)):
            toks.append((type(leaf).__name__, ()))
        else:
            toks.append((f"{type(leaf).__name__}={leaf!r}"[:32], None))
    return tuple(toks)


def _format_token(tok) -> str:
    if isinstance(tok, str):
        return tok
    name, shape = tok
    if shape is None:
        return name
    return f"{name}[{','.join(str(d) for d in shape)}]"


def format_signature(sig) -> str:
    return ",".join(_format_token(t) for t in sig)


def signature_diff(prev, cur, max_parts: int = 4) -> str:
    """Human-readable diff between two call signatures, naming each leaf
    whose shape/dtype changed (the actionable half of a recompile
    warning)."""
    if prev is None or cur is None:
        return ""
    prev, cur = tuple(prev), tuple(cur)
    parts = []
    if len(prev) != len(cur):
        parts.append(f"arg arity {len(prev)} -> {len(cur)} leaves")
    for i, (a, b) in enumerate(zip(prev, cur)):
        if a != b:
            parts.append(f"arg leaf[{i}]: {_format_token(a)} -> "
                         f"{_format_token(b)}")
    if len(parts) > max_parts:
        parts = parts[:max_parts] + [f"... {len(parts) - max_parts} more"]
    return "; ".join(parts)


def _cuda_tensors(tree) -> List:
    return [x for x in _leaves(tree, [])
            if getattr(x, "is_cuda", False)]


# ---------------------------------------------------------------------------
# per-device memory
# ---------------------------------------------------------------------------

def device_memory_snapshot(device=None) -> Optional[List[dict]]:
    """The memory of the one card a CUDA ``device`` names (every run of
    the port trains on one card; the other visible cards are not touched,
    so no CUDA context is made on them): the caching allocator's
    ``memory_stats`` (allocated bytes now and at their peak) and the
    card's total from ``mem_get_info``, as a one-entry list.  **None** on
    the CPU (and wherever CUDA is not initialised): the ledger then
    carries ``memory: null``, never a fabricated 0."""
    try:
        import torch
    except ImportError:
        return None
    if device is None or torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    try:
        stats = torch.cuda.memory_stats(idx)
        _, total = torch.cuda.mem_get_info(idx)
    except RuntimeError:
        return None
    in_use = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    entry = {"id": idx, "platform": "cuda",
             "kind": torch.cuda.get_device_name(idx),
             "source": "memory_stats",
             "bytes_in_use": None if in_use is None else int(in_use),
             "peak_bytes": None if peak is None else int(peak),
             "bytes_limit": int(total)}
    if in_use is not None and total:
        entry["utilization"] = float(in_use) / float(total)
    return [entry]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class DeviceRecorder:
    """Round-cadence device/compile accounting behind `PerfRecorder`.

    ``instrument(name, fn)`` wraps a hot callable: each call is
    signature-tagged (fed to the sentry so a recompile warning names the
    changed argument), calls that built something land in the round's
    compile ledger with their wall time, and every call's FLOPs (counted
    once per new signature, or from ``flops=``) accumulate into the round
    total the MFU gauge is computed from.  The wrapper forwards
    ``_cache_size`` so sentry registration keeps working through it.

    ``device``: the run's torch device — CUDA gives the memory section
    and the peak of that card; the CPU gives ``memory: null`` and the
    default peak.

    Thread-safety: folds and admissions run on receive threads while the
    round closes on the event loop — all round state is lock-guarded.
    Telemetry: non-monotonic measurements wear ``_bytes``/``_ratio``/
    ``_value``; ``fedml_dev_compiles_total`` is the one true counter.
    """

    def __init__(self, registry=None, cost_analysis: bool = True,
                 peak_tflops: Optional[float] = None, device=None,
                 mesh=None):
        reg = registry if registry is not None else telemetry.get_registry()
        self._registry = reg
        self.cost_analysis = cost_analysis
        self.device = device
        # every rank of the mesh reads the section together (a collective)
        self.mesh = mesh
        self._mesh_cards: Optional[int] = None
        self._lock = threading.Lock()
        self._peak_tflops = peak_tflops
        self._peak_source = ("explicit peak_tflops argument"
                             if peak_tflops is not None else None)
        # lifetime state; a None flops value is an in-flight reservation
        # (another thread is counting the same signature)
        self._flops: Dict[Tuple[str, tuple], Optional[float]] = {}
        self._seen_sigs: Dict[str, set] = {}
        self._compile_sizes: Dict[str, set] = {}  # probe sizes observed
        #                                           THIS ROUND per fn
        # round state
        self._round_compiles: List[dict] = []
        self._round_calls: Dict[str, int] = {}
        self._round_flops = 0.0
        self._round_flops_complete = True
        self._round_mem_peak: Dict[int, int] = {}
        # telemetry handles, created lazily on first measurement: a gauge
        # registered at construction would export a fabricated 0.0
        self._c_compiles: Dict[str, object] = {}
        self._h_compile: Dict[str, object] = {}
        self._g_mem: Dict[Tuple[int, str], object] = {}
        self._g_util = self._g_flops = self._g_mfu = None

    def _is_cuda(self) -> bool:
        if self.device is None:
            return False
        try:
            import torch
            return torch.device(self.device).type == "cuda"
        except (RuntimeError, TypeError, ValueError):
            return False

    # -- peak / backend resolution -------------------------------------------
    def _resolve_peak(self) -> None:
        if self._peak_tflops is not None:
            return
        # the round's work runs on the recorder's one card, so the
        # denominator is that card's peak
        dev = self.device if self._is_cuda() else None
        self._peak_tflops = peak_tflops_for_device(dev)
        self._peak_source = peak_source_for_device(dev)

    def backend(self) -> str:
        return "cuda" if self._is_cuda() else "cpu"

    # -- instrumentation -----------------------------------------------------
    def instrument(self, name: str, fn: Callable, sentry=None,
                   sentry_name: Optional[str] = None,
                   flops: Optional[Callable] = None) -> Callable:
        """Wrap a hot callable with compile-ledger + FLOPs accounting;
        returns the callable to use in its place.  ``sentry``: a
        `RecompileSentry` every call's signature is noted in, under
        ``sentry_name`` when the fn is registered under another name than
        its ledger label.  ``flops(*args, **kwargs)``: the call's FLOPs
        from the kernel work table, for callables whose work the flop
        counter cannot see."""
        probe = getattr(fn, "_cache_size", None)
        note_as = sentry_name or name
        with self._lock:
            self._seen_sigs.setdefault(name, set())

        def wrapped(*args, **kwargs):
            sig = call_signature(args, kwargs)
            if sentry is not None:
                sentry.note_signature(note_as, sig)
            key = (name, sig)
            count = False
            if self.cost_analysis:
                with self._lock:
                    # reserve the key BEFORE calling: concurrent first
                    # calls must count once, not once per thread
                    if key not in self._flops:
                        self._flops[key] = None
                        count = True
            counted = None
            before = None
            if probe is not None:
                try:
                    before = int(probe())
                except Exception:  # noqa: BLE001 — fn mid-teardown
                    pass
            t0 = time.perf_counter()
            try:
                if count and flops is None and not _capturing():
                    with _flop_counter() as fc:
                        out = fn(*args, **kwargs)
                    counted = float(fc.get_total_flops())
                else:
                    out = fn(*args, **kwargs)
            except BaseException:
                if count:
                    # a failed first call must not disable counting for
                    # this signature forever
                    with self._lock:
                        if self._flops.get(key) is None:
                            self._flops.pop(key, None)
                raise
            if count and flops is not None:
                counted = float(flops(*args, **kwargs))
            if count and counted is None:
                # inside a capture: count on a later eager call
                with self._lock:
                    if self._flops.get(key) is None:
                        self._flops.pop(key, None)
            # compile detection: probe growth where the probe exists,
            # first sight of the signature where it doesn't
            compiled = sig not in self._seen_sigs[name]
            if probe is not None and before is not None:
                try:
                    compiled = int(probe()) > before
                except Exception:  # noqa: BLE001
                    pass
            if compiled:
                # synchronise only on a build: its wall time must not
                # hide behind asynchronous launches
                _synchronize((args, kwargs, out))
            dt = time.perf_counter() - t0
            self._note_call(name, sig, dt, compiled, probe, counted)
            return out

        if probe is not None:
            wrapped._cache_size = probe
        wrapped.__wrapped__ = fn
        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    def _note_call(self, name, sig, dt, compiled, probe, flops) -> None:
        size = None
        if compiled and probe is not None:
            try:
                size = int(probe())
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._seen_sigs.setdefault(name, set()).add(sig)
            self._round_calls[name] = self._round_calls.get(name, 0) + 1
            key = (name, sig)
            if flops is not None and self._flops.get(key) is None:
                self._flops[key] = flops  # fill the in-flight reservation
            known = self._flops.get(key)
            if known is not None and known > 0:
                self._round_flops += known
            else:
                self._round_flops_complete = False
            if compiled and size is not None:
                # concurrent first calls can both observe "the probe grew
                # to N" for ONE build: only the first observation of each
                # size per fn per round is a compile event
                seen = self._compile_sizes.setdefault(name, set())
                if size in seen:
                    compiled = False
                else:
                    seen.add(size)
            if compiled:
                entry = {"fn": name, "wall_s": round(dt, 6),
                         "signature": format_signature(sig)}
                if size is not None:
                    entry["cache_size"] = size
                if known is not None:
                    entry["flops"] = known
                self._round_compiles.append(entry)
        if compiled:
            c = self._c_compiles.get(name)
            if c is None:
                c = self._registry.counter("fedml_dev_compiles_total",
                                           fn=name)
                self._c_compiles[name] = c
            c.inc()
            h = self._h_compile.get(name)
            if h is None:
                h = self._registry.histogram("fedml_dev_compile_seconds",
                                             fn=name)
                self._h_compile[name] = h
            h.observe(dt)

    # -- memory --------------------------------------------------------------
    def sample_memory(self) -> Optional[List[dict]]:
        """One memory snapshot, folded into the round's per-device
        watermark."""
        snap = device_memory_snapshot(self.device)
        if snap:
            with self._lock:
                for e in snap:
                    b = e.get("bytes_in_use")
                    if b is None:
                        continue
                    if b > self._round_mem_peak.get(e["id"], -1):
                        self._round_mem_peak[e["id"]] = b
        return snap

    # -- round lifecycle -----------------------------------------------------
    def round_start(self) -> None:
        with self._lock:
            self._round_compiles = []
            self._round_calls = {}
            self._round_flops = 0.0
            self._round_flops_complete = True
            self._round_mem_peak = {}
            self._compile_sizes = {}
        self.sample_memory()

    _MESH_FIELDS = ("id", "bytes_in_use", "peak_bytes", "bytes_limit",
                    "round_peak_bytes")

    def _mesh_memory(self, mem: Optional[List[dict]]):
        """Every rank's memory entry (``id`` the rank, ``card`` its CUDA
        index) from one ``all_reduce`` over the mesh's world, and the
        number of distinct cards; ``(None, 1)`` when no rank measured."""
        import torch
        mesh = self.mesh
        n = len(self._MESH_FIELDS) + 1
        # row r: rank r's fields + 1, 0 where unmeasured; the last column
        # marks a rank that measured
        vec = torch.zeros((mesh.world_size, n), dtype=torch.int64)
        e = mem[0] if mem else None
        if e is not None:
            vec[mesh.rank, :-1] = torch.tensor(
                [-1 if e.get(f) is None else int(e[f]) for f in
                 self._MESH_FIELDS], dtype=torch.int64) + 1
            vec[mesh.rank, -1] = 1
        rows = mesh.allsum(vec.to(mesh.device), mesh.axis_names).cpu()
        out = []
        for r, row in enumerate(rows.tolist()):
            if not row[-1]:
                continue
            f = {k: (None if v == 0 else v - 1)
                 for k, v in zip(self._MESH_FIELDS, row)}
            entry = {"id": r, "card": f["id"], "platform": "cuda",
                     "kind": torch.cuda.get_device_name(f["id"]),
                     "source": "memory_stats",
                     **{k: f[k] for k in self._MESH_FIELDS[1:]
                        if f[k] is not None or k != "round_peak_bytes"}}
            if f["bytes_in_use"] is not None and f["bytes_limit"]:
                entry["utilization"] = (float(f["bytes_in_use"])
                                        / float(f["bytes_limit"]))
            out.append(entry)
        cards = len({e["card"] for e in out}) or 1
        return out or None, cards

    def round_snapshot(self, round_s: Optional[float]) -> dict:
        """Close the round: one ledger-ready ``device`` section.  Every
        unmeasurable quantity is ``null`` — never 0."""
        self._resolve_peak()
        mem = self.sample_memory()
        with self._lock:
            compiles = list(self._round_compiles)
            calls = dict(self._round_calls)
            flops = self._round_flops
            complete = self._round_flops_complete
            peaks = dict(self._round_mem_peak)
        if mem:
            for e in mem:
                if e["id"] in peaks:
                    e["round_peak_bytes"] = peaks[e["id"]]
        total = None
        if self.mesh is not None:
            mem, cards = self._mesh_memory(mem)
            if self._mesh_cards is None:
                self._mesh_cards = cards
                self._peak_tflops *= cards
                self._peak_source += f" x {cards} cards of the mesh"
            if mem:
                total = {k: sum(e[k] for e in mem if e.get(k) is not None)
                         for k in ("bytes_in_use", "peak_bytes",
                                   "round_peak_bytes")}
        achieved = mfu = None
        if flops > 0 and round_s:
            achieved = flops / float(round_s)
            mfu = achieved / (self._peak_tflops * 1e12)
        section = {
            "backend": self.backend(),
            "memory": mem,
            **({} if self.mesh is None else {"memory_total": total}),
            "compiles": compiles,
            "jit_calls": calls,
            "flops": flops if flops > 0 else None,
            "achieved_flops_per_s": achieved,
            "mfu": mfu,
            "peak_tflops": self._peak_tflops,
            "peak_source": self._peak_source,
            "mfu_provenance": MFU_PROVENANCE,
        }
        if calls:
            section["flops_complete"] = complete
        for e in mem or []:
            for field, label in (("bytes_in_use", "in_use"),
                                 ("round_peak_bytes", "peak")):
                v = e.get(field)
                if v is None:
                    continue
                gkey = (e["id"], label)
                g = self._g_mem.get(gkey)
                if g is None:
                    # literal names: the metric-name lint pins these
                    if label == "in_use":
                        g = self._registry.gauge(
                            "fedml_dev_mem_in_use_bytes",
                            device=str(e["id"]))
                    else:
                        g = self._registry.gauge(
                            "fedml_dev_mem_peak_bytes",
                            device=str(e["id"]))
                    self._g_mem[gkey] = g
                g.set(v)
        utils = [e["utilization"] for e in mem or [] if "utilization" in e]
        if utils:
            if self._g_util is None:
                self._g_util = self._registry.gauge(
                    "fedml_dev_mem_utilization_ratio")
            self._g_util.set(max(utils))
        if achieved is not None:
            if self._g_flops is None:
                self._g_flops = self._registry.gauge(
                    "fedml_dev_achieved_flops_value")
                self._g_mfu = self._registry.gauge("fedml_perf_mfu_ratio")
            self._g_flops.set(achieved)
            self._g_mfu.set(mfu)
        return section


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None, **_kw) -> int:
    """``aten.convolution_backward``'s FLOPs with the weight gradient of a
    grouped convolution divided by its groups.  PyTorch's own formula
    counts that term as if every output channel met every input channel,
    which over-counts a depthwise convolution, and a convolution under
    ``vmap`` (the clients of a wave become the groups), by the group
    count; the input gradient's count is PyTorch's."""
    from torch.utils.flop_counter import conv_flop_count

    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape,
                                 list(out_shape[0]), not transposed)
    if output_mask[1]:
        gw = list(out_shape[1])
        n = (conv_flop_count(t(grad_out_shape), t(x_shape), t(gw))
             if transposed else
             conv_flop_count(t(x_shape), t(grad_out_shape), t(gw)))
        flops += n // groups
    return flops


def _flop_counter():
    """A ``FlopCounterMode`` with the grouped weight-gradient count."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})


def _capturing() -> bool:
    """True inside a CUDA-graph capture (never count FLOPs there)."""
    try:
        import torch
        return bool(torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing())
    except (ImportError, RuntimeError):
        return False


def _synchronize(tree) -> None:
    """Wait for the devices of the CUDA tensors in ``tree``."""
    tensors = _cuda_tensors(tree)
    if not tensors:
        return
    import torch
    for dev in {t.device for t in tensors}:
        torch.cuda.synchronize(dev)
