"""Performance flight recorder: the per-round cost breakdown (the port's
copy of ``fedml_tpu/obs/perf.py``, same ledger schema and phase names).

Three instruments, stdlib-only like the rest of `obs/`:

* **`PerfRecorder`** — one structured ``perf.jsonl`` line per completed
  round/version: phase wall-times (broadcast serialize, straggler wait,
  admission, defended aggregate, checkpoint, publish), wire bytes
  in/out (deltas of the comm byte counters), the round's **peak host
  RSS watermark**, and the recompile count.  Each line is formatted
  fully before ONE ``write()`` call on an O_APPEND descriptor, so a
  crash can tear at most the final line — which every reader here
  (`trend.load_ledger`, `report.load_jsonl`) already tolerates.
* **`RssSampler`** — a daemon thread sampling ``VmRSS`` from
  ``/proc/self/status`` (no new deps); ``reset_peak()`` gives per-round
  watermarks.
* **`RecompileSentry`** — tracks the ``_cache_size`` probes of
  registered hot callables.  In the port a probe counts what a callable
  BUILT for a new signature: CUDA-graph captures
  (`parallel.cohort.GraphedRounds`), kernel libraries loaded
  (`utils.cuda_build`), the signatures a plain callable has seen.  Growth after the first check is a RECOMPILE:
  counted in ``fedml_perf_recompiles_total``, warned in production,
  and raised as `RecompileError` under ``strict`` (test mode).

`SloEvaluator` sits on top of the telemetry registry: rolling SLO
values (round-duration p95, serve shed rate, torn-frame rate,
quarantine events per round, device-memory headroom) exported as
``fedml_slo_*`` gauges with a per-SLO breach counter; it backs the
serve frontend's ``/healthz?deep=1`` mode (200 while every SLO holds,
503 on breach).

A `fedml_tpu_torch.obs.device.DeviceRecorder` attaches via ``device=``: each
ledger line then carries a ``device`` section (per-device memory
watermarks, the round's named compile ledger, achieved-FLOP/s and an
honest MFU) and the sentry's recompile verdicts name the arg
shape/dtype that changed.  Ledgers without the section keep validating
— the device observatory is additive.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Callable, Dict, Optional

from fedml_tpu_torch.obs import critical_path as _cpath
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.obs.health import HEALTH_SLOS
from fedml_tpu_torch.utils.journal import durable_append

log = logging.getLogger(__name__)

# the canonical phase vocabulary (a ledger line may carry a subset —
# e.g. no checkpoint phase on rounds the save_every gate skips; the
# aggregate span is named by what ran: "defended_aggregate" only when a
# make_defended_aggregate product is wired, plain "aggregate" otherwise,
# so a defended run never compares against an undefended baseline under
# one label)
PHASES = ("broadcast_serialize", "straggler_wait", "staging", "fold",
          "admission", "health", "aggregate", "defended_aggregate",
          "checkpoint", "publish",
          # secure aggregation (secure/protocol.py): advert/roster relay
          # time and the barrier-close share-reveal + reconstruction.
          # Phase names are open vocabulary to every reader
          # (trend.phase_medians keys on whatever a ledger carries), so
          # pre-secagg ledgers keep validating and gating unchanged.
          "mask_agreement", "unmask",
          # crash consistency (utils/journal.py): the durable round
          # journal's record appends + periodic fold-state snapshots on
          # the receive path — host-side I/O, never a trace
          "journal",
          # cross-device mega-cohort engine (algorithms/cross_device.py):
          # one compiled wave's gather + train + summary, accumulated
          # across the round's waves (fold/admission/health keep their
          # own phases, shared with the actor paths)
          "wave",
          # sharded global-model spine (shard_spine): the
          # per-shard defended finalize (one eager program or one K2
          # launch per shard) gets its OWN label so the trend
          # gate never compares a sharded round against a replicated
          # baseline under one name; fold/admission/journal phases are
          # shared with the replicated path
          "shard_finalize",
          # ingest observatory (obs/critical_path.py): per-upload codec
          # decode on the server receive path — its own label so the
          # attribution sweep can separate wire-format cost from fold
          "decode")


# ---------------------------------------------------------------------------
# RSS watermark sampler
# ---------------------------------------------------------------------------

def read_rss_bytes() -> Optional[int]:
    """Current resident set size from ``/proc/self/status`` (VmRSS).
    Returns None where /proc is unavailable (non-Linux) — the recorder
    then ledgers ``rss: null`` instead of guessing."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024  # kB -> bytes
    except OSError:
        return None
    return None


class RssSampler:
    """Daemon thread tracking the peak of ``read_rss_bytes()``.

    ``reset_peak()`` returns the watermark since the previous reset and
    restarts it from the CURRENT value — the per-round watermark
    protocol.  ``start``/``stop`` are idempotent and ``stop`` joins the
    thread, so owners can assert no thread leaks."""

    def __init__(self, interval_s: float = 0.05):
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._peak: Optional[int] = None
        self._current: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Optional[int]:
        rss = read_rss_bytes()
        if rss is not None:
            with self._lock:
                self._current = rss
                if self._peak is None or rss > self._peak:
                    self._peak = rss
        return rss

    @property
    def peak_bytes(self) -> Optional[int]:
        with self._lock:
            return self._peak

    def reset_peak(self) -> Optional[int]:
        """Return the watermark since the last reset; restart it from a
        fresh sample (never carry a stale peak into the next round)."""
        rss = read_rss_bytes()
        with self._lock:
            out = self._peak
            self._peak = self._current = rss
        return out

    def start(self) -> "RssSampler":
        if self._thread is not None or read_rss_bytes() is None:
            return self
        self._stop.clear()
        self.sample()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="perf-rss-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# recompile sentry
# ---------------------------------------------------------------------------

class RecompileError(RuntimeError):
    """Strict-mode verdict: a registered hot function recompiled after
    its baseline round — a silent perf regression, not a crash."""


class RecompileSentry:
    """Track jit cache sizes of registered hot functions.

    The FIRST ``check()`` per function records its baseline (round-0
    compiles are expected); later checks count any GROWTH as recompiles:
    ``fedml_perf_recompiles_total`` ticks, production warns, ``strict``
    raises `RecompileError`.  A shrunk cache (explicit clear) re-baselines
    silently.

    When the device observatory wraps a registered function
    (`obs.device.DeviceRecorder.instrument`), every call's arg
    shape/dtype signature lands here via ``note_signature`` — a firing
    verdict then NAMES the arg that changed instead of reporting a bare
    count, turning "something retraced" into an actionable diff."""

    def __init__(self, strict: bool = False, registry=None):
        self.strict = strict
        self._fns: Dict[str, Callable] = {}
        self._baseline: Dict[str, int] = {}
        # last two DISTINCT call signatures per fn (note_signature): the
        # observable projection of the jit cache key the verdict diffs
        self._sig_cur: Dict[str, tuple] = {}
        self._sig_prev: Dict[str, tuple] = {}
        reg = registry if registry is not None else telemetry.get_registry()
        self._c_recompiles = reg.counter("fedml_perf_recompiles_total")

    def register(self, name: str, fn) -> bool:
        """Register a hot function; returns False (and stays silent at
        check time) when it exposes no ``_cache_size`` probe."""
        if getattr(fn, "_cache_size", None) is None:
            log.debug("recompile sentry: %r has no _cache_size; skipped",
                      name)
            return False
        self._fns[name] = fn
        return True

    def note_signature(self, name: str, sig) -> None:
        """Record a registered fn's latest call signature (fed by the
        device observatory's wrappers).  Only the last two distinct
        signatures are kept — exactly what a recompile diff needs."""
        sig = tuple(sig)
        cur = self._sig_cur.get(name)
        if cur is not None and cur != sig:
            self._sig_prev[name] = cur
        self._sig_cur[name] = sig

    def signature_change(self, name: str) -> str:
        """The prev -> cur call-signature diff for ``name`` ("" when no
        change was observed or signatures were never fed)."""
        prev, cur = self._sig_prev.get(name), self._sig_cur.get(name)
        if prev is None or cur is None or prev == cur:
            return ""
        from fedml_tpu_torch.obs.device import signature_diff
        return signature_diff(prev, cur)

    def names(self):
        return sorted(self._fns)

    def cache_sizes(self) -> Dict[str, int]:
        out = {}
        for name, fn in self._fns.items():
            try:
                out[name] = int(fn._cache_size())
            except Exception:  # noqa: BLE001 — fn mid-teardown
                continue
        return out

    def check(self, round_idx) -> Dict[str, int]:
        """Returns ``{fn_name: new_entries}`` for functions that
        recompiled since the last check (empty on a clean round)."""
        events: Dict[str, int] = {}
        for name, size in self.cache_sizes().items():
            prev = self._baseline.get(name)
            self._baseline[name] = size
            if prev is None or prev == 0 or size <= prev:
                # baseline round; an empty-cache baseline (the fn was
                # registered but not yet CALLED — e.g. round 0 closed
                # with no admissible uploads, so its first compile lands
                # later and is not a REcompile); or an explicit clear
                continue
            events[name] = size - prev
        total = sum(events.values())
        if total:
            self._c_recompiles.inc(total)
            parts = []
            for k, v in sorted(events.items()):
                part = f"{k}:+{v}"
                diff = self.signature_change(k)
                if diff:
                    part += f" [{diff}]"
                # consume the diff: it explains THIS verdict only — a
                # later same-signature rebuild must not be decorated with a
                # stale, unrelated shape change
                self._sig_prev.pop(k, None)
                parts.append(part)
            detail = ", ".join(parts)
            msg = (f"recompile sentry: round {round_idx}: {total} new jit "
                   f"cache entr{'y' if total == 1 else 'ies'} after the "
                   f"baseline round ({detail}) — a hot function is "
                   f"retracing every round")
            if self.strict:
                raise RecompileError(msg)
            log.warning(msg)
        return events


# ---------------------------------------------------------------------------
# the per-round ledger
# ---------------------------------------------------------------------------

class _PhaseTimer:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "PerfRecorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.add_phase(self._name, time.perf_counter() - self._t0)
        return False


# wire accounting: both byte-counter families carry ``link="src->dst"``
# labels (gRPC/MQTT count send_bytes, the codec-roundtrip hub counts
# wire_bytes), so the ledger splits them by DIRECTION relative to the
# recording node: out = links leaving it, in = links entering it.  The
# split is honest per process — a registry only holds what its own
# transports counted, so on multi-process wires (gRPC) inbound bytes
# read 0 until a receive path counts them; the in-process hub sees both
# directions of every link.
_BYTE_FAMILIES = ("fedml_comm_send_bytes_total",
                  "fedml_comm_wire_bytes_total")
_LINK_RE = re.compile(r'link="([^"]*)->([^"]*)"')


class PerfRecorder:
    """Own the round lifecycle: ``round_start`` → ``phase(...)`` spans /
    ``add_phase`` accumulations → ``round_end`` writes one ledger line.

    Thread-safety: phase accumulation may run on receive threads
    (admission screens in `_on_model`) while the round closes on the
    event loop — the accumulator dict is lock-guarded.  The ledger file
    is opened per line in append mode and written with ONE ``write()``
    call, so concurrent writers (a sync server and an async server
    sharing a run dir would be a misconfiguration anyway) can interleave
    lines but never interleave bytes of a line on POSIX O_APPEND."""

    def __init__(self, path: Optional[str], node: str = "server",
                 rss_interval_s: float = 0.05, strict_recompiles: bool = False,
                 registry=None, node_index: int = 0, device=None):
        self.path = path
        # optional device & compile observatory (obs/device.DeviceRecorder):
        # when attached, every ledger line gains a ``device`` section —
        # per-device memory watermarks, the round's named compile ledger,
        # and the honest MFU gauge (readers without it keep validating)
        self.device = device
        self.node = node
        self.node_index = node_index  # wire-byte direction split anchor
        # path None: record without a ledger file (a mesh rank other than
        # the one that writes)
        d = os.path.dirname(path) if path else ""
        if d:
            os.makedirs(d, exist_ok=True)
        # one ledger == one run: a leftover file from a previous run at
        # the same path would splice two runs together — the second
        # run's compile-paying round 0 lands mid-file, poisoning the
        # trend gate's skip-first-round medians and the recompile gate's
        # baseline-row forgiveness.  Rotate it aside instead of
        # appending (or silently destroying a crashed run's evidence).
        if path and os.path.exists(path):
            os.replace(path, path + ".prev")
        reg = registry if registry is not None else telemetry.get_registry()
        self._registry = reg
        self.sentry = RecompileSentry(strict=strict_recompiles, registry=reg)
        self.rss = RssSampler(interval_s=rss_interval_s)
        self._lock = threading.Lock()
        self._phases: Dict[str, float] = {}
        self._round: Optional[int] = None
        self._round_t0: Optional[float] = None
        self._wire0 = (0.0, 0.0)
        self._g_rss = reg.gauge("fedml_perf_rss_peak_bytes")
        self._c_rounds = reg.counter("fedml_perf_rounds_total")
        self._h_phase: Dict[str, object] = {}
        self._closed = False
        self._ledger_disabled = path is None
        # round critical-path observatory (obs/critical_path.py): armed
        # per round in round_start, reduced into the line's
        # ``critical_path`` record at round_end — every ledger line
        # carries one, on every algorithm that rides this recorder
        self.cpath: Optional[_cpath.RoundCriticalPath] = None
        self._ingest = _cpath.IngestGauges(reg)

    # -- registration --------------------------------------------------------
    def register_jit(self, name: str, fn) -> bool:
        """Register a hot function with the recompile sentry."""
        return self.sentry.register(name, fn)

    def instrument_jit(self, name: str, fn, flops=None):
        """Register ``fn`` with the recompile sentry AND — when the
        device observatory is attached — wrap it with compile-ledger +
        FLOPs instrumentation.  Returns the callable the caller should
        use in ``fn``'s place (``fn`` itself when no device recorder is
        on; the wrapper forwards the ``_cache_size`` probe either way).
        ``flops``: the call's FLOPs from the kernel work table
        (`obs.device.kernel_flops`), for work the flop counter cannot
        see."""
        self.sentry.register(name, fn)
        if self.device is not None:
            fn = self.device.instrument(name, fn, sentry=self.sentry,
                                        flops=flops)
        return fn

    # -- wire accounting -----------------------------------------------------
    def _wire_totals(self):
        counters = self._registry.snapshot().get("counters", {})
        me = str(self.node_index)
        out = inn = 0.0
        for series, v in counters.items():
            if not series.startswith(_BYTE_FAMILIES):
                continue
            m = _LINK_RE.search(series)
            if m is None:
                continue  # unlabeled byte series: direction unknowable
            if m.group(1) == me:
                out += v
            elif m.group(2) == me:
                inn += v
        return out, inn

    # -- round lifecycle -----------------------------------------------------
    def round_start(self, round_idx) -> None:
        if self._round is None:
            self.rss.start()
        with self._lock:
            self._phases = {}
        self._round = round_idx
        self._round_t0 = time.perf_counter()
        self.cpath = _cpath.RoundCriticalPath(t0=self._round_t0)
        self.rss.reset_peak()
        self._wire0 = self._wire_totals()
        if self.device is not None:
            self.device.round_start()

    def phase(self, name: str) -> _PhaseTimer:
        """Context manager accumulating wall time into the current
        round's ``name`` phase (re-entering the same phase ADDS — the
        admission screen runs once per upload)."""
        return _PhaseTimer(self, name)

    def add_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            self._phases[name] = self._phases.get(name, 0.0) + float(seconds)
        # every caller follows the measure-then-add idiom (the sample
        # ENDED now), so the critical-path accumulator gets an honest
        # ``[now - seconds, now)`` interval for the overlap sweep
        cp = self.cpath
        if cp is not None:
            cp.note(name, float(seconds))

    def note_arrival(self) -> None:
        """One upload landed off the wire (receive-path handlers call
        this): stamps the critical-path arrival timeline that classifies
        the round's idle time into network/straggler/barrier_wait."""
        cp = self.cpath
        if cp is not None:
            cp.note_arrival()

    def round_end(self, round_idx, **extra) -> Optional[dict]:
        """Close the round: sentry check, RSS watermark, wire deltas,
        one ledger line.  Returns the line dict (None when no round was
        open).  ``extra`` lands verbatim in the line (quorum size,
        version tags, ...)."""
        if self._round is None:
            return None
        # the sentry runs FIRST so a strict-mode RecompileError fires
        # before a misleading clean line could be written
        recompile_events = self.sentry.check(round_idx)
        rss_peak = self.rss.reset_peak()
        self.rss.sample()
        rss_now = self.rss.peak_bytes
        wire1 = self._wire_totals()
        with self._lock:
            phases = dict(self._phases)
            self._phases = {}
        round_s = (time.perf_counter() - self._round_t0
                   if self._round_t0 is not None else None)
        self._round = None
        line = {
            "round": round_idx,
            "ts": time.time(),
            "node": self.node,
            "round_s": round_s,
            "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
            "wire": {"bytes_out": int(wire1[0] - self._wire0[0]),
                     "bytes_in": int(wire1[1] - self._wire0[1])},
            "rss": (None if rss_peak is None else
                    {"peak_bytes": int(rss_peak),
                     "current_bytes": None if rss_now is None
                     else int(rss_now)}),
            "recompiles": sum(recompile_events.values()),
            "jit_cache_sizes": self.sentry.cache_sizes(),
        }
        if recompile_events:
            line["recompiled"] = recompile_events
        if self.device is not None:
            line["device"] = self.device.round_snapshot(round_s)
        line.update(extra)
        cp, self.cpath = self.cpath, None
        if cp is not None:
            # known compile wall time (device observatory's per-round
            # compile ledger) is carved into the ``compile`` bucket
            compile_s = sum(
                float(e.get("wall_s") or 0.0)
                for e in (line.get("device") or {}).get("compiles") or ()
                if isinstance(e, dict))
            record = cp.finalize(duration=round_s, compile_s=compile_s)
            line["critical_path"] = record
            self._ingest.export(record, line["wire"]["bytes_in"])
        self._write(line)
        self._c_rounds.inc()
        if rss_peak is not None:
            self._g_rss.set(rss_peak)
        for name, dt in phases.items():
            h = self._h_phase.get(name)
            if h is None:
                h = self._registry.histogram("fedml_perf_phase_seconds",
                                             phase=name)
                self._h_phase[name] = h
            h.observe(dt)
        return line

    def _write(self, line: dict) -> None:
        if self._ledger_disabled:
            return
        data = json.dumps(line, sort_keys=True) + "\n"
        # one write() on an O_APPEND fd: a crash tears at most the tail.
        # A disk fault (ENOSPC/EIO — real or injected through the
        # utils.journal seam) must never kill the round loop: warn ONCE
        # and disable the ledger; the lines already on disk stay a valid
        # (truncated) trend-gate input.
        try:
            durable_append(self.path, data, channel="perf_ledger")
        except OSError as e:
            self._ledger_disabled = True
            log.warning("perf ledger append failed (%s); disabling the "
                        "ledger — training continues unledgered", e)

    def close(self) -> None:
        """Stop the sampler thread; safe to call twice.  An open round
        is NOT flushed — a half-measured round would ledger as a
        misleadingly fast one."""
        if self._closed:
            return
        self._closed = True
        self.rss.stop()


# ---------------------------------------------------------------------------
# SLO evaluator
# ---------------------------------------------------------------------------

def histogram_quantile(stats: dict, q: float) -> Optional[float]:
    """Upper-bound quantile estimate from a snapshot histogram dict
    (``{"count": n, "buckets": {bound: count, "+Inf": n_inf}}``): the
    smallest bucket bound whose cumulative count covers ``q`` of the
    observations.  +Inf-bucket answers fall back to the observed max
    (the histogram knows nothing finer).  None on an empty histogram."""
    count = stats.get("count") or 0
    if not count:
        return None
    buckets = stats.get("buckets") or {}
    finite = sorted(((float(b), c) for b, c in buckets.items()
                     if b != "+Inf"), key=lambda x: x[0])
    need = q * count
    cum = 0
    for bound, c in finite:
        cum += c
        if cum >= need:
            return bound
    return stats.get("max")


# default objectives; override per-deployment via the ``--slo`` spec
# ("name=value,...") or the constructor's thresholds dict.  The
# health_* objectives gate on the learning-health gauges the
# `obs/health.HealthAccumulator` exports each round — absent gauges
# (health off) evaluate vacuously healthy, like every other
# traffic-free objective.
DEFAULT_SLOS = {
    "round_duration_p95_seconds": 60.0,   # p95 round wall time
    "serve_shed_rate": 0.05,              # shed / submitted requests
    "torn_frame_rate": 0.01,              # torn frames / received msgs
    "quarantine_rate": 0.5,               # quarantine events / round
    # device-memory headroom (obs/device.py): worst per-device
    # bytes_in_use / bytes_limit the observatory exported last round —
    # breach means the next cohort/model growth OOMs the chip, the exact
    # signal ROADMAP items 1/3 gate on.  Backends without allocator
    # limits (CPU live-arrays fallback) never export the gauge, so the
    # objective evaluates vacuously there.
    "device_mem_utilization_ratio": 0.92,
    # worst-WORKER serve queue fill (the multi-worker serve pool):
    # every MicroBatcher/DecodeScheduler exports qsize/depth as a
    # worker-labeled gauge; the objective reads the MAX across them so
    # one wedged worker breaches even while the pool average looks
    # healthy.  This is also what tiered admission sheds on (via
    # TierGate), so load shedding and deep-healthz always agree.
    "serve_queue_utilization_ratio": 0.9,
    **HEALTH_SLOS,                        # drift alarms (obs/health.py)
}


def parse_slo_spec(spec: str) -> Dict[str, float]:
    """Parse ``"round_duration_p95_seconds=10,serve_shed_rate=0.01"``;
    unknown SLO names fail loudly (a typo'd objective silently never
    evaluating is the exact blindness this module exists to end)."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--slo entries are name=value, got {part!r}")
        name, _, value = part.partition("=")
        name = name.strip()
        if name not in DEFAULT_SLOS:
            raise ValueError(f"unknown SLO {name!r}; available: "
                             f"{sorted(DEFAULT_SLOS)}")
        out[name] = float(value)
    return out


class SloEvaluator:
    """Rolling SLO evaluation over a telemetry registry snapshot.

    ``evaluate()`` computes each objective, exports it as a
    ``fedml_slo_*`` gauge, bumps the per-SLO breach counter when the
    objective is violated, and returns the full verdict dict.  Breach
    counting belongs to the ROUND cadence (the runners' per-round/
    per-version call): query paths — ``healthy()``, the serve frontend's
    ``/healthz?deep=1`` — pass ``count_breaches=False`` so one sustained
    breach counts per round, not per LB probe (a 1 s prober would
    otherwise inflate ``fedml_slo_breaches_total`` ~60x and break any
    "breaches > N" alert threshold)."""

    def __init__(self, registry=None, thresholds: Optional[dict] = None):
        reg = (registry if registry is not None
               else telemetry.get_registry())
        self._registry = reg
        unknown = set(thresholds or {}) - set(DEFAULT_SLOS)
        if unknown:
            raise ValueError(f"unknown SLOs {sorted(unknown)}; available: "
                             f"{sorted(DEFAULT_SLOS)}")
        self.thresholds = {**DEFAULT_SLOS, **(thresholds or {})}
        # literal names: the source-scan metric lint
        # (tests/test_torch_obs_perf.py) pins these series.  The rate
        # gauges wear _ratio, not _total — they go down as well as up
        self._gauges = {
            "round_duration_p95_seconds":
                reg.gauge("fedml_slo_round_duration_p95_seconds"),
            "serve_shed_rate": reg.gauge("fedml_slo_serve_shed_ratio"),
            "torn_frame_rate": reg.gauge("fedml_slo_torn_frame_ratio"),
            "quarantine_rate":
                reg.gauge("fedml_slo_quarantine_per_round_ratio"),
            "health_misalignment_ratio":
                reg.gauge("fedml_slo_health_misalignment_ratio"),
            "health_norm_cv_ratio":
                reg.gauge("fedml_slo_health_norm_cv_ratio"),
            "health_starvation_ratio":
                reg.gauge("fedml_slo_health_starvation_ratio"),
            "device_mem_utilization_ratio":
                reg.gauge("fedml_slo_device_mem_utilization_ratio"),
            "serve_queue_utilization_ratio":
                reg.gauge("fedml_slo_serve_queue_utilization_ratio"),
        }
        self._breaches = {name: reg.counter(
            "fedml_slo_breaches_total", slo=name)
            for name in self._gauges}

    @staticmethod
    def _sum_family(counters: dict, family: str) -> float:
        return sum(v for k, v in counters.items() if k.startswith(family))

    def _values(self, snap: dict) -> Dict[str, Optional[float]]:
        counters = snap.get("counters", {})
        hists = snap.get("histograms", {})

        p95 = None
        for series, stats in hists.items():
            if series.startswith(("fedml_round_duration_seconds",
                                  "fedml_async_version_duration_seconds")):
                q = histogram_quantile(stats, 0.95)
                if q is not None:
                    p95 = q if p95 is None else max(p95, q)

        submitted = self._sum_family(counters, "fedml_serve_requests_total")
        # slo_degraded sheds are EXCLUDED from the numerator: they are a
        # CONSEQUENCE of an already-breaching objective (the tier gate
        # shedding best-effort), not fresh evidence of overload.  A shed
        # submit never increments requests_total, so counting them would
        # close a feedback loop — tier-gate sheds inflate shed_rate,
        # which keeps the gate degraded, which sheds more — latching a
        # transient breach into a permanent one at any best-effort mix
        # above threshold/(1+threshold).
        shed = sum(v for k, v in counters.items()
                   if k.startswith("fedml_serve_shed_total")
                   and 'reason="slo_degraded"' not in k)
        shed_rate = (shed / submitted) if submitted else 0.0

        recv = self._sum_family(counters, "fedml_comm_recv_total")
        torn = self._sum_family(counters, "fedml_wire_torn_frames_total")
        torn_rate = (torn / recv) if recv else 0.0

        rounds = sum(h.get("count", 0) for s, h in hists.items()
                     if s.startswith(("fedml_round_duration_seconds",
                                      "fedml_async_version_duration_"
                                      "seconds")))
        quarantines = self._sum_family(
            counters, "fedml_robust_quarantine_events_total")
        quarantine_rate = (quarantines / rounds) if rounds else 0.0

        # drift alarms: the health observatory exports these per round;
        # an absent gauge (health off, or no round closed yet) reads as
        # None — vacuously healthy, never a fabricated zero
        gauges = snap.get("gauges", {})
        health = {name: gauges.get(f"fedml_{name}")
                  for name in ("health_misalignment_ratio",
                               "health_norm_cv_ratio",
                               "health_starvation_ratio")}

        return {"round_duration_p95_seconds": p95,
                "serve_shed_rate": shed_rate,
                "torn_frame_rate": torn_rate,
                "quarantine_rate": quarantine_rate,
                # device observatory: worst-device memory utilization
                # (absent gauge — device obs off, or a backend without
                # allocator limits — reads None: vacuously healthy,
                # never a fabricated zero)
                "device_mem_utilization_ratio":
                    gauges.get("fedml_dev_mem_utilization_ratio"),
                # worst worker across the serve pool (absent gauge — no
                # serving — reads None: vacuously healthy)
                "serve_queue_utilization_ratio": max(
                    (v for k, v in gauges.items() if k.startswith(
                        "fedml_serve_queue_utilization_ratio")),
                    default=None),
                **health}

    def evaluate(self, count_breaches: bool = True) -> Dict[str, dict]:
        values = self._values(self._registry.snapshot())
        out: Dict[str, dict] = {}
        for name, threshold in sorted(self.thresholds.items()):
            value = values.get(name)
            ok = value is None or value <= threshold
            if value is not None:
                self._gauges[name].set(value)
            if not ok and count_breaches:
                self._breaches[name].inc()
            out[name] = {"value": value, "threshold": threshold, "ok": ok}
        return out

    def healthy(self) -> bool:
        return all(v["ok"]
                   for v in self.evaluate(count_breaches=False).values())
