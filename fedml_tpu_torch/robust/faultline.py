"""Process-level fault injection: named crash points, seeded kills and
disk faults.

The port's copy of ``fedml_tpu/robust/faultline.py``:

* **crash points** — a closed registry of named sites on the live round
  loop (all eight of the JAX package; the port's server reaches
  ``post_admission_pre_fold``, ``post_fold_pre_ack``, ``barrier_close``,
  ``mid_checkpoint_write`` and ``publish``).  `Faultline.maybe_crash`
  counts every arrival and raises `ActorKilled` when a `CrashSpec`
  matches; `ActorKilled` derives from ``BaseException`` so no ``except
  Exception`` on the receive path survives a kill;
* **seeded random kills** — ``kill_rate`` draws one uniform per arrival
  from ``np.random.RandomState``;
* **disk faults** — `DiskFaultSpec` / `DiskFaultInjector` inject ENOSPC,
  EIO or a torn write into named writer channels through
  `utils.journal.install_disk_faults`.

In-process respawn: a harness catches `ActorKilled`, calls
`Faultline.respawn()` (fired specs stay fired), `kill_actor` on the corpse
(its timers and heartbeat stop, no FINISH is sent), and rebuilds the
actor from its checkpoint and journal.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.utils import journal as _journal

log = logging.getLogger(__name__)

# the closed registry of named crash sites on the live round loop; a
# spec naming anything else is a config error, caught at construction
CRASH_POINTS = (
    "post_admission_pre_fold",   # upload admitted, fold not yet applied
    "post_fold_pre_ack",         # fold applied, report not yet recorded
    "mid_checkpoint_write",      # barrier closed, checkpoint not durable
    "mid_unmask",                # secagg: share reveals collected, sum
    #                              not yet recovered (abort-only proof)
    "barrier_close",             # the round barrier just satisfied
    "publish",                   # checkpoint durable, publish pending
    "canary_promote",            # release gate: verdict passed — fired
    #                              BEFORE and AFTER the atomic registry
    #                              promote (hit 1 = pre, hit 2 = post),
    #                              so a respawn sees exactly one of the
    #                              two consistent states, never between
    "canary_rollback",           # release gate: verdict failed — fired
    #                              around the canary discard the same way
)

# writer channels the disk-fault seam can hit (utils/journal callers)
DISK_CHANNELS = ("perf_ledger", "health_ledger", "journal",
                 "journal_snapshot", "checkpoint_manifest",
                 "release_journal")


class ActorKilled(BaseException):
    """Stands in for ``kill -9``: raised out of the actor's event loop
    with NO cleanup.  Derives from BaseException so broad ``except
    Exception`` guards on the receive path (decode fallbacks, heartbeat
    loops) cannot swallow a kill."""

    def __init__(self, point: str, round_idx=None, hit: int = 0):
        super().__init__(f"injected kill at crash point {point!r} "
                         f"(round={round_idx}, hit={hit})")
        self.point = point
        self.round_idx = round_idx
        self.hit = hit


@dataclasses.dataclass
class CrashSpec:
    """Kill the actor at the ``hit``-th arrival at ``point`` (1-based;
    arrivals filtered to ``round_idx`` when set).  Each spec fires at
    most ONCE per `Faultline` — a respawned actor survives the site it
    died at, so the campaign makes progress."""
    point: str
    hit: int = 1
    round_idx: Optional[int] = None

    def __post_init__(self):
        if self.point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {self.point!r}; "
                             f"registered: {CRASH_POINTS}")
        if self.hit < 1:
            raise ValueError(f"hit is 1-based, got {self.hit}")


class Faultline:
    """Deterministic, seeded crash scheduler threaded through the live
    actors (``faultline=`` parameter).  ``maybe_crash`` is a cheap no-op
    when no specs and no ``kill_rate`` are armed, so production runs
    pay one attribute check per site."""

    def __init__(self, crashes: Sequence[CrashSpec] = (),
                 kill_rate: float = 0.0, seed: int = 0,
                 node: str = "server"):
        if not 0.0 <= kill_rate < 1.0:
            raise ValueError(f"kill_rate must be in [0, 1), got "
                             f"{kill_rate}")
        self.specs = [s if isinstance(s, CrashSpec) else CrashSpec(**s)
                      for s in crashes]
        self.kill_rate = float(kill_rate)
        self.node = node
        self._rng = np.random.RandomState(
            (int(seed) * 1_000_003 + 17) % (2 ** 32))
        self._fired = [False] * len(self.specs)
        self._hits: Dict[tuple, int] = {}   # (point, round_key) -> count
        self.kills = 0
        self.respawns = 0
        reg = telemetry.get_registry()
        self._m_kills = {p: reg.counter("fedml_fault_kills_total", point=p)
                         for p in CRASH_POINTS}
        self._c_respawns = reg.counter("fedml_fault_respawns_total")

    @property
    def armed(self) -> bool:
        return bool(self.specs) or self.kill_rate > 0

    def maybe_crash(self, point: str, round_idx=None, **ctx) -> None:
        """Count one arrival at ``point``; raise `ActorKilled` when a
        spec (or the seeded random schedule) says so."""
        if not self.armed:
            return
        if point not in CRASH_POINTS:
            raise ValueError(f"unregistered crash point {point!r}")
        # per-(point, round) AND per-point arrival counters: specs with a
        # round filter count hits within their round, unfiltered specs
        # count global arrivals at the point
        key_any = (point, None)
        self._hits[key_any] = self._hits.get(key_any, 0) + 1
        if round_idx is not None:
            key_r = (point, int(round_idx))
            self._hits[key_r] = self._hits.get(key_r, 0) + 1
        for i, spec in enumerate(self.specs):
            if self._fired[i] or spec.point != point:
                continue
            if spec.round_idx is not None:
                if round_idx is None or int(round_idx) != spec.round_idx:
                    continue
                hits = self._hits[(point, spec.round_idx)]
            else:
                hits = self._hits[key_any]
            if hits == spec.hit:
                self._fired[i] = True
                self._kill(point, round_idx, hits)
        if self.kill_rate > 0:
            # one fixed-size draw per arrival, in arrival order — the
            # ChaosTransport determinism contract: same seed + same
            # message schedule = same kill schedule
            if float(self._rng.uniform()) < self.kill_rate:
                self._kill(point, round_idx, self._hits[key_any])

    def _kill(self, point: str, round_idx, hit: int) -> None:
        self.kills += 1
        self._m_kills[point].inc()
        log.warning("faultline[%s]: KILLING actor at %s (round=%s, "
                    "hit=%d)", self.node, point, round_idx, hit)
        raise ActorKilled(point, round_idx=round_idx, hit=hit)

    def respawn(self) -> None:
        """Mark one in-process respawn (the harness calls this when it
        rebuilds a killed actor).  Fired specs stay fired."""
        self.respawns += 1
        self._c_respawns.inc()


# ---------------------------------------------------------------------------
# disk faults
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiskFaultSpec:
    """Inject one OSError into the ``hit``-th write on ``channel``.
    ``torn=True`` writes a partial prefix of the payload before raising
    (append channels only) — the torn-tail case every ledger reader must
    tolerate.  Fires at most once."""
    channel: str
    hit: int = 1
    err: int = errno.ENOSPC
    torn: bool = False

    def __post_init__(self):
        if self.channel not in DISK_CHANNELS:
            raise ValueError(f"unknown disk channel {self.channel!r}; "
                             f"registered: {DISK_CHANNELS}")
        if self.hit < 1:
            raise ValueError(f"hit is 1-based, got {self.hit}")


class DiskFaultInjector:
    """The hook `utils.journal.install_disk_faults` installs: counts
    writes per channel and raises the scheduled OSErrors.  ``install()``
    wires it process-wide; ``remove()`` (or
    `utils.journal.clear_disk_faults`) restores clean disks — tests use
    try/finally."""

    def __init__(self, specs: Sequence[DiskFaultSpec] = ()):
        self.specs = [s if isinstance(s, DiskFaultSpec)
                      else DiskFaultSpec(**s) for s in specs]
        self._fired = [False] * len(self.specs)
        self._hits: Dict[str, int] = {}
        self.injected = 0
        reg = telemetry.get_registry()
        self._m_disk = {c: reg.counter("fedml_fault_disk_faults_total",
                                       channel=c) for c in DISK_CHANNELS}

    def __call__(self, channel: str, path: str, data) -> None:
        self._hits[channel] = self._hits.get(channel, 0) + 1
        for i, spec in enumerate(self.specs):
            if self._fired[i] or spec.channel != channel:
                continue
            if self._hits[channel] != spec.hit:
                continue
            self._fired[i] = True
            self.injected += 1
            self._m_disk[channel].inc()
            if spec.torn and isinstance(data, str) and data:
                # land a torn prefix, then fail — the reader-side
                # torn-tail contract's sparring partner
                try:
                    with open(path, "a") as f:
                        f.write(data[:max(1, len(data) // 2)])
                except OSError:
                    pass
            log.warning("disk fault: injecting %s into channel %r "
                        "(write #%d%s)", errno.errorcode.get(spec.err,
                                                             spec.err),
                        channel, spec.hit,
                        ", torn" if spec.torn else "")
            raise OSError(spec.err, f"injected disk fault on {channel}",
                          path)

    def install(self) -> "DiskFaultInjector":
        _journal.install_disk_faults(self)
        return self

    def remove(self) -> None:
        _journal.clear_disk_faults()


def kill_actor(actor) -> None:
    """Emulate the machine-level aftermath of a kill -9 on an IN-PROCESS
    actor: a real process's timer/heartbeat threads die with it, but an
    in-process 'corpse' would keep firing timers into the transport of
    its successor.  Cancels every known timer WITHOUT running finish()
    (no FINISH frames, no checkpoint flush — the dead say nothing)."""
    for attr in ("_timer", "_retask_timer"):
        t = getattr(actor, attr, None)
        if t is not None:
            try:
                t.cancel(join=True)
            except Exception:  # noqa: BLE001 — best-effort corpse cleanup
                pass
    stop = getattr(actor, "_hb_stop", None)
    if stop is not None:
        stop.set()
