"""Durable round journal: crash consistency for the live round loop.

The port's copy of ``fedml_tpu/utils/journal.py``; its files are the JAX
package's, so a journal written by either package recovers in the other.
The `RoundCheckpointer` makes the federation resumable at round
boundaries; this module covers the round in flight with two files per
server:

* **`journal.jsonl`** — per-report metadata records, each formatted fully
  and written with one ``write()`` in append mode (`durable_append`), so
  a crash tears at most the last line, which every reader tolerates.  It
  holds only the OPEN round: ``round_start`` rewrites it atomically.
* **`snapshot.npz`** — the streaming fold state (accumulator leaves in
  their own dtype, ``wsum`` f32, the fold order of ``(silo, weight)``),
  written tmp + fsync + ``os.replace`` every ``snapshot_every`` folds.
  On the card the state comes to the host first (`state_fn` syncs the
  device); each snapshot's device→host, encode, write and fsync times are
  kept in ``last_snapshot_ms``.

`recover()` finds the open round and the fold state of the last durable
snapshot; the server re-tasks only the silos it does not cover.  The
streaming mean's fold is an order-preserving sequential reduction, so a
restored prefix plus the re-trained suffix gives the uncrashed global bit
for bit.  Reservoir rounds are abort-only (``resumable=False``).

Disk-fault seam: every write passes a module-level hook that
`robust.faultline.DiskFaultInjector` installs; a journal whose writes
fail disables itself with one warning and never kills the receive
thread.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# crash-safe file primitives + the disk-fault seam
# ---------------------------------------------------------------------------

# installed by robust/faultline.DiskFaultInjector: fn(channel, path, data)
# may raise OSError (and may itself write a torn prefix first).  Module-
# level so the obs ledger writers reach it without importing robust/.
_DISK_FAULT_HOOK: Optional[Callable] = None


def install_disk_faults(hook: Callable) -> None:
    """Install a disk-fault hook consulted before every `durable_append`
    / `atomic_write`; ``hook(channel, path, data)`` raises OSError to
    inject a fault (test/soak only — never wired in production)."""
    global _DISK_FAULT_HOOK
    _DISK_FAULT_HOOK = hook


def clear_disk_faults() -> None:
    global _DISK_FAULT_HOOK
    _DISK_FAULT_HOOK = None


def durable_append(path: str, data: str, channel: str = "") -> None:
    """The one-write O_APPEND contract shared by every ledger here
    (perf.jsonl / health.jsonl / journal.jsonl): the line is formatted
    fully before a single ``write()``, so a crash tears at most the
    tail — which every reader tolerates.  Raises OSError on real (or
    injected) disk faults; callers own the warn-once-and-disable
    policy."""
    if _DISK_FAULT_HOOK is not None:
        _DISK_FAULT_HOOK(channel, path, data)
    with open(path, "a") as f:
        f.write(data)
        f.flush()


def atomic_write(path: str, data: bytes, channel: str = "",
                 timings: Optional[dict] = None) -> None:
    """tmp + fsync + ``os.replace``: readers see either the previous
    complete file or the new complete one, never a torn middle.
    ``timings`` (a dict) receives ``write_s`` and ``fsync_s``."""
    if _DISK_FAULT_HOOK is not None:
        _DISK_FAULT_HOOK(channel, path, data)
    tmp = path + ".tmp"
    t0 = time.perf_counter()
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        t1 = time.perf_counter()
        os.fsync(f.fileno())
        t2 = time.perf_counter()
    os.replace(tmp, path)
    if timings is not None:
        timings["write_s"] = t1 - t0
        timings["fsync_s"] = t2 - t1


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` for every leaf of nested dicts, in JAX's leaf
    order (dict keys sorted at every level; a flat key ``"a/b"`` sorts as
    the path ``a``, ``b``)."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: str(k).split("/")):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def tree_crc(tree) -> int:
    """crc32 over the bytes of every leaf, in JAX's leaf order (tensors
    through their host copy): a tree of the same values gives the JAX
    package's crc.  The journal stamps it on ``round_start`` so recovery
    refuses to resume a fold whose clip reference is not the restored
    global."""
    crc = 0
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(leaf)).tobytes(),
                         crc)
    return crc


# ---------------------------------------------------------------------------
# the round journal
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Recovery:
    """What `recover()` found mid-flight: the open round, whether its
    mode permits resuming, and the last durable snapshot's fold state.
    ``folded`` lists ``(silo, weight, extra)`` IN FOLD ORDER for exactly
    the uploads the snapshot covers — accepts recorded after it were
    never durably folded and their silos must be re-tasked."""
    round_idx: int
    mode: str
    resumable: bool
    global_crc: Optional[int]
    folded: List[tuple]
    state: Optional[dict]
    accepts: List[dict]


class RoundJournal:
    """Durable mid-round recovery log for one aggregation node.

    Round protocol (all writes fault-guarded — a failing disk disables
    the journal with one warning and never kills the round loop)::

        j.round_start(r, mode=..., resumable=..., global_crc=...)
        j.note_accept(r, silo, w, folded=True, state_fn=agg.state_dict)
        ...                       # one per report; snapshots per cadence
        j.round_end(r)            # after the round checkpoint is durable

    ``snapshot_every``: fold-state snapshot cadence in accepted folds
    (1 = every fold is durable — the tightest recovery window at one
    O(model) host write per upload; larger values trade re-tasked silos
    for snapshot bandwidth).  ``state_fn`` returns the host fold state
    (`StreamingAggregator.state_dict`); non-resumable rounds (secagg,
    reservoir rules) pass ``state_fn=None`` and are never snapshotted.
    """

    def __init__(self, dirpath: str, snapshot_every: int = 4,
                 node: str = "server"):
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{snapshot_every}")
        os.makedirs(dirpath, exist_ok=True)
        self.dirpath = dirpath
        self.records_path = os.path.join(dirpath, "journal.jsonl")
        self.snapshot_path = os.path.join(dirpath, "snapshot.npz")
        self.snapshot_every = snapshot_every
        self.node = node
        self.disabled = False
        self._warned = False
        self._snap_warned = False   # snapshot failures warn separately —
        #                             they must not consume the disable
        #                             warning (a later disable would then
        #                             be silent)
        self._round: Optional[int] = None
        self._resumable = False
        self._global_crc: Optional[int] = None
        self._folds: List[tuple] = []   # (silo, weight, extra) fold order
        # the last snapshot's device->host (state_fn), encode, write and
        # fsync times in ms, and its size
        self.last_snapshot_ms: Optional[dict] = None
        from fedml_tpu_torch.obs import telemetry
        reg = telemetry.get_registry()
        self._c_records = reg.counter("fedml_journal_records_total")
        self._c_snapshots = reg.counter("fedml_journal_snapshots_total")
        self._c_recoveries = reg.counter("fedml_journal_recoveries_total")
        self._c_abandoned = reg.counter("fedml_journal_abandoned_total")
        self._h_snapshot = reg.histogram("fedml_journal_snapshot_seconds")

    # -- fault policy --------------------------------------------------------
    def _disable(self, what: str, err: Exception) -> None:
        """A failing journal disk must never kill the receive thread or
        the round loop: warn ONCE, stop journaling.  The on-disk prefix
        stays a safe recovery source (prefix recovery only re-tasks more
        silos)."""
        self.disabled = True
        if not self._warned:
            self._warned = True
            log.warning("journal %s failed (%s: %s); disabling the round "
                        "journal — training continues, crash recovery "
                        "falls back to the round-boundary checkpoint",
                        what, type(err).__name__, err)

    def _append(self, record: dict) -> None:
        if self.disabled:
            return
        record.setdefault("ts", time.time())
        data = json.dumps(record, sort_keys=True) + "\n"
        try:
            durable_append(self.records_path, data, channel="journal")
        except OSError as e:
            self._disable("append", e)
            return
        self._c_records.inc()

    # -- round lifecycle -----------------------------------------------------
    def round_start(self, round_idx: int, mode: str = "stream_mean",
                    resumable: bool = True,
                    global_crc: Optional[int] = None,
                    expected=None) -> None:
        """Open a round.  Atomically REWRITES the journal to hold only
        this round (completed rounds are the checkpointer's jurisdiction)
        — so the journal file is bounded and recovery never wades
        through history."""
        self._round = round_idx
        self._resumable = bool(resumable)
        self._global_crc = None if global_crc is None else int(global_crc)
        self._folds = []
        if self.disabled:
            return
        # drop the previous attempt's snapshot BEFORE rewriting the
        # journal: a crash between the two leaves the OLD journal (whose
        # recovery abandons on "no durable snapshot") — the reverse
        # order could pair a fresh round_start with a stale snapshot of
        # the same round number and restore folds computed against a
        # different global
        try:
            os.remove(self.snapshot_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            self._disable("snapshot removal", e)
            return
        record = {"kind": "round_start", "round": int(round_idx),
                  "mode": mode, "resumable": bool(resumable),
                  "node": self.node, "ts": time.time()}
        if global_crc is not None:
            record["global_crc"] = int(global_crc)
        if expected is not None:
            record["expected"] = [int(s) for s in expected]
        try:
            atomic_write(self.records_path,
                         (json.dumps(record, sort_keys=True) + "\n").encode(),
                         channel="journal")
        except OSError as e:
            self._disable("round_start", e)
            return
        self._c_records.inc()

    def note_accept(self, round_idx: int, silo: int, weight: float,
                    folded: bool = True, reason: Optional[str] = None,
                    extra: Optional[dict] = None,
                    state_fn: Optional[Callable[[], dict]] = None) -> None:
        """Record one report on the receive path.  ``folded=True`` marks
        an upload that entered the fold; with a ``state_fn`` and a
        resumable round, every ``snapshot_every``-th fold also writes a
        durable fold-state snapshot covering all folds so far."""
        record = {"kind": "accept", "round": int(round_idx),
                  "silo": int(silo), "weight": float(weight),
                  "folded": bool(folded)}
        if reason is not None:
            record["reason"] = reason
        if extra:
            record["extra"] = extra
        self._append(record)
        if not folded:
            return
        self._folds.append((int(silo), float(weight), extra or {}))
        if (self._resumable and state_fn is not None
                and not self.disabled
                and len(self._folds) % self.snapshot_every == 0):
            self.snapshot(round_idx, state_fn)

    def snapshot(self, round_idx: int,
                 state_fn: Callable[[], dict]) -> bool:
        """Write the durable fold-state snapshot NOW (atomic): the fold
        accumulator leaves, weight sum, and the fold-order list.  A
        failing snapshot is skipped with a warning — the previous
        snapshot stays valid and self-consistent (it covers exactly its
        own fold prefix), so recovery never sees a torn state."""
        if self.disabled:
            return False
        t0 = time.perf_counter()
        io_s: dict = {}
        try:
            state = state_fn()
            t1 = time.perf_counter()
            data = _encode_snapshot(round_idx, self._folds, state,
                                    global_crc=self._global_crc)
            t2 = time.perf_counter()
            atomic_write(self.snapshot_path, data,
                         channel="journal_snapshot", timings=io_s)
        except OSError as e:
            # snapshot is an optimization, not a correctness requirement:
            # keep journaling records, keep the previous snapshot
            if not self._snap_warned:
                self._snap_warned = True
                log.warning("journal snapshot failed (%s); the previous "
                            "snapshot (if any) remains the recovery "
                            "source", e)
            return False
        self._h_snapshot.observe(time.perf_counter() - t0)
        self._c_snapshots.inc()
        self.last_snapshot_ms = {
            "state_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3,
            "write_ms": io_s["write_s"] * 1e3,
            "fsync_ms": io_s["fsync_s"] * 1e3, "bytes": len(data)}
        return True

    def note_resume(self, round_idx: int,
                    folded: Optional[List[tuple]] = None,
                    global_crc: Optional[int] = None) -> None:
        """Mark a successful mid-round recovery (counted in
        ``fedml_journal_recoveries_total`` and named in the journal so
        the soak invariant checker can audit every recovery).
        ``folded`` is the RESTORED fold prefix: it re-arms this (fresh)
        journal instance's round state, so the resumed round keeps
        snapshotting on its cadence and later snapshots cover prefix +
        suffix — without it a resumed round would silently stop
        advancing its recovery window."""
        folded = list(folded or [])
        self._round = int(round_idx)
        self._resumable = True
        self._global_crc = None if global_crc is None else int(global_crc)
        self._folds = [(int(s), float(w), x or {}) for s, w, x in folded]
        self._c_recoveries.inc()
        self._append({"kind": "resume", "round": int(round_idx),
                      "restored_folds": len(folded), "node": self.node})

    def abandon(self, round_idx: int, reason: str) -> None:
        """Close an open round WITHOUT completing it (non-resumable mode,
        crc mismatch, stale journal): recovery restarts the round from
        the boundary with the global unchanged — loudly, never a partial
        fold."""
        self._c_abandoned.inc()
        self._append({"kind": "abandon", "round": int(round_idx),
                      "reason": reason, "node": self.node})
        # the abandoned attempt's snapshot must never be restorable by a
        # later same-numbered round (belt to round_start's braces)
        try:
            os.remove(self.snapshot_path)
        except OSError:
            pass

    def round_end(self, round_idx: int) -> None:
        """The round is durable (checkpoint saved, or no checkpointing
        configured): recovery has nothing to do for it."""
        self._append({"kind": "round_end", "round": int(round_idx)})
        self._round = None
        self._folds = []

    # -- recovery ------------------------------------------------------------
    def read_records(self) -> List[dict]:
        """Parse the journal, tolerating ONLY a torn final line (the
        O_APPEND contract); a malformed line mid-file is real corruption
        and fails loudly."""
        if not os.path.exists(self.records_path):
            return []
        with open(self.records_path) as f:
            lines = f.read().splitlines()
        out: List[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    log.warning("journal: tolerating torn final line "
                                "(%d bytes)", len(line))
                    continue
                raise ValueError(
                    f"journal {self.records_path} line {i + 1} is "
                    f"malformed mid-file — real corruption, not a torn "
                    f"tail")
        return out

    def recover(self) -> Optional[Recovery]:
        """The open round left by a crashed process, or None.  The
        durable fold set comes from the SNAPSHOT (when it matches the
        open round) — accept records past it are advisory metadata whose
        folds lived in memory only."""
        records = self.read_records()
        start = None
        accepts: List[dict] = []
        for rec in records:
            kind = rec.get("kind")
            if kind == "round_start":
                start = rec
                accepts = []
            elif kind in ("round_end", "abandon") and start is not None \
                    and rec.get("round") == start.get("round"):
                start = None
                accepts = []
            elif kind == "accept" and start is not None:
                accepts.append(rec)
        if start is None:
            return None
        round_idx = int(start["round"])
        folded: List[tuple] = []
        state = None
        if start.get("resumable") and os.path.exists(self.snapshot_path):
            try:
                meta, snap_state = _decode_snapshot(self.snapshot_path)
            except Exception as e:  # noqa: BLE001 — damaged snapshot
                log.warning("journal: snapshot unreadable (%s); recovering "
                            "with an empty durable fold set", e)
            else:
                snap_crc = meta.get("global_crc")
                if meta.get("round") != round_idx:
                    log.info("journal: snapshot belongs to round %s, open "
                             "round is %d; ignoring it",
                             meta.get("round"), round_idx)
                elif snap_crc is not None \
                        and snap_crc != start.get("global_crc"):
                    # a stale snapshot from an ABANDONED attempt of the
                    # same round number (opened against a different
                    # global) — restoring it would mis-aggregate
                    log.warning("journal: snapshot's opening-global crc "
                                "does not match the open round's; "
                                "ignoring it")
                else:
                    folded = [(int(s), float(w), x or {})
                              for s, w, x in meta["folds"]]
                    state = snap_state
        return Recovery(round_idx=round_idx, mode=start.get("mode", "?"),
                        resumable=bool(start.get("resumable")),
                        global_crc=start.get("global_crc"),
                        folded=folded, state=state, accepts=accepts)


# ---------------------------------------------------------------------------
# snapshot codec (npz in one atomic file)
# ---------------------------------------------------------------------------

def _encode_snapshot(round_idx: int, folds: List[tuple], state: dict,
                     global_crc: Optional[int] = None) -> bytes:
    """Serialize a `StreamingAggregator.state_dict` + the fold-order
    list into one npz blob.  Scalars that must roundtrip bit-exact
    (wsum f32, weight_total f64) ride as arrays, not JSON floats.
    ``global_crc`` stamps the round's opening global so recovery can
    refuse a snapshot left by an abandoned same-numbered attempt."""
    if state.get("acc") is None:
        raise ValueError("snapshot with no fold accumulator: snapshots "
                         "are taken after folds, never before")
    meta = {"round": int(round_idx),
            "folds": [[int(s), float(w), x] for s, w, x in folds],
            "count": int(state["count"]),
            "n_acc": len(state["acc"]),
            "n_ref": len(state.get("reference") or [])}
    if global_crc is not None:
        meta["global_crc"] = int(global_crc)
    if state.get("shard_fp") is not None:
        # sharded spine (shard_spine/agg.py): the layout fingerprint
        # rides the snapshot so recovery can REFUSE to restore sharded
        # fold state under a different --model_shards layout (restoring
        # pieces into the wrong slots would mis-aggregate silently)
        meta["shard_fp"] = int(state["shard_fp"])
    arrays: Dict[str, np.ndarray] = {
        "__wsum__": np.asarray(state["wsum"], np.float32),
        "__weight_total__": np.asarray(state["weight_total"], np.float64)}
    for i, a in enumerate(state["acc"]):
        arrays[f"acc_{i}"] = np.asarray(a)
    for i, a in enumerate(state.get("reference") or []):
        arrays[f"ref_{i}"] = np.asarray(a)
    bio = io.BytesIO()
    np.savez(bio, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **arrays)
    return bio.getvalue()


def _decode_snapshot(path: str):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        state = {"acc": [z[f"acc_{i}"] for i in range(meta["n_acc"])],
                 "wsum": z["__wsum__"][()],
                 "weight_total": float(z["__weight_total__"][()]),
                 "count": int(meta["count"])}
        if meta.get("n_ref"):
            state["reference"] = [z[f"ref_{i}"]
                                  for i in range(meta["n_ref"])]
        if meta.get("shard_fp") is not None:
            state["shard_fp"] = int(meta["shard_fp"])
    return meta, state
