"""Asynchronous buffered federated aggregation (FedBuff-style).

The port of ``fedml_tpu/algorithms/async_fl.py`` (:1-1038).  The server
has no barrier: silos train continuously (upload a delta, at once receive
the current global and a fresh client), the server buffers deltas and
applies every ``aggregation_goal`` of them as one VERSION against the
current global, each discounted by ``(1 + s)^-alpha`` for its staleness
``s`` (versions since the silo's base).  The discount multiplies each
delta outside the sample-weight normalization, so a uniformly stale
buffer is damped absolutely.  With ``aggregation_goal = n_silos`` and
``server_lr = 1`` the first version is a synchronous FedAvg round.

* ``_payload_crc`` (:60-72) hashes a delta frame's leaf bytes with
  ``zlib``, the rejected-upload dedupe key; it reads the decoded wire
  tree's numpy views (the byte-equal codec), never tensors.
* ``delta_encoder`` (:74-78): the silo's ``encode_upload`` hook.
* `AsyncFedServerActor` (:81-1038): the tasking wave and the re-task
  watchdog (``retask_timeout_s``; with ``degrade``, the watchdog's quiet
  threshold adapts to the observed task→upload latency, and a nudge books
  a network drop), the at-most-once buffer guard and the CRC dedupe of
  rejected frames, bench/quarantine with probation release, the three
  apply modes (the plain sample+discount mean, ``defended_aggregate``
  over the padded ``[goal, ...]`` stack, ``stream_agg`` folding at
  arrival), the server-optimizer seam (``apply_delta`` on
  ``Δ = −davg·mean``), version checkpoints, the journal with kill→resume
  of a version, and ``ingest`` (one shard, no arena: async uploads are
  deltas screened on the host).

The version step runs in host f64 numpy and casts back, as the JAX
package's does (:838-925), so the versions match the JAX package's
instead of drifting with the card's arithmetic; the global is then the
port's flat dict of tensors on the actor's device.  ``perf`` ledgers one
``perf.jsonl`` line a version and ``health`` one ``health.jsonl`` line
(``kind="delta"``: the uploads are the updates), as in the JAX package.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from fedml_tpu_torch.algorithms.cross_silo import MsgType
from fedml_tpu_torch.comm.actors import SelfMessageTimer, ServerManager
from fedml_tpu_torch.comm.compress import tree_leaves, tree_map
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.core.pytree import (HostMirror, as_tensor,
                                         flatten_nested, host_array,
                                         tree_keys)
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.robust.degrade import FaultClass
from fedml_tpu_torch.utils.journal import tree_crc

log = logging.getLogger(__name__)

# server self-message from the re-task watchdog timer (continues the
# MsgType numbering of algorithms/cross_silo.py)
MSG_RETASK_TICK = 7


def _payload_crc(tree) -> int:
    """Content crc32 over a delta's leaf bytes in JAX's leaf order (the
    frame identity the rejected-upload dedupe keys on).  Non-tree junk
    hashes to a sentinel; admission rejects it anyway."""
    try:
        crc = 0
        for leaf in tree_leaves(tree):
            crc = zlib.crc32(
                np.ascontiguousarray(np.asarray(leaf)).tobytes(), crc)
        return crc
    except Exception:  # noqa: BLE001 — unhashable garbage payload
        return -1


def delta_encoder(new_params, global_params):
    """Client-side upload transform: send the UPDATE, not the weights —
    the async server applies it to whatever global is current."""
    return tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                    new_params, global_params)


class AsyncFedServerActor(ServerManager):
    """Barrier-free aggregator: buffer ``aggregation_goal`` deltas, apply
    them with staleness discounts, re-task the silos whose uploads were
    consumed.  ``num_versions`` plays comm_round's role;
    ``on_version(version, params)`` is the eval hook.

    ``admission``: an `AdmissionPipeline` with ``kind="delta"``, screened
    before buffering; a quarantined silo is benched until its sentence
    expires, then re-tasked on probation; other rejects are re-tasked at
    once.  ``defended_aggregate``: a `robust.defense.make_defended_
    aggregate` product over the static ``[goal, ...]`` delta stack (raw
    sample weights; the buffer's sample-weighted mean discount scales the
    applied step afterwards).  ``stream_agg``: a `StreamingAggregator`
    with ``kind="delta"`` folding each admitted delta at arrival
    (exclusive with ``defended_aggregate``).  ``journal``: the version's
    crash consistency (needs ``stream_agg``); ``faultline``: the crash
    points.  ``server_opt``: its ``apply_delta`` takes the discounted
    mean.  ``degrade``: the watchdog's adaptive threshold.  ``ingest``:
    an `IngestPipeline` with one queue (exclusive with ``faultline``).
    ``extra_state``: a ``(get_fn, set_fn)`` pair checkpointed beside the
    params (the trust ledger, the optimizer, the tracker)."""

    def __init__(self, transport: Transport, init_params,
                 client_num_in_total: int, n_silos: int,
                 num_versions: int, aggregation_goal: int,
                 staleness_exponent: float = 0.5, server_lr: float = 1.0,
                 on_version: Optional[Callable[[int, object], None]] = None,
                 seed: int = 0, checkpointer=None,
                 retask_timeout_s: Optional[float] = None,
                 admission=None,
                 defended_aggregate: Optional[Callable] = None,
                 stream_agg=None,
                 encode_once: bool = True,
                 perf=None,
                 health=None,
                 extra_state: Optional[tuple] = None,
                 journal=None,
                 faultline=None,
                 server_opt=None,
                 degrade=None,
                 ingest=None):
        super().__init__(0, transport)
        if not 1 <= aggregation_goal <= n_silos:
            raise ValueError(
                f"aggregation_goal must be in [1, n_silos={n_silos}], "
                f"got {aggregation_goal}")
        self.params = init_params
        self.device = next(iter(init_params.values())).device
        self._keys = tree_keys(init_params)
        self.client_num_in_total = client_num_in_total
        self.n_silos = n_silos
        self.num_versions = num_versions
        self.goal = aggregation_goal
        self.alpha = staleness_exponent
        self.server_lr = server_lr
        self.on_version = on_version
        self.version = 0
        # per consumed upload, bounded at insert
        self.staleness_seen: collections.deque = collections.deque(
            maxlen=4096)
        self._buffer: List[Tuple[object, float, float, int, int]] = []
        self._task_rng = np.random.RandomState(seed)
        self.checkpointer = checkpointer
        self.retask_timeout_s = retask_timeout_s
        self._last_heard: Dict[int, float] = {}
        self._retask_timer = SelfMessageTimer()
        # (silo, base_version) pairs already aggregated: the at-most-once
        # guard outlives buffer flushes
        self._consumed: set = set()
        self.admission = admission
        if defended_aggregate is not None and stream_agg is not None:
            raise ValueError("defended_aggregate (stack mode) and "
                             "stream_agg (stream mode) are mutually "
                             "exclusive; pick one --agg_mode")
        self.defended_aggregate = defended_aggregate
        self.stream_agg = stream_agg
        self.encode_once = encode_once
        self.extra_state = extra_state
        if journal is not None and stream_agg is None:
            raise ValueError(
                "journal (crash consistency) rides the streaming-fold "
                "receive path: pass --agg_mode stream; the stacked delta "
                "buffer has no incremental fold state to snapshot")
        self.journal = journal
        self.faultline = faultline
        if ingest is not None and faultline is not None:
            raise ValueError(
                "--ingest_pipeline and --faultline are mutually "
                "exclusive: ActorKilled must escape the transport event "
                "loop to reach the harness, and an ingest fold worker "
                "thread has no path there")
        self.ingest = ingest
        # (silo, round-tag) pairs whose frames sit queued
        self._ingest_inflight: Set[Tuple[int, object]] = set()
        self._ingest_lock = threading.RLock()
        self.server_opt = server_opt
        self.degrade = degrade
        self.perf = perf
        self.health = health
        self._tasked_at: Dict[int, float] = {}
        if health is not None:
            # no per-version barrier set exists: the silo universe is the
            # fairness denominator from version 0.  The starvation clock
            # ticks per VERSION, and a healthy rotation accepts ~goal of
            # n_silos silos a version, so "N missed turns" means N
            # rotation periods: starve_after scales by ceil(n / goal)
            period = -(-n_silos // aggregation_goal)
            health.starve_after = health.starve_after * period
            health.register(range(1, n_silos + 1))
        self._host_mirror = HostMirror()
        # quarantined silos declined a re-task; released on probation
        self._benched: Set[int] = set()
        # (silo, base_version) -> crcs of frames already REJECTED: a
        # duplicate delivery must not strike twice, a fresh offense must
        self._rejected_crcs: Dict[Tuple[int, int], set] = {}
        self._delta_zeros = None     # the defended stack's pad slot
        self._stacked_zeros = None   # the defended rule's clip reference
        self._finished = False
        reg = telemetry.get_registry()
        self._h_version = reg.histogram(
            "fedml_async_version_duration_seconds")
        self._h_staleness = reg.histogram(
            "fedml_async_staleness_total", buckets=(0, 1, 2, 4, 8, 16, 32))
        self._version_t0: Optional[float] = None

    def register_handlers(self) -> None:
        self.register_handler(MsgType.C2S_MODEL, self._on_model)
        self.register_handler(MSG_RETASK_TICK, self._on_retask_tick)

    # -- tasking -------------------------------------------------------------
    def start(self) -> None:
        """The version-0 tasking wave (the synchronous paths' seeded
        sampler, so goal == n_silos is FedAvg's round-0 cohort).  With a
        ``checkpointer`` holding a version, resume from it; with a
        ``journal``, resume a version left mid-flight."""
        if self.checkpointer is not None:
            self._restore_checkpoint()
        resume = None
        if self.journal is not None:
            resume = self._journal_recovery()
        if self.version >= self.num_versions:
            for silo in range(1, self.n_silos + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
            return
        ids = sample_clients(0, self.client_num_in_total, self.n_silos)
        now = time.monotonic()
        self._version_t0 = now
        if self.stream_agg is not None:
            self.stream_agg.reset(self.params)
        if self.perf is not None:
            self.perf.round_start(self.version)
        buffered: Set[int] = set()
        if resume is not None:
            # the durable fold prefix and the buffer's metadata restore;
            # those silos are not re-tasked (their deltas are folded)
            with self._perf_phase("journal"):
                self.stream_agg.load_state_dict(resume.state)
                for silo, weight, extra in resume.folded:
                    base = int((extra or {}).get("base", self.version))
                    discount = float(1.0 + self.version - base) \
                        ** (-self.alpha)
                    self._buffer.append((None, float(weight), discount,
                                         int(silo), base))
                    buffered.add(int(silo))
                self.journal.note_resume(self.version, resume.folded,
                                         global_crc=resume.global_crc)
        else:
            self._journal_round_start()
        if self.health is not None:
            with self._perf_phase("health"):
                self.health.round_start(self.version, self._host_params())
        # one root span for the initial tasking wave, so the version-0
        # silo train/upload spans stitch into a single trace
        with self._root_span("tasking", f"version{self.version}",
                             version=self.version):
            assignments = {silo: int(client_idx) for silo, client_idx
                           in enumerate(ids, start=1)
                           if silo not in buffered}
            for silo in assignments:
                self._last_heard[silo] = now
            with self._perf_phase("broadcast_serialize"):
                self._task_wave(assignments, MsgType.S2C_INIT)
        self._arm_retask_timer()
        if self._buffer and len(self._buffer) >= self._effective_goal():
            # the restored buffer already meets the goal (the crash hit
            # between goal-reached and the version close)
            self._apply_buffer()

    def _restore_checkpoint(self) -> None:
        step = self.checkpointer.latest_round()
        if step is None:
            return
        try:
            state = self.checkpointer.restore(
                step, like=self._checkpoint_state())
        except ValueError:
            log.warning("checkpoint %d does not match the current state "
                        "schema; restoring untemplated", step)
            state = self.checkpointer.restore(step)
        self.params = {k: as_tensor(v, self.device).to(self.params[k].dtype)
                       for k, v in state["params"].items()}
        self.version = int(np.asarray(state["version"]))
        if self.extra_state is not None and "extra" in state:
            self.extra_state[1](state["extra"])
        log.info("resumed from checkpoint: continuing at version %d of %d",
                 self.version, self.num_versions)

    # -- liveness watchdog ---------------------------------------------------
    def _arm_retask_timer(self) -> None:
        if self.retask_timeout_s is None:
            return
        self._retask_timer.arm(self.retask_timeout_s,
                               lambda: self.send(MSG_RETASK_TICK, 0))

    def _on_retask_tick(self, msg: Message) -> None:
        if self.ingest is not None:
            # queued frames are responses, not silence
            self.ingest.drain()
        if self.version >= self.num_versions:
            return
        now = time.monotonic()
        buffered = {s for _, _, _, s, _ in self._buffer}
        quiet_after = self.retask_timeout_s
        if self.degrade is not None:
            adaptive = self.degrade.deadline_s(
                range(1, self.n_silos + 1), self.retask_timeout_s)
            if adaptive is not None:
                quiet_after = adaptive
        for silo in range(1, self.n_silos + 1):
            if silo in buffered or silo in self._benched:
                continue
            if self.admission is not None and self.admission.trust.state(
                    silo, self.version) == "quarantined":
                continue  # jailed but never benched: wait out the sentence
            quiet = now - self._last_heard.get(silo, now)
            if quiet >= quiet_after:
                log.warning("silo %d quiet for %.1fs (threshold %.1fs); "
                            "re-tasking against version %d", silo, quiet,
                            quiet_after, self.version)
                self._last_heard[silo] = now
                if self.degrade is not None:
                    # a quiet silo is a NETWORK verdict, never a strike
                    self.degrade.note_drop(silo)
                # watchdog ticks carry no inbound trace context: root each
                # nudge so its train/upload stitch
                with self._root_span("retask",
                                     f"retask-v{self.version}-s{silo}",
                                     silo=silo, version=self.version):
                    self._task(silo, self._next_client())
        self._arm_retask_timer()

    def _host_params(self):
        return self._host_mirror.get(self.params)

    def _task(self, silo: int, client_idx: int, msg_type=MsgType.S2C_SYNC):
        self._tasked_at[silo] = time.monotonic()
        self.send(msg_type, silo,
                  **{Message.ARG_MODEL_PARAMS: self._host_params(),
                     Message.ARG_CLIENT_INDEX: client_idx,
                     Message.ARG_ROUND: self.version})

    def _task_wave(self, assignments: Dict[int, int],
                   msg_type=MsgType.S2C_SYNC) -> None:
        """Task several silos against the current global, one payload
        serialization for the wave."""
        if not assignments:
            return
        if not self.encode_once:
            for silo in sorted(assignments):
                self._task(silo, assignments[silo], msg_type)
            return
        now = time.monotonic()
        for silo in assignments:
            self._tasked_at[silo] = now
        self.send_many(
            msg_type, sorted(assignments),
            shared_params={Message.ARG_MODEL_PARAMS: self._host_params(),
                           Message.ARG_ROUND: self.version},
            per_receiver_params={
                silo: {Message.ARG_CLIENT_INDEX: client_idx}
                for silo, client_idx in assignments.items()})

    def _next_client(self) -> int:
        return int(self._task_rng.randint(self.client_num_in_total))

    def _checkpoint_state(self) -> dict:
        out = {"params": self.params,
               "version": np.asarray(self.version, np.int64)}
        if self.extra_state is not None:
            out["extra"] = self.extra_state[0]()
        return out

    def _journal_mode(self) -> str:
        srvopt = ""
        if self.server_opt is not None and self.server_opt.name != "plain":
            srvopt = f"+srvopt={self.server_opt.name}"
        return f"stream_{self.stream_agg.method}{srvopt}"

    def _journal_round_start(self) -> None:
        if self.journal is None:
            return
        with self._perf_phase("journal"):
            self.journal.round_start(
                self.version, mode=self._journal_mode(),
                resumable=self.stream_agg.method == "mean",
                global_crc=tree_crc(self._host_params()))

    def _journal_recovery(self):
        """Resume the open version only when it is the checkpoint's next
        one, its fold regime is resumable, the tasking global matches and
        a durable snapshot exists; otherwise abandon it loudly."""
        rec = self.journal.recover()
        if rec is None:
            return None
        if rec.round_idx != self.version:
            log.warning("journal holds mid-flight version %d but the "
                        "checkpoint boundary resumes at version %d; "
                        "abandoning the journal version",
                        rec.round_idx, self.version)
            self.journal.abandon(rec.round_idx, "version mismatch")
            return None
        if not rec.resumable:
            log.error("version %d crashed mid-flight in non-resumable "
                      "mode %r; restarting the version from the boundary",
                      rec.round_idx, rec.mode)
            self.journal.abandon(rec.round_idx,
                                 f"non-resumable mode {rec.mode}")
            return None
        if rec.global_crc is not None \
                and rec.global_crc != tree_crc(self._host_params()):
            log.error("version %d journal opened against a different "
                      "global (crc mismatch); refusing to resume the "
                      "fold", rec.round_idx)
            self.journal.abandon(rec.round_idx, "global crc mismatch")
            return None
        if rec.state is None or not rec.folded:
            log.warning("version %d crashed before any durable fold "
                        "snapshot; re-tasking every silo from the "
                        "boundary", rec.round_idx)
            self.journal.abandon(rec.round_idx, "no durable snapshot")
            return None
        log.warning("version %d: resuming MID-VERSION from the journal — "
                    "%d delta(s) durably folded (silos %s) rebuild the "
                    "buffer and will not be re-tasked", rec.round_idx,
                    len(rec.folded), [s for s, _, _ in rec.folded])
        return rec

    # -- aggregation ---------------------------------------------------------
    def _on_model(self, msg: Message) -> None:
        self._last_heard[msg.sender_id] = time.monotonic()
        if self.version >= self.num_versions:
            return  # late upload after FINISH
        if self.ingest is not None:
            # envelope facts only, then the single fold worker (FIFO =
            # arrival order); staleness is judged on the worker against
            # the version that folds the frame
            key = (msg.sender_id, msg.get(Message.ARG_ROUND))
            if key in self._ingest_inflight:
                log.info("ignoring duplicate version-%s upload from silo "
                         "%d (first copy still queued)", key[1],
                         msg.sender_id)
                return
            self._note_arrival()
            self._ingest_inflight.add(key)
            ok = self.ingest.submit(
                0, lambda: self._ingest_task(msg),
                detail=f"silo {msg.sender_id} version {key[1]}")
            if not ok:
                self._ingest_inflight.discard(key)
            return
        self._upload_body(msg, note_arrival=True)

    def _ingest_task(self, msg: Message) -> None:
        key = (msg.sender_id, msg.get(Message.ARG_ROUND))
        try:
            with self._ingest_lock:
                if self.version >= self.num_versions:
                    return  # the federation closed while it was queued
                self._upload_body(msg)
        finally:
            with self._ingest_lock:
                self._ingest_inflight.discard(key)

    def _upload_body(self, msg: Message, note_arrival: bool = False) -> None:
        try:
            base_version = int(msg.get(Message.ARG_ROUND))
        except (TypeError, ValueError):
            self._reject_malformed(
                msg, -1, f"missing/invalid round tag "
                f"{msg.get(Message.ARG_ROUND)!r}")
            return
        if base_version > self.version:
            # a forged future tag: staleness would go negative
            self._reject_malformed(
                msg, base_version, f"future version tag {base_version} "
                f"(current {self.version})")
            return
        if (msg.sender_id, base_version) in self._consumed or \
                any(s == msg.sender_id and b == base_version
                    for _, _, _, s, b in self._buffer):
            log.warning("ignoring duplicate version-%d upload from silo %d",
                        base_version, msg.sender_id)
            return
        if note_arrival:
            self._note_arrival()  # one wire arrival per (deduped) upload
        delta = msg.get(Message.ARG_MODEL_PARAMS)
        raw_samples = msg.get(Message.ARG_NUM_SAMPLES)
        delta_norm = None
        if self.admission is not None:
            pair = (msg.sender_id, base_version)
            seen = self._rejected_crcs.get(pair)
            crc = _payload_crc(delta) if seen is not None else None
            if seen is not None and crc in seen:
                log.info("ignoring duplicate rejected version-%d upload "
                         "from silo %d", base_version, msg.sender_id)
                return
            with self._span("ingest:admission", deterministic=True), \
                    self._perf_phase("admission"):
                verdict = self.admission.admit(msg.sender_id, delta,
                                               raw_samples, None,
                                               self.version)
            if not verdict.ok:
                log.warning("rejecting version-%d upload from silo %d "
                            "(reason=%s)", base_version, msg.sender_id,
                            verdict.reason)
                if self.health is not None:
                    with self._perf_phase("health"):
                        self.health.observe_rejected(msg.sender_id,
                                                     verdict.reason)
                if self.journal is not None:
                    with self._perf_phase("journal"):
                        self.journal.note_accept(
                            self.version, msg.sender_id, 0.0,
                            folded=False, reason=verdict.reason)
                if crc is None:
                    crc = _payload_crc(delta)
                self._rejected_crcs.setdefault(pair, set()).add(crc)
                if self.degrade is not None:
                    self.degrade.note_fault(FaultClass.PAYLOAD,
                                            silo=msg.sender_id,
                                            detail=verdict.reason)
                if self.admission.trust.state(
                        msg.sender_id, self.version) == "quarantined":
                    self._bench(msg.sender_id)
                else:
                    # an honest silo behind a corrupting wire stays in
                    # rotation; only quarantine takes it out
                    self._task(msg.sender_id, self._next_client())
                return
            num_samples = verdict.num_samples
            # the screen's one norm pass is shared with health
            delta_norm = verdict.norm
        else:
            try:
                num_samples = float(raw_samples)
            except (TypeError, ValueError):
                num_samples = float("nan")
            if not math.isfinite(num_samples) or num_samples <= 0:
                self._reject_malformed(
                    msg, base_version,
                    f"invalid num_samples {raw_samples!r} "
                    f"(version {base_version})")
                return
        if self.degrade is not None:
            t0 = self._tasked_at.get(msg.sender_id)
            if t0 is not None:
                self.degrade.observe_completion(msg.sender_id,
                                                time.monotonic() - t0)
            self.degrade.note_accept(msg.sender_id)
        staleness = self.version - base_version
        discount = float(1.0 + staleness) ** (-self.alpha)
        self.staleness_seen.append(staleness)
        self._h_staleness.observe(staleness)
        if self.health is not None:
            # health folds BEFORE the aggregation fold consumes the delta
            with self._perf_phase("health"):
                self.health.observe_admitted(msg.sender_id, delta,
                                             num_samples, norm=delta_norm,
                                             staleness=staleness)
        if self.faultline is not None:
            self.faultline.maybe_crash("post_admission_pre_fold",
                                       round_idx=self.version,
                                       silo=msg.sender_id)
        if self.stream_agg is not None:
            # fold at arrival: the buffer keeps only the metadata tuple
            with self._span("ingest:fold", deterministic=True), \
                    self._perf_phase("fold"):
                self.stream_agg.fold(flatten_nested(delta), num_samples)
            delta = None
            if self.journal is not None:
                # the base version rides the record, so a resume rebuilds
                # the buffer tuple and its discount
                state_fn = (self.stream_agg.state_dict
                            if self.stream_agg.method == "mean" else None)
                with self._span("ingest:journal", deterministic=True), \
                        self._perf_phase("journal"):
                    self.journal.note_accept(
                        self.version, msg.sender_id, float(num_samples),
                        extra={"base": int(base_version)},
                        state_fn=state_fn)
        if self.faultline is not None:
            self.faultline.maybe_crash("post_fold_pre_ack",
                                       round_idx=self.version,
                                       silo=msg.sender_id)
        self._buffer.append(
            (delta, num_samples, discount, msg.sender_id, base_version))
        if len(self._buffer) >= self._effective_goal():
            self._apply_buffer()

    def _bench(self, silo: int) -> None:
        """Take a quarantined silo out of the rotation; flush a buffer the
        shrunk goal now meets; finish if nobody is left."""
        self._benched.add(silo)
        if len(self._benched) >= self.n_silos:
            log.error("every silo is quarantined; no safe progress is "
                      "possible — finishing at version %d", self.version)
            for s in range(1, self.n_silos + 1):
                self.send(MsgType.S2C_FINISH, s)
            self.finish()
            return
        if self._buffer and len(self._buffer) >= self._effective_goal():
            self._apply_buffer()

    def _reject_malformed(self, msg: Message, base_version: int,
                          detail: str) -> None:
        """Structurally malformed frames: warn, strike (with admission),
        then re-task the silo once per unique offending frame."""
        pair = (msg.sender_id, base_version)
        crc = _payload_crc(msg.get(Message.ARG_MODEL_PARAMS))
        seen = self._rejected_crcs.setdefault(pair, set())
        if crc in seen:
            log.info("ignoring duplicate malformed upload from silo %d",
                     msg.sender_id)
            return
        seen.add(crc)
        log.warning("rejecting upload from silo %d: %s", msg.sender_id,
                    detail)
        if self.degrade is not None:
            self.degrade.note_fault(FaultClass.PAYLOAD,
                                    silo=msg.sender_id, detail=detail)
        if self.health is not None:
            with self._perf_phase("health"):
                self.health.observe_rejected(msg.sender_id, "malformed")
        if self.admission is not None:
            self.admission.reject(msg.sender_id, self.version,
                                  "fingerprint")
            if self.admission.trust.state(
                    msg.sender_id, self.version) == "quarantined":
                self._bench(msg.sender_id)
                return
        if msg.sender_id in self._benched:
            return  # owned by the probation release
        self._task(msg.sender_id, self._next_client())

    def _effective_goal(self) -> int:
        """The goal, shrunk by benched silos (a goal above the active
        count would freeze versions forever)."""
        active = self.n_silos - len(self._benched)
        return max(1, min(self.goal, active))

    # -- the version step (host f64, as the JAX package's) -------------------
    def _host_flat(self) -> Dict[str, np.ndarray]:
        return {k: host_array(self.params[k]) for k in self._keys}

    def _set_params(self, host: Dict[str, np.ndarray]) -> None:
        self.params = {k: torch.from_numpy(np.ascontiguousarray(host[k]))
                       .to(self.device) for k in self._keys}

    def _apply_discounted(self, robust, discounts, samples) -> None:
        """The defended/stream step: the rule (or the streamed mean) saw
        raw sample weights, and the buffer's sample-weighted mean
        discount scales the applied step."""
        davg = float((discounts * samples).sum()
                     / max(samples.sum(), 1e-12))
        p_host = self._host_flat()
        d_host = {k: host_array(robust[k]) for k in self._keys}
        if self.server_opt is not None and self.server_opt.name != "plain":
            # Δ = −davg·d in host f64 (w − lr·Δ recovers w + lr·davg·d),
            # then one optimizer step
            pseudo = {k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(-davg * np.asarray(d_host[k], np.float64))
                .astype(p_host[k].dtype))).to(self.device)
                for k in self._keys}
            self.params = self.server_opt.apply_delta(self.params, pseudo,
                                                      self.version)
            return
        self._set_params({
            k: (np.asarray(p_host[k], np.float64)
                + self.server_lr * davg
                * np.asarray(d_host[k], np.float64)).astype(p_host[k].dtype)
            for k in self._keys})

    def _apply_buffer(self) -> None:
        if self.faultline is not None:
            self.faultline.maybe_crash("barrier_close",
                                       round_idx=self.version)
        now = time.monotonic()
        if self._version_t0 is not None:
            self._h_version.observe(now - self._version_t0)
        self._version_t0 = now
        deltas = [d for d, _, _, _, _ in self._buffer]
        samples = np.asarray([n for _, n, _, _, _ in self._buffer],
                             np.float64)
        discounts = np.asarray([c for _, _, c, _, _ in self._buffer],
                               np.float64)
        defended = (self.defended_aggregate is not None
                    or (self.stream_agg is not None
                        and self.stream_agg.defended))
        # traced as a child of the upload handling that tripped the goal
        with self._span("aggregate", version=self.version,
                        buffered=len(deltas)), \
                self._perf_phase("defended_aggregate" if defended
                                 else "aggregate"):
            if self.stream_agg is not None:
                self._apply_discounted(self.stream_agg.finalize(self.version),
                                       discounts, samples)
            elif self.defended_aggregate is not None:
                # the stack padded to the full goal with weight-0 zero
                # slots, so a quarantine-shrunk buffer keeps its shape
                flat = [{k: np.asarray(v) for k, v in
                         flatten_nested(d).items()} for d in deltas]
                if self._delta_zeros is None:
                    self._delta_zeros = {k: np.zeros_like(v)
                                         for k, v in flat[0].items()}
                pad = [self._delta_zeros] * (self.goal - len(flat))
                stacked = {k: torch.from_numpy(np.stack(
                    [t[k] for t in flat + pad])).to(self.device)
                    for k in self._keys}
                w = np.concatenate(
                    [samples, np.zeros(len(pad))]).astype(np.float32)
                if self._stacked_zeros is None:
                    self._stacked_zeros = {
                        k: torch.zeros(v.shape[1:], dtype=v.dtype,
                                       device=self.device)
                        for k, v in stacked.items()}
                self._apply_discounted(self.defended_aggregate(
                    self._stacked_zeros, stacked, w, self.version),
                    discounts, samples)
            else:
                # sample ratios sum to 1; each term carries its discount
                coeffs = discounts * samples / max(samples.sum(), 1e-12)
                leaves = [tree_leaves(d) for d in deltas]
                mean = [sum(c * np.asarray(l[i], np.float64)
                            for c, l in zip(coeffs, leaves))
                        for i in range(len(self._keys))]
                p_host = self._host_flat()
                self._set_params({
                    k: (np.asarray(p_host[k], np.float64)
                        + self.server_lr * m).astype(p_host[k].dtype)
                    for k, m in zip(self._keys, mean)})
        silos = [s for _, _, _, s, _ in self._buffer]
        if self.health is not None:
            # the version's health line closes on the post-apply global
            # BEFORE perf.round_end, so its phase lands in the same line
            with self._perf_phase("health"):
                self.health.round_end(self.version,
                                      new_global=self._host_params(),
                                      buffered=len(silos))
        self._consumed.update((s, b) for _, _, _, s, b in self._buffer)
        self._buffer.clear()
        if self.stream_agg is not None:
            self.stream_agg.reset(self.params)
        self.version += 1
        if self._rejected_crcs:
            # prune the dedupe ledger past 64 versions
            horizon = self.version - 64
            self._rejected_crcs = {p: c for p, c in
                                   self._rejected_crcs.items()
                                   if p[1] >= horizon}
        if self.faultline is not None:
            self.faultline.maybe_crash("mid_checkpoint_write",
                                       round_idx=self.version - 1)
        if self.checkpointer is not None:
            with self._perf_phase("checkpoint"):
                self.checkpointer.maybe_save(
                    self.version - 1, self._checkpoint_state,
                    last_round=self.version >= self.num_versions)
        if self.journal is not None:
            # after the checkpoint is durable
            with self._perf_phase("journal"):
                self.journal.round_end(self.version - 1)
        if self.faultline is not None:
            self.faultline.maybe_crash("publish",
                                       round_idx=self.version - 1)
        if self.perf is not None:
            # the applied version's line closes (a strict-mode
            # RecompileError raises here) BEFORE the eval hook, whose
            # cadence is its own
            vextra = ({"server_opt": self.server_opt.name}
                      if self.server_opt is not None else {})
            vextra["global_crc"] = tree_crc(self._host_params())
            self.perf.round_end(self.version - 1, buffered=len(silos),
                                **vextra)
        if self.on_version is not None:
            self.on_version(self.version, self.params)
        if self.version >= self.num_versions:
            for silo in range(1, self.n_silos + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
            return
        if self.perf is not None:
            # the next version's line opens AFTER the eval hook and before
            # the tasking wave, whose serialize is its first phase
            self.perf.round_start(self.version)
        # the journal opens the next version before the tasking wave: a
        # delta can arrive the moment the wave lands
        self._journal_round_start()
        if self.health is not None:
            with self._perf_phase("health"):
                self.health.round_start(self.version, self._host_params())
        # only the consumed silos get new work, drawn in buffer order
        with self._perf_phase("broadcast_serialize"):
            self._task_wave({silo: self._next_client() for silo in silos})
        if self.admission is not None:
            # the per-version trust sweep, then the probation release
            self.admission.trust.quarantined(
                self.version, range(1, self.n_silos + 1))
            for silo in sorted(self._benched):
                if self.admission.trust.state(
                        silo, self.version) != "quarantined":
                    self._benched.discard(silo)
                    log.info("silo %d released from quarantine at version "
                             "%d; re-tasking on probation", silo,
                             self.version)
                    self._task(silo, self._next_client())

    def finish(self) -> None:
        self._finished = True
        self._retask_timer.cancel(join=True)
        if self.ingest is not None:
            # no drain: finish may run on the fold worker
            self.ingest.stop()
        super().finish()
