"""Cross-silo FedAvg: the reference's distributed message choreography
over the host-edge transport layer.

Port of ``fedml_tpu/algorithms/cross_silo.py`` (the reference's
``FedAvgServerManager`` / ``FedAvgClientManager``: init broadcast, receive
barrier, aggregate, sync).  The subset ported here is the round lifecycle
with

* the streaming fold (``stream_agg``) and the sharded wire
  (``shard_wire``: per-shard slice frames, per-shard admission, the
  sharded fold and its K2 finalize);
* stack mode: the uploads staged at arrival in a ``[cohort, ...]``
  device buffer, closed by ``tree_weighted_mean`` or, with
  ``aggregate_fn``, by the defended aggregate
  (`robust.defense.make_defended_aggregate`: clip, a Byzantine rule,
  noise) over the static stack;
* the straggler policies ``wait``, ``drop`` and ``abort``
  (``round_timeout_s`` / ``min_silo_frac``);
* the admission pipeline, stale-round and foreign-upload discards, and
  the encode-once broadcast;
* fault tolerance: heartbeats and the `FailureDetector` (dead silos leave
  the quorum at broadcast, a rejoining silo gets the current global),
  round checkpoints with ``extra_state`` (``start()`` resumes), the round
  journal (a server killed mid-round resumes the same round and re-tasks
  only the silos not durably folded) and the `Faultline` crash points;
* live secure aggregation (``secagg``, `secure.protocol`): the round's
  stages agreement → upload → unmask, masked uploads folded in the ring
  at arrival, dropout recovery through the pair-secret shares, and
  abort-only journaling (a crashed secure round restarts from the
  boundary with the global unchanged);
* the server-optimizer seam (``server_opt``, `server_opt.optimizer`):
  the finalized mean becomes the pseudo-gradient ``global − finalize``
  and one optimizer step makes the new global;
* the reliability tracker (``degrade``, `robust.degrade`, JAX
  :432-444, :792-809, :963, :1023-1085): the adaptive straggler
  deadline, quorum-aware close with partition holds, and network-vs-
  payload fault attribution; its completion latencies ride the journal's
  accept records (``lat_s``) so a resumed round re-derives the deadline;
* wire compression (``decode_upload``, `comm.compress`, JAX
  :1415-1490): the scheme handshake, the decode before admission, and
  the silo's ``encode_upload``/``on_accepted`` hooks for error feedback;
* the pipelined receive path (``ingest``, `comm.ingest`, JAX :846-856,
  :986-992, :1291-1420): the transport thread checks the envelope and
  enqueues, one fold worker a shard stages the upload through its arena
  and runs the screen and fold in arrival order.

Every other option of the JAX actor is refused by name.  Neither the
heartbeat thread nor the straggler timer touches the device: both only
enqueue messages.

The wire carries the JAX package's nested dicts of numpy arrays, so a
frame is byte-identical to the JAX package's.  The actors convert at their
boundary: the server's global is the port's flat dict of tensors
(``self.params``) and its host copy in the wire layout is memoized per
params value (`core.pytree.HostMirror`); a silo's ``train_fn`` takes and
returns flat dicts, and its result becomes numpy before it is sent.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, Optional, Set

import numpy as np
import torch

from fedml_tpu_torch.comm.actors import (ClientManager, SelfMessageTimer,
                                         ServerManager)
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.core.pytree import (HostMirror, as_tensor,
                                         flatten_nested, nest, to_host,
                                         tree_keys, tree_weighted_mean)
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.obs import telemetry, trace
from fedml_tpu_torch.robust.degrade import FaultClass
from fedml_tpu_torch.secure.protocol import (MSG_SECAGG_ADVERT,
                                             MSG_SECAGG_ROSTER,
                                             MSG_SECAGG_SHARES,
                                             MSG_SECAGG_UNMASK, SecAggError)
from fedml_tpu_torch.shard_spine.admission import ACCEPT, WAIT
from fedml_tpu_torch.shard_spine.spine import SiloShardAssembler
from fedml_tpu_torch.utils.journal import tree_crc

log = logging.getLogger(__name__)


class MsgType:
    """Message-type constants (the JAX package's values)."""
    S2C_INIT = 1
    S2C_SYNC = 2
    C2S_MODEL = 3
    S2C_FINISH = 4
    ROUND_TIMEOUT = 5     # server self-message from the straggler timer
    C2S_HEARTBEAT = 6


class FailureDetector:
    """Heartbeat-driven silo health: ALIVE → SUSPECT → DEAD (the JAX
    package's detector).

    Every message from a silo (heartbeat or upload) is a beat; a silo
    unheard for ``suspect_after_s`` is SUSPECT (still in the barrier,
    flagged), one unheard for ``dead_after_s`` is DEAD and leaves the
    next round's expected quorum.  DEAD is sticky until the silo is heard
    again: that beat reports a *rejoin*, which the server answers with
    the current global.  ``clock`` is injectable for tests.
    """

    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"

    def __init__(self, suspect_after_s: float = 2.0,
                 dead_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if dead_after_s < suspect_after_s:
            raise ValueError(
                f"dead_after_s ({dead_after_s}) must be >= suspect_after_s "
                f"({suspect_after_s})")
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self._clock = clock
        self._last_heard: Dict[int, float] = {}
        self._declared_dead: Set[int] = set()
        reg = telemetry.get_registry()
        self._gauges = {
            self.ALIVE: reg.gauge("fedml_failure_detector_alive_total"),
            self.SUSPECT: reg.gauge("fedml_failure_detector_suspect_total"),
            self.DEAD: reg.gauge("fedml_failure_detector_dead_total")}

    def register(self, silo: int) -> None:
        """Start a silo's clock without a beat (nobody is born dead)."""
        self._last_heard.setdefault(silo, self._clock())

    def beat(self, silo: int) -> bool:
        """Record a beat; True when it rejoins a silo declared dead."""
        rejoined = silo in self._declared_dead
        self._declared_dead.discard(silo)
        self._last_heard[silo] = self._clock()
        return rejoined

    def state(self, silo: int) -> str:
        if silo in self._declared_dead:
            return self.DEAD
        last = self._last_heard.get(silo)
        if last is None:
            return self.ALIVE
        quiet = self._clock() - last
        if quiet >= self.dead_after_s:
            self._declared_dead.add(silo)
            return self.DEAD
        if quiet >= self.suspect_after_s:
            return self.SUSPECT
        return self.ALIVE

    def states(self) -> Dict[int, str]:
        out = {silo: self.state(silo) for silo in sorted(self._last_heard)}
        for health, gauge in self._gauges.items():
            gauge.set(sum(1 for s in out.values() if s == health))
        return out

    def dead_silos(self) -> Set[int]:
        return {silo for silo, health in self.states().items()
                if health == self.DEAD}


# a silo-local trainer: (global_params, client_idx, round_idx) ->
# (new_params, num_samples), params as the port's flat dicts
SiloTrainFn = Callable[[object, int, int], tuple]

class FedAvgServerActor(ServerManager):
    """Rank-0 aggregator actor.

    ``init_params``: the port's flat params dict; its device is where the
    global, the stack buffer and the replicated fold state live.
    ``straggler_policy``: ``"wait"`` (strict barrier; with a timeout it
    logs the missing silos and keeps waiting), ``"drop"`` (after
    ``round_timeout_s``, aggregate the silos that reported if at least
    ``min_silo_frac`` of the expected cohort did) or ``"abort"`` (after
    the timeout, FINISH every silo and stop).  ``admission``: an
    `AdmissionPipeline` over the nested host template; a rejected upload
    satisfies the barrier at weight 0 and quarantined silos are excluded
    from the broadcast.  ``stream_agg``: a `StreamingAggregator` (or, with
    ``shard_wire``, the spine's sharded one) folding each admitted upload
    at arrival; without it the round closes over the staged buffer with
    ``aggregate_fn(global, stacked, weights, round)`` when given (the
    static ``[cohort, ...]`` stack, slots of silos that did not report or
    were rejected holding the global at weight 0) or else
    ``tree_weighted_mean`` over the admitted slots.  ``shard_wire``: a
    `ShardSpine` — S slice frames per silo each way, screened per shard
    by its `ShardAdmission`.

    ``failure_detector``: a `FailureDetector` fed by every message from a
    silo; DEAD silos leave the expected quorum at broadcast (logged in
    ``dropped_silos``), and a dead silo heard again is sent the current
    global at once.  ``checkpointer``: a `utils.checkpoint.
    RoundCheckpointer`; every closed round's (params, round, accepted
    mask, ``extra_state[0]()``) is saved on its cadence, and ``start()``
    resumes from the latest step (untemplated on schema drift), or just
    sends FINISH when the federation is complete on disk.
    ``extra_state``: a ``(get_fn, set_fn)`` pair of fixed-shape host state
    checkpointed beside the params.  ``journal``: a `utils.journal.
    RoundJournal` on the streaming-fold receive path — an accept record
    per report and a fold-state snapshot every ``snapshot_every`` folds;
    ``start()`` resumes a round left mid-flight (same mode, round and
    opening global, a durable snapshot) and re-tasks only the silos it
    does not cover, else abandons it loudly.  ``faultline``: a
    `robust.faultline.Faultline` whose armed crash points raise
    `ActorKilled` out of the event loop with no cleanup.

    ``secagg``: a `secure.protocol.SecAggServer`; the round runs the
    masking choreography (sync carries ``ARG_SECAGG``, adverts, one
    roster frame per silo, masked uploads folded in the ring, the unmask
    request and the share reveals), exclusive with ``stream_agg``,
    ``aggregate_fn``, ``decode_upload`` and ``shard_wire``; with
    ``admission``, the pipeline is ``kind="masked"``.  ``server_opt``: a
    `server_opt.ServerOptimizer` applied to each closed round's finalize
    (exclusive with ``secagg``).

    ``degrade``: a `robust.degrade.ReliabilityTracker`.  The round's
    deadline derives once at broadcast from the tracker's history
    (``adaptive_deadline`` needs ``round_timeout_s``, its ceiling); under
    the ``drop`` policy a timeout asks the tracker to close, hold (a
    suspected partition: global unchanged, at most
    ``partition_max_holds`` times) or abandon the round.  Deadline drops
    and dead letters are network faults and never strike trust.
    ``decode_upload(payload, host_global) -> nested host params``: the
    wire-compression decoder (`comm.compress`); a plain upload to a
    decoding server, or a compressed one to a plain server, is a
    handshake mismatch (raised, or with ``admission`` rejected as
    ``fingerprint`` damage).  ``ingest``: a `comm.ingest.IngestPipeline`;
    the transport thread only checks the envelope and enqueues, and the
    shard's fold worker runs decode → screen → fold under the actor's
    ingest lock (exclusive with ``faultline``: `ActorKilled` cannot
    escape a worker thread).

    ``publish``: the serve-while-train hook, ``publish(host_params,
    round_idx)`` with the global in the wire layout (nested numpy) after
    every closed round (after its checkpoint and journal end) and once
    on a resume, so a `serve.registry.ModelRegistry` (or the release
    gate's ``offer``) serves the federation's own global while rounds
    keep running.
    """

    def __init__(self, transport: Transport, init_params,
                 client_num_in_total: int, client_num_per_round: int,
                 num_rounds: int,
                 on_round_done: Optional[Callable[[int, object], None]] = None,
                 straggler_policy: str = "wait",
                 round_timeout_s: Optional[float] = None,
                 min_silo_frac: float = 0.5,
                 admission=None, stream_agg=None, shard_wire=None,
                 aggregate_fn=None, failure_detector=None,
                 checkpointer=None, extra_state=None, journal=None,
                 faultline=None, *, secagg=None, ingest=None, health=None,
                 perf=None, server_opt=None, controller=None, degrade=None,
                 decode_upload=None, publish=None):
        super().__init__(0, transport)
        if straggler_policy not in ("wait", "drop", "abort"):
            raise ValueError(f"unknown straggler_policy {straggler_policy!r}")
        if aggregate_fn is not None and stream_agg is not None:
            raise ValueError("aggregate_fn (stack mode) and stream_agg "
                             "(stream mode) are exclusive")
        if shard_wire is not None:
            if stream_agg is None:
                raise ValueError(
                    "shard_wire without its sharded stream_agg: pass the "
                    "spine's ShardedStreamingAggregator as stream_agg (they "
                    "are one subsystem)")
            if shard_wire.admission is None:
                raise ValueError(
                    "shard_wire without its ShardAdmission: the per-shard "
                    "structural screens ARE the sharded wire protocol — "
                    "build the spine with admission_on=True")
            if decode_upload is not None:
                raise ValueError(
                    "shard_wire (--model_shards) requires the streaming "
                    "fold: the stack path and the wire-compression "
                    "decoder are whole-model by construction")
        if secagg is not None and (aggregate_fn is not None
                                   or stream_agg is not None
                                   or decode_upload is not None):
            raise ValueError(
                "secagg is mutually exclusive with aggregate_fn/"
                "stream_agg/decode_upload: masked uploads have no "
                "plaintext to stack, stream, or decompress")
        if secagg is not None and shard_wire is not None:
            raise ValueError(
                "shard_wire (--model_shards) and secagg are mutually "
                "exclusive: a pairwise-masked uint32 ring word cannot be "
                "re-sliced per shard without breaking mask cancellation")
        if server_opt is not None and secagg is not None:
            raise ValueError(
                "server_opt and secagg are mutually exclusive: the "
                "masked-sum finalize yields a plain mean by protocol "
                "construction; there is no seam to re-step it through "
                "a server optimizer without unmasking intermediate state")
        if journal is not None and stream_agg is None and secagg is None:
            raise ValueError(
                "journal (crash consistency) rides the streaming-fold "
                "receive path: pass --agg_mode stream (or --secagg); the "
                "stack path has no incremental fold state to snapshot")
        if degrade is not None and degrade.adaptive_deadline \
                and round_timeout_s is None:
            raise ValueError(
                "adaptive_deadline requires round_timeout_s: the static "
                "timeout is the deadline's ceiling (and the cold-start "
                "fallback before the tracker warms)")
        if ingest is not None and faultline is not None:
            raise ValueError(
                "--ingest_pipeline and --faultline are mutually "
                "exclusive: ActorKilled must escape the transport event "
                "loop to reach the harness, and an ingest fold worker "
                "thread has no path there")
        if controller is not None and health is None:
            raise ValueError(
                "controller (--adaptive) requires the health observatory "
                "(--health): its decisions are a pure function of the "
                "per-round drift-alarm line")
        self.perf = perf
        self.health = health
        self.controller = controller
        # the round's root span (tracing on): broadcast and aggregate hang
        # under it, the silos' recv/train/upload spans stitch in by header
        self._round_span = None
        self.params = init_params
        self.device = next(iter(init_params.values())).device
        self.client_num_in_total = client_num_in_total
        self.client_num_per_round = client_num_per_round
        self.num_rounds = num_rounds
        self.round_idx = 0
        self.on_round_done = on_round_done
        self.publish = publish
        self.straggler_policy = straggler_policy
        self.round_timeout_s = round_timeout_s
        self.min_silo_frac = min_silo_frac
        self.aborted = False
        self.admission = admission
        self.stream_agg = stream_agg
        self.aggregate_fn = aggregate_fn
        self.shard_wire = shard_wire
        self.failure_detector = failure_detector
        self.checkpointer = checkpointer
        self.extra_state = extra_state
        self.journal = journal
        self.faultline = faultline
        self.secagg = secagg
        self.server_opt = server_opt
        self.degrade = degrade
        self.decode_upload = decode_upload
        self.ingest = ingest
        # the round's armed deadline, derived once a round at broadcast
        # from the tracker's history (never recomputed on re-arms)
        self._round_deadline_s: Optional[float] = None
        # silos whose frames sit in the ingest queue, not yet folded (the
        # transport-side duplicate guard), and the lock that serializes
        # the worker's upload body against the timeout and round close
        self._ingest_inflight: Set[int] = set()
        self._ingest_lock = threading.RLock()
        # the secure round's stage: None | "agreement" | "upload" | "unmask"
        self._secagg_stage: Optional[str] = None
        self._secagg_quorum = 0
        self._secagg_unmask_laps = 0
        self._secagg_agreement_laps = 0
        # a mid-round recovery found by start(), consumed by the next
        # broadcast of its round
        self._pending_resume = None
        self.dropped_silos: Dict[int, list] = {}  # round -> missing silos
        self._received: Dict[int, Optional[tuple]] = {}
        self._host_mirror = HostMirror()
        # stack mode: slot i-1 of a [cohort, ...] device buffer per leaf
        # belongs to silo i, filled at arrival, released at round close
        self._staging: Optional[Dict[str, torch.Tensor]] = None
        self._staged_seen = 0
        self._staged_silos: Set[int] = set()
        self._num_silos = 0
        self._expected: Set[int] = set()
        self._timer = SelfMessageTimer()
        self._finished = False
        self._last_accepted: Optional[np.ndarray] = None
        reg = telemetry.get_registry()
        self._h_round = reg.histogram("fedml_round_duration_seconds")
        self._h_straggler = reg.histogram(
            "fedml_round_straggler_wait_seconds")
        self._h_quorum = reg.histogram(
            "fedml_round_quorum_size_total",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self._g_staged = reg.gauge("fedml_wire_staged_uploads_total")
        self._round_t0: Optional[float] = None
        self._first_upload_t: Optional[float] = None

    def register_handlers(self) -> None:
        self.register_handler(MsgType.C2S_MODEL, self._on_model)
        self.register_handler(MsgType.ROUND_TIMEOUT, self._on_timeout)
        self.register_handler(MsgType.C2S_HEARTBEAT,
                              lambda m: self._beat(m.sender_id))
        if self.secagg is not None:
            self.register_handler(MSG_SECAGG_ADVERT, self._on_secagg_advert)
            self.register_handler(MSG_SECAGG_SHARES, self._on_secagg_shares)

    # -- round logic ---------------------------------------------------------
    def start(self) -> None:
        """Broadcast the initial global — or, with a ``checkpointer``
        holding a saved round, resume after it (params, round index, the
        accepted-silo ack and ``extra``), and with a ``journal``, resume
        a round the crash left mid-flight."""
        if self.checkpointer is not None:
            self._restore_checkpoint()
        if self.journal is not None:
            self._pending_resume = self._journal_recovery()
        if self.round_idx >= self.num_rounds:
            # the federation already completed on disk: dismiss the silos
            cohort = len(sample_clients(0, self.client_num_in_total,
                                        self.client_num_per_round))
            for silo in range(1, cohort + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
            return
        self._broadcast(MsgType.S2C_INIT)

    def _restore_checkpoint(self) -> None:
        step = self.checkpointer.latest_round()
        if step is None:
            return
        try:
            state = self.checkpointer.restore(
                step, like=self._checkpoint_state(step))
        except ValueError:
            # schema drift (an "extra" entry added or gone since the
            # save): restore untemplated and take what is there
            log.warning("checkpoint %d does not match the current state "
                        "schema; restoring untemplated", step)
            state = self.checkpointer.restore(step)
        self.params = {k: as_tensor(v, self.device).to(self.params[k].dtype)
                       for k, v in state["params"].items()}
        self.round_idx = int(np.asarray(state["round_idx"])) + 1
        mask = np.asarray(state["accepted_mask"])
        # a possibly-empty ARRAY, as _complete_round leaves it
        self._last_accepted = (np.flatnonzero(mask) + 1).astype(np.int32)
        if self.extra_state is not None and "extra" in state:
            self.extra_state[1](state["extra"])
        if self.publish is not None:
            self.publish(self._host_params(), self.round_idx - 1)
        log.info("resumed from checkpoint: continuing at round %d of %d",
                 self.round_idx, self.num_rounds)

    def _checkpoint_state(self, round_idx: int) -> Dict[str, object]:
        """The round state saved after round ``round_idx``: every leaf has
        a fixed shape (the accepted silos as a cohort-length mask), so it
        doubles as the restore template."""
        cohort = len(sample_clients(0, self.client_num_in_total,
                                    self.client_num_per_round))
        mask = np.zeros(cohort, np.int8)
        if self._last_accepted is not None and len(self._last_accepted):
            mask[np.asarray(self._last_accepted) - 1] = 1
        out = {"params": self.params,
               "round_idx": np.asarray(round_idx, np.int64),
               "accepted_mask": mask}
        if self.extra_state is not None:
            out["extra"] = self.extra_state[0]()
        return out

    def _journal_mode(self) -> str:
        """The journal's round-mode tag for this configuration; recovery
        refuses a journal written under another one (a non-plain
        server optimizer is part of the tag)."""
        if self.secagg is not None:
            return "secagg"
        srvopt = ""
        if self.server_opt is not None and self.server_opt.name != "plain":
            srvopt = f"+srvopt={self.server_opt.name}"
        if self.shard_wire is not None:
            return self.shard_wire.journal_mode() + srvopt
        return f"stream_{self.stream_agg.method}{srvopt}"

    def _journal_recovery(self):
        """The journal's mid-flight round as a `Recovery`, only when
        resuming it is safe: it is the round the checkpoint says comes
        next, its mode is this run's and resumable, its opening global's
        crc is the restored global's, and a durable snapshot exists.
        Anything else is abandoned loudly: the round restarts from the
        boundary with the global unchanged."""
        rec = self.journal.recover()
        if rec is None:
            return None
        if rec.round_idx != self.round_idx:
            log.warning(
                "journal holds mid-flight round %d but the checkpoint "
                "boundary resumes at round %d (checkpoint cadence gap); "
                "abandoning the journal round — rounds past the last "
                "checkpoint re-run from the boundary (set "
                "--checkpoint_every 1 for mid-round recovery)",
                rec.round_idx, self.round_idx)
            self.journal.abandon(rec.round_idx, "round mismatch")
            return None
        if rec.mode != self._journal_mode():
            log.error("round %d journal was written in mode %r but this run "
                      "aggregates in mode %r; restarting the round from the "
                      "boundary, global unchanged", rec.round_idx, rec.mode,
                      self._journal_mode())
            self.journal.abandon(rec.round_idx, f"mode mismatch {rec.mode}")
            return None
        if not rec.resumable:
            log.error("round %d crashed mid-flight in non-resumable mode %r "
                      "(secure rounds are abort-only: resuming a "
                      "half-masked fold would need shares nobody agreed "
                      "to reveal; reservoir rules have no durable draw "
                      "stream); "
                      "restarting the round from the boundary, global "
                      "unchanged", rec.round_idx, rec.mode)
            self.journal.abandon(rec.round_idx,
                                 f"non-resumable mode {rec.mode}")
            return None
        if rec.global_crc is not None \
                and rec.global_crc != tree_crc(self._host_params()):
            log.error("round %d journal opened against a DIFFERENT global "
                      "than the restored checkpoint (crc mismatch); "
                      "refusing to resume the fold — restarting from the "
                      "boundary", rec.round_idx)
            self.journal.abandon(rec.round_idx, "global crc mismatch")
            return None
        if rec.state is None or not rec.folded:
            log.warning("round %d crashed before any durable fold snapshot; "
                        "re-tasking the full cohort from the boundary",
                        rec.round_idx)
            self.journal.abandon(rec.round_idx, "no durable snapshot")
            return None
        log.warning("round %d: resuming MID-ROUND from the journal — %d "
                    "upload(s) durably folded (silos %s) will not be "
                    "re-tasked", rec.round_idx, len(rec.folded),
                    [s for s, _, _ in rec.folded])
        return rec

    def _sampled(self) -> np.ndarray:
        per = self.client_num_per_round
        if self.controller is not None:
            # the adaptive cohort lever, capped at the configured cohort:
            # the local backend builds exactly client_num_per_round silo
            # actors, so cross_silo can never task a wider cohort
            per = min(max(1, self.controller.cohort),
                      self.client_num_per_round)
        return sample_clients(self.round_idx, self.client_num_in_total,
                              per)

    def _host_params(self):
        """The global in the wire layout (nested numpy), one device-to-host
        transfer per params value."""
        return self._host_mirror.get(self.params)

    def _trust(self):
        if self.admission is not None:
            return self.admission.trust
        if self.shard_wire is not None:
            return self.shard_wire.admission.trust
        return None

    def _broadcast(self, msg_type) -> None:
        ids = self._sampled()
        self._num_silos = len(ids)
        cohort = set(range(1, self._num_silos + 1))
        # a mid-round recovery: the durably folded silos are not re-tasked
        # and satisfy the barrier at once
        resume = self._pending_resume
        if resume is not None and resume.round_idx != self.round_idx:
            resume = None
        self._pending_resume = None
        folded = ({int(s): float(w) for s, w, _ in resume.folded}
                  if resume is not None else {})
        dead: Set[int] = set()
        if self.failure_detector is not None:
            for silo in cohort:
                self.failure_detector.register(silo)
            dead = self.failure_detector.dead_silos() & cohort
        trust = self._trust()
        if trust is not None:
            dead = dead | trust.quarantined(self.round_idx, cohort)
        if dead == cohort:
            # every silo dead or quarantined: expect the full cohort, so
            # the barrier never closes on nothing and a rejoin can revive
            # the federation
            dead = set()
        if self.secagg is not None and len(cohort - dead) < 2:
            # fewer than 2 live silos cannot mask: task the full cohort
            # (the rejoin sync carries no masking parameters); silos that
            # are truly gone stall the agreement, which abandons the
            # round after its lap cap
            log.warning("round %d: fewer than 2 live silos for the "
                        "masking group; tasking the full cohort and "
                        "waiting for returns", self.round_idx)
            dead = set()
        self._expected = cohort - dead
        if dead:
            log.info("round %d: excluding dead/quarantined silos %s from "
                     "the quorum", self.round_idx, sorted(dead))
            self.dropped_silos.setdefault(self.round_idx, []).extend(
                sorted(dead))
        self._round_t0 = time.monotonic()
        self._first_upload_t = None
        self._round_deadline_s = None
        if self.degrade is not None:
            self.degrade.round_start(self.round_idx, self._expected)
            # derived from the history BEFORE any of this round's arrivals
            # (the restored folds included): the crashed process armed
            # from this state, so a resumed round re-derives the same value
            self._round_deadline_s = self.degrade.deadline_s(
                self._expected, self.round_timeout_s)
            if resume is not None:
                # replay the restored folds' completion latencies, so the
                # next round's deadline sees the crashed process's history
                for silo, _w, extra in resume.folded:
                    lat = (extra or {}).get("lat_s")
                    if lat is not None:
                        self.degrade.observe_completion(int(silo),
                                                        float(lat))
                    self.degrade.note_accept(int(silo))
        if self.perf is not None:
            # the ledger round opens HERE: broadcast serialize is its
            # first phase, round_end closes it at the round's end
            self.perf.round_start(self.round_idx)
        if self._tracer is not None:
            # one trace per round, rooted here: broadcast/recv/train/
            # upload/aggregate all stitch under this trace id
            self._round_span = self._tracer.start_span(
                "round", parent=None, node=self.node_id,
                trace_id=self._tracer.new_trace_id(
                    f"round{self.round_idx}"),
                round=self.round_idx)
        if self.stream_agg is not None:
            self.stream_agg.reset(self.params)
            if resume is not None:
                # continue the crashed round's fold where its last durable
                # snapshot left it (device <- host), and re-arm the fresh
                # journal's round state so it keeps snapshotting
                with self._perf_phase("journal"):
                    self.stream_agg.load_state_dict(resume.state)
                    self.journal.note_resume(self.round_idx, resume.folded,
                                             global_crc=resume.global_crc)
        host_params = self._host_params()
        if self.shard_wire is not None:
            with self._perf_phase("admission"):
                self.shard_wire.round_start(host_params)
        if self.ingest is not None and self.ingest.has_arenas:
            # the round's screen reference into each shard arena: one
            # copy an arena a round
            with self._perf_phase("admission"):
                self.ingest.round_start(
                    list(self.shard_wire.broadcast_slices(host_params))
                    if self.shard_wire is not None else [host_params])
        if self.journal is not None and resume is None:
            with self._perf_phase("journal"):
                self.journal.round_start(
                    self.round_idx, mode=self._journal_mode(),
                    resumable=(self.secagg is None
                               and self.stream_agg.method == "mean"),
                    global_crc=tree_crc(host_params),
                    expected=sorted(self._expected))
        if self.health is not None:
            # the health round opens against the host mirror the broadcast
            # ships; silos excluded at broadcast tick their fairness
            # counters without an upload
            with self._perf_phase("health"):
                self.health.round_start(self.round_idx, host_params,
                                        expected=sorted(self._expected),
                                        excluded=sorted(dead))
        extra = ({} if self._last_accepted is None
                 else {Message.ARG_ACCEPTED: self._last_accepted})
        if self.secagg is not None:
            # the sync frame carries the round's masking parameters, so
            # silos need no secure-aggregation configuration
            with self._perf_phase("mask_agreement"):
                self.secagg.round_start(self.round_idx,
                                        sorted(self._expected))
                self._secagg_stage = "agreement"
                self._secagg_agreement_laps = 0
                extra[Message.ARG_SECAGG] = self.secagg.sync_info()
        receivers = sorted(cohort - dead - set(folded))
        per_silo = {silo: {Message.ARG_CLIENT_INDEX: int(ids[silo - 1])}
                    for silo in receivers}
        with self._span("broadcast", parent=self._round_span,
                        round=self.round_idx), \
                self._perf_phase("broadcast_serialize"):
            if self.shard_wire is not None:
                # one encode-once fan-out per shard; shard 0's frames carry
                # the round metadata, the plan spec and each silo's client
                n_shards = self.shard_wire.num_shards
                for s, slice_s in enumerate(
                        self.shard_wire.broadcast_slices(host_params)):
                    shared = {Message.ARG_MODEL_PARAMS: slice_s,
                              Message.ARG_ROUND: self.round_idx,
                              Message.ARG_SHARD: s,
                              Message.ARG_SHARD_COUNT: n_shards}
                    if s == 0:
                        shared.update(extra)
                        shared[Message.ARG_SHARD_SPEC] = \
                            self.shard_wire.spec()
                    self.send_many(msg_type, receivers, shared_params=shared,
                                   per_receiver_params=(per_silo if s == 0
                                                        else None))
            else:
                self.send_many(
                    msg_type, receivers,
                    shared_params={Message.ARG_MODEL_PARAMS: host_params,
                                   Message.ARG_ROUND: self.round_idx,
                                   **extra},
                    per_receiver_params=per_silo)
        if folded:
            # the restored uploads satisfy the barrier like live reports;
            # a fully durable round closes here
            for silo, weight in folded.items():
                self._received[silo] = (self._STAGED, weight)
            if self._barrier_met():
                self._complete_round()
                return
        self._arm_timer()

    def _barrier_met(self) -> bool:
        if self._expected:
            return self._expected <= set(self._received)
        return len(self._received) >= self._num_silos

    # -- straggler timer -----------------------------------------------------
    def _effective_timeout_s(self) -> Optional[float]:
        """The round's armed deadline: the tracker's adaptive value
        (derived once at broadcast) with ``degrade``, else the static
        ``round_timeout_s``."""
        if self._round_deadline_s is not None:
            return self._round_deadline_s
        return self.round_timeout_s

    def _arm_timer(self) -> None:
        timeout = self._effective_timeout_s()
        if timeout is None:
            return
        round_at_arm = self.round_idx
        # the fire only ENQUEUES a self-message: all policy logic runs on
        # the transport's event loop
        self._timer.arm(
            timeout,
            lambda: self.send(MsgType.ROUND_TIMEOUT, 0,
                              **{Message.ARG_ROUND: round_at_arm}))

    def _on_timeout(self, msg: Message) -> None:
        if self.ingest is not None:
            # frames off the wire but still queued are not stragglers:
            # drain before judging the barrier (a queued fold may close
            # the round, and the stale-round guard below then bails)
            self.ingest.drain()
        with self._ingest_lock:
            self._on_timeout_locked(msg)

    def _on_timeout_locked(self, msg: Message) -> None:
        if msg.get(Message.ARG_ROUND) != self.round_idx or self._finished:
            return  # stale timer from an already-completed round
        if self._secagg_stage == "agreement":
            self._secagg_agreement_timeout()
            return
        if self._secagg_stage == "unmask":
            self._secagg_unmask_timeout()
            return
        missing = sorted(self._expected - set(self._received))
        if not missing:
            return
        if self.failure_detector is not None:
            states = self.failure_detector.states()
            log.warning("round %d: silo health %s", self.round_idx,
                        {s: states.get(s, "?") for s in missing})
        log.warning("round %d: silos %s have not reported after %.1fs "
                    "(policy=%s)", self.round_idx, missing,
                    self.round_timeout_s, self.straggler_policy)
        if self.straggler_policy == "abort":
            self.aborted = True
            for silo in range(1, self._num_silos + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
            return
        quorum = max(1, math.ceil(self.min_silo_frac * len(self._expected)))
        if self.degrade is not None and self.straggler_policy == "drop":
            self._degrade_timeout(missing, quorum)
            return
        if self.straggler_policy == "drop" and len(self._received) >= quorum:
            self.dropped_silos.setdefault(self.round_idx, []).extend(missing)
            self._complete_round()
            return
        self._arm_timer()  # wait (or drop below quorum): keep waiting

    def _degrade_timeout(self, missing, quorum: int) -> None:
        """The tracker adjudicates the timed-out round: ``min_quorum``
        may raise the close threshold (never below ``min_silo_frac``'s),
        and a correlated miss with network evidence holds the round."""
        floor = self.degrade.quorum_for(len(self._expected))
        if floor is not None:
            quorum = max(quorum, floor)
        verdict = self.degrade.assess_timeout(
            self.round_idx, self._expected, set(self._received), quorum,
            detector_states=(self.failure_detector.states()
                             if self.failure_detector is not None
                             else None))
        log.warning("round %d: degrade verdict %s", self.round_idx,
                    verdict.as_dict())
        if verdict.action == "hold":
            # a partition, not a mass failure: keep the global and give
            # it a chance to heal before folding a minority view
            self._arm_timer()
            return
        if verdict.action == "abandon":
            self._abandon_partitioned_round(missing, verdict)
            return
        if verdict.action == "close":
            # the dropped silos are honest until payload evidence says
            # otherwise: debt accrues, the fault ledger books a network
            # entry, and trust is never touched from here
            for silo in missing:
                self.degrade.note_drop(silo)
            self.dropped_silos.setdefault(self.round_idx, []).extend(
                missing)
            self._complete_round()
            return
        self._arm_timer()  # below quorum: keep waiting

    def _abandon_partitioned_round(self, missing, verdict) -> None:
        """The suspected partition outlived its hold budget: abandon the
        round loudly with the global unchanged, and journal the abandon,
        so a resume never re-folds the minority view."""
        log.error("round %d: abandoning after %d partition holds "
                  "(missing=%s; %s); the global model is unchanged",
                  self.round_idx, verdict.holds, missing, verdict.reason)
        self._timer.cancel()
        self.dropped_silos.setdefault(self.round_idx, []).extend(missing)
        self._received.clear()
        self._last_accepted = np.asarray([], np.int32)
        if self.journal is not None:
            with self._perf_phase("journal"):
                self.journal.abandon(self.round_idx,
                                     "partition: " + verdict.reason)
        self._finish_round(0)

    # -- health --------------------------------------------------------------
    def _beat(self, silo: int) -> None:
        if self.failure_detector is None:
            return
        rejoined = self.failure_detector.beat(silo)
        if rejoined and not self._finished and not self.aborted \
                and self.round_idx < self.num_rounds:
            # the returning silo gets the current global and round at once,
            # so it is warm when the next broadcast re-includes it; its
            # upload for THIS round is discarded (it is not expected)
            log.info("silo %d rejoined at round %d; syncing current global",
                     silo, self.round_idx)
            ids = self._sampled()
            client_idx = int(ids[silo - 1]) if silo - 1 < len(ids) else 0
            self.send(MsgType.S2C_SYNC, silo,
                      **{Message.ARG_MODEL_PARAMS: self._host_params(),
                         Message.ARG_CLIENT_INDEX: client_idx,
                         Message.ARG_ROUND: self.round_idx})

    # -- the receive path ----------------------------------------------------
    def _on_model(self, msg: Message) -> None:
        self._beat(msg.sender_id)
        if not self._upload_guards(msg, check_inflight=True):
            return
        # one wire arrival per upload frame (shard slices each count):
        # the critical-path observatory's idle classifier keys on this
        self._note_arrival()
        if self.ingest is not None:
            # pipelined: this thread only enqueues to the shard's fold
            # worker, which re-runs the guards under the ingest lock
            shard = 0
            if self.shard_wire is not None:
                s = msg.get(Message.ARG_SHARD)
                if isinstance(s, int) and 0 <= s < self.ingest.num_shards:
                    shard = s
                # a missing or malformed shard tag rides queue 0, where
                # the screen rejects it as structural damage
            else:
                self._ingest_inflight.add(msg.sender_id)
            ok = self.ingest.submit(
                shard, lambda: self._ingest_task(msg),
                detail=f"silo {msg.sender_id} round {self.round_idx}")
            if not ok and self.shard_wire is None:
                # overflow: dead-lettered as a network fault; the silo is
                # simply not heard from this round
                self._ingest_inflight.discard(msg.sender_id)
            return
        self._upload_body(msg)

    def _ingest_task(self, msg: Message) -> None:
        """One queued upload on its shard's fold worker: the arena stage
        (gather, one copy, the device screen) outside the ingest lock,
        where the per-shard parallelism lives, then the guards and the
        upload body under it."""
        silo = msg.sender_id
        try:
            pre = None
            if self.shard_wire is not None:
                s = msg.get(Message.ARG_SHARD)
                arena = (self.ingest.arena_for(s)
                         if isinstance(s, int)
                         and 0 <= s < self.ingest.num_shards else None)
            else:
                arena = self.ingest.arena_for(0)
            if arena is not None:
                with self._span("ingest:decode", deterministic=True):
                    pre = arena.stage_message(msg, Message.ARG_MODEL_PARAMS)
                    if pre is None:
                        # an in-process object message: stage the tree
                        pre = arena.stage_tree(
                            msg.get(Message.ARG_MODEL_PARAMS))
            with self._ingest_lock:
                if not self._upload_guards(msg, check_inflight=False):
                    return
                self._upload_body(msg, pre=pre)
        finally:
            if self.shard_wire is None:
                with self._ingest_lock:
                    self._ingest_inflight.discard(silo)

    def _upload_body(self, msg: Message, pre=None) -> None:
        """Everything past the envelope guards: decode, admission (``pre``
        carries the arena's screen), and the fold or stage."""
        if self._first_upload_t is None:
            self._first_upload_t = time.monotonic()
        if self.shard_wire is not None:
            self._on_shard_upload(msg, pre=pre)
        else:
            self._on_plain_upload(msg, pre=pre)

    def _upload_guards(self, msg: Message,
                       check_inflight: bool = True) -> bool:
        """The envelope guards: round tag, secagg stage, quorum
        membership, duplicates.  The pipelined path runs them twice: on
        the transport thread (with ``check_inflight``, the queued-but-
        unfolded duplicate guard) and again on the fold worker."""
        upload_round = msg.get(Message.ARG_ROUND)
        if upload_round is not None and upload_round != self.round_idx:
            log.warning("discarding round-%s upload from silo %d (current "
                        "round %d)", upload_round, msg.sender_id,
                        self.round_idx)
            return False
        if self.secagg is not None and self._secagg_stage != "upload":
            # a masked upload outside the upload stage (a straggler
            # landing mid-unmask) must not touch the fold: the unmask
            # request already fixed survivors and dead
            log.info("round %d: discarding masked upload from silo %d "
                     "outside the upload stage (stage=%s)", self.round_idx,
                     msg.sender_id, self._secagg_stage)
            return False
        if self._expected and msg.sender_id not in self._expected:
            log.info("discarding round-%d upload from unexpected silo %d",
                     self.round_idx, msg.sender_id)
            return False
        if msg.sender_id in self._received:
            log.info("ignoring duplicate round-%d upload from silo %d",
                     self.round_idx, msg.sender_id)
            return False
        if check_inflight and self.ingest is not None \
                and self.shard_wire is None \
                and msg.sender_id in self._ingest_inflight:
            log.info("ignoring duplicate round-%d upload from silo %d "
                     "(first copy still queued)", self.round_idx,
                     msg.sender_id)
            return False
        return True

    def _handshake_error(self, msg: Message, upload) -> Optional[str]:
        """The compression-scheme handshake: a payload with a ``scheme``
        tag is a compressed frame, and it must meet a decoding server."""
        is_compressed = isinstance(upload, dict) and "scheme" in upload
        if self.decode_upload is None and is_compressed:
            return (f"silo {msg.sender_id} sent a compressed upload "
                    f"(scheme={upload['scheme']!r}) but the server has no "
                    f"--wire_compression configured")
        if self.decode_upload is not None and not is_compressed:
            return (f"server expects compressed uploads but silo "
                    f"{msg.sender_id} sent plain parameters; launch silos "
                    f"with the same --wire_compression")
        return None

    def _on_plain_upload(self, msg: Message, pre=None) -> None:
        upload = msg.get(Message.ARG_MODEL_PARAMS)
        handshake_err = self._handshake_error(msg, upload)
        if handshake_err is not None:
            # without admission a misconfigured fleet fails loudly; with
            # it, the mismatch is attacker-reachable structural damage
            if self.admission is None:
                raise ValueError(handshake_err)
            log.warning("round %d: rejecting upload from silo %d "
                        "(handshake mismatch: %s)", self.round_idx,
                        msg.sender_id, handshake_err)
            self.admission.reject(msg.sender_id, self.round_idx,
                                  "fingerprint")
            if self.health is not None:
                with self._perf_phase("health"):
                    self.health.observe_rejected(msg.sender_id,
                                                 "fingerprint")
            self._note_upload(msg.sender_id, None)
            return
        if self.decode_upload is not None:
            try:
                # the codec decode is its own micro-span and perf phase
                with self._span("ingest:decode", deterministic=True), \
                        self._perf_phase("decode"):
                    upload = self.decode_upload(upload, self._host_params())
            except Exception:  # noqa: BLE001 — damaged compressed frame
                if self.admission is None:
                    raise
                # leave the raw payload: the fingerprint screen rejects it
                log.warning("round %d: undecodable upload from silo %d; "
                            "routing to admission as structural damage",
                            self.round_idx, msg.sender_id)
        if pre is not None and pre.structural_ok and pre.tree is not None:
            # the arena staged the payload on the device: the fold reads
            # the staged tree, so its copy is the arena's one copy
            upload = pre.tree
        entry = (upload, msg.get(Message.ARG_NUM_SAMPLES))
        upload_norm = None
        if self.admission is not None:
            with self._span("ingest:admission", deterministic=True), \
                    self._perf_phase("admission"):
                verdict = self.admission.admit(
                    msg.sender_id, upload, msg.get(Message.ARG_NUM_SAMPLES),
                    self._host_params(), self.round_idx, pre=pre)
            if verdict.ok:
                entry = (upload, verdict.num_samples)
                # the screen's one norm pass is shared with health
                upload_norm = verdict.norm
            else:
                log.warning("round %d: rejecting upload from silo %d "
                            "(reason=%s)", self.round_idx, msg.sender_id,
                            verdict.reason)
                entry = None
                if self.health is not None:
                    with self._perf_phase("health"):
                        self.health.observe_rejected(msg.sender_id,
                                                     verdict.reason)
        if entry is not None and self.health is not None:
            # the health stats fold at arrival, BEFORE the aggregation
            # fold consumes or stages the upload
            with self._perf_phase("health"):
                # an edge frame carries its block's rollup beside the
                # pre-reduced mean; the flat topology never sets it
                edge_summary = msg.get(Message.ARG_HEALTH)
                if edge_summary is not None:
                    self.health.note_edge(msg.sender_id, edge_summary)
                self.health.observe_admitted(msg.sender_id, entry[0],
                                             entry[1], norm=upload_norm)
        self._note_upload(msg.sender_id, entry)

    def _on_shard_upload(self, msg: Message, pre=None) -> None:
        """One shard slice of a silo's upload: screened per shard at
        arrival; the silo reaches the barrier when its LAST slice completes
        admission (or its first slice fails it).  A whole-model upload on
        the sharded wire is structural damage, rejected at weight 0.
        ``pre``: the shard arena's screen; the staged device slice is
        banked in place of the host one."""
        silo = msg.sender_id
        shard = msg.get(Message.ARG_SHARD)
        adm = self.shard_wire.admission
        payload = msg.get(Message.ARG_MODEL_PARAMS)
        if pre is not None and pre.structural_ok and pre.tree is not None:
            payload = pre.tree
        with self._span("ingest:admission", deterministic=True), \
                self._perf_phase("admission"):
            if shard is None:
                log.warning("round %d: silo %d sent a whole-model upload on "
                            "the sharded wire; rejecting as structural "
                            "damage", self.round_idx, silo)
                status, info = adm.reject(silo, self.round_idx,
                                          "fingerprint")
            else:
                status, info = adm.offer(
                    silo, shard, msg.get(Message.ARG_SHARD_COUNT), payload,
                    msg.get(Message.ARG_NUM_SAMPLES), self.round_idx,
                    pre=pre)
        if status == WAIT:
            return
        if status != ACCEPT:
            log.warning("round %d: rejecting sharded upload from silo %d "
                        "(reason=%s)", self.round_idx, silo,
                        info.get("reason"))
            if self.health is not None:
                with self._perf_phase("health"):
                    self.health.observe_rejected(silo, info.get("reason"))
            self._note_upload(silo, None)
            return
        if self.health is not None:
            # the observatory reads the ASSEMBLED update (cosine and norm
            # are whole-model quantities); the fold stays per shard
            with self._perf_phase("health"):
                self.health.observe_admitted(
                    silo, self.shard_wire.join(info["slices"]),
                    info["num_samples"], norm=info["norm"])
        self._note_upload(silo, (info["slices"], info["num_samples"]))

    # marker: the upload's bytes already live in the fold or the buffer
    _STAGED = object()

    def _note_upload(self, silo: int, entry: Optional[tuple]) -> None:
        """Record a silo's report (``None``: reported but inadmissible),
        fold or stage an admitted upload at arrival, and close the round
        when the barrier is met.  With a journal, each report is
        recorded (with its round-relative latency, ``lat_s``) and the
        fold state snapshotted on its cadence; with ``degrade`` the
        latency feeds the tracker."""
        payload_rejected = entry is None
        lat_s = (None if self._round_t0 is None
                 else round(time.monotonic() - self._round_t0, 6))
        lat_extra = {"lat_s": lat_s} if lat_s is not None else None
        if entry is not None and self.faultline is not None:
            # admitted, not yet folded
            self.faultline.maybe_crash("post_admission_pre_fold",
                                       round_idx=self.round_idx, silo=silo)
        if entry is not None and self.secagg is not None:
            # ring addition is the fold
            try:
                with self._span("ingest:fold", deterministic=True), \
                        self._perf_phase("fold"):
                    self.secagg.fold(silo, entry[0], entry[1])
            except SecAggError as e:
                # an upload from outside the fixed roster: its masks
                # cannot cancel
                log.warning("round %d: rejecting masked upload from silo "
                            "%d (%s)", self.round_idx, silo, e)
                entry = None
            else:
                if self.journal is not None:
                    # metadata only: a secure round never snapshots
                    with self._span("ingest:journal", deterministic=True), \
                            self._perf_phase("journal"):
                        self.journal.note_accept(self.round_idx, silo,
                                                 float(entry[1]),
                                                 extra=lat_extra)
                entry = (self._STAGED, entry[1])
        elif entry is not None:
            span = phase = trace.NULL_CONTEXT
            if self.stream_agg is not None or self.aggregate_fn is not None:
                # the plain mean stages its slot untraced: the JAX
                # package's plain mean keeps the upload to the close
                span = self._span("ingest:fold", deterministic=True)
                phase = self._perf_phase("fold" if self.stream_agg
                                         is not None else "staging")
            with span, phase:
                if self.shard_wire is not None:
                    self.stream_agg.fold_slices(entry[0], entry[1])
                elif self.stream_agg is not None:
                    self.stream_agg.fold(flatten_nested(entry[0]), entry[1])
                else:
                    self._stage(silo, flatten_nested(entry[0]))
            if self.journal is not None:
                state_fn = (self.stream_agg.state_dict
                            if self.stream_agg.method == "mean" else None)
                with self._span("ingest:journal", deterministic=True), \
                        self._perf_phase("journal"):
                    self.journal.note_accept(self.round_idx, silo,
                                             float(entry[1]),
                                             extra=lat_extra,
                                             state_fn=state_fn)
            entry = (self._STAGED, entry[1])
        if entry is None and self.journal is not None:
            # reported but inadmissible: recorded, never folded
            with self._perf_phase("journal"):
                self.journal.note_accept(self.round_idx, silo, 0.0,
                                         folded=False, reason="rejected")
        if self.faultline is not None:
            # folded (or recorded), the report not yet banked
            self.faultline.maybe_crash("post_fold_pre_ack",
                                       round_idx=self.round_idx, silo=silo)
        if self.degrade is not None:
            # admitted or rejected, the silo completed the round trip: its
            # latency is evidence either way
            if lat_s is not None:
                self.degrade.observe_completion(silo, lat_s)
            if entry is not None:
                self.degrade.note_accept(silo)
            elif payload_rejected:
                # the strike itself already landed at the admission site
                self.degrade.note_fault(FaultClass.PAYLOAD, silo=silo)
        self._received[silo] = entry
        if self._barrier_met():
            self._complete_round()

    def _stage(self, silo: int, upload) -> None:
        """Copy one admitted upload into slot ``silo - 1`` of the device
        buffer (allocated at the round's first admitted upload)."""
        if self._staging is None:
            self._staging = {
                k: torch.empty((self._num_silos,) + tuple(v.shape),
                               dtype=v.dtype, device=self.device)
                for k, v in self.params.items()}
        if sorted(upload) != sorted(self._staging):
            raise ValueError(f"silo {silo} upload does not match the global "
                             f"template (leaf set mismatch)")
        for k, buf in self._staging.items():
            leaf = as_tensor(upload[k], "cpu")
            if leaf.dtype != buf.dtype or leaf.shape != buf.shape[1:]:
                raise ValueError(
                    f"silo {silo} upload leaf {k} is {leaf.dtype} "
                    f"{tuple(leaf.shape)}; the global template is "
                    f"{buf.dtype} {tuple(buf.shape[1:])}")
            buf[silo - 1].copy_(leaf)
        self._staged_silos.add(silo)
        self._staged_seen += 1
        self._g_staged.set(len(self._staged_silos))

    def _staged_cohort(self) -> Dict[str, torch.Tensor]:
        """The static ``[cohort, ...]`` stack: slots of silos that did not
        stage an upload get the current global (weight 0, the zero update
        every defense masks out)."""
        staged = self._staged_silos
        for silo in range(1, self._num_silos + 1):
            if silo not in staged:
                for k, buf in self._staging.items():
                    buf[silo - 1].copy_(self.params[k])
        return self._staging

    def _cohort_weights(self, admitted) -> np.ndarray:
        w = np.zeros(self._num_silos, np.float32)
        for silo, (_, num_samples) in admitted.items():
            w[silo - 1] = num_samples
        return w

    def _complete_round(self) -> None:
        if self.faultline is not None:
            self.faultline.maybe_crash("barrier_close",
                                       round_idx=self.round_idx)
        self._timer.cancel()
        now = time.monotonic()
        self._h_quorum.observe(len(self._received))
        if self._round_t0 is not None:
            self._h_round.observe(now - self._round_t0)
        if self._first_upload_t is not None:
            self._h_straggler.observe(now - self._first_upload_t)
            if self.perf is not None:
                self.perf.add_phase("straggler_wait",
                                    now - self._first_upload_t)
        if self.round_idx in self.dropped_silos:
            self.dropped_silos[self.round_idx] = sorted(
                set(self.dropped_silos[self.round_idx]))
        admitted = {s: v for s, v in self._received.items() if v is not None}
        # possibly EMPTY (all rejected), never None: "no ack info" differs
        # from "nothing was aggregated"
        self._last_accepted = np.asarray(sorted(admitted), np.int32)
        self._received.clear()
        if self.secagg is not None:
            if admitted:
                # the barrier is met but the sum is still masked: the round
                # closes once the unmask shares arrive
                self._begin_unmask(len(admitted))
                return
            self._secagg_stage = None
            log.warning("round %d: no admissible masked uploads; the "
                        "global model is unchanged this round",
                        self.round_idx)
            self._finish_round(0)
            return
        defended = (self.aggregate_fn is not None
                    or (self.stream_agg is not None
                        and self.stream_agg.defended))
        # the sharded spine's finalize has its own phase label, so a
        # sharded round never compares against a replicated one
        agg_phase = ("shard_finalize" if self.shard_wire is not None
                     else "defended_aggregate" if defended
                     else "aggregate")
        with self._span("aggregate", parent=self._round_span,
                        round=self.round_idx, quorum=len(admitted)), \
                self._perf_phase(agg_phase):
            finalized = None
            if not admitted:
                log.warning("round %d: no admissible uploads; the global "
                            "model is unchanged this round", self.round_idx)
            elif self.stream_agg is not None:
                finalized = self.stream_agg.finalize(self.round_idx)
            elif self.aggregate_fn is not None:
                finalized = self.aggregate_fn(
                    self.params, self._staged_cohort(),
                    self._cohort_weights(admitted), self.round_idx)
            else:
                order = sorted(admitted)
                idx = torch.as_tensor([s - 1 for s in order],
                                      device=self.device)
                weights = np.array([admitted[s][1] for s in order],
                                   dtype=np.float32)
                finalized = tree_weighted_mean(
                    {k: v.index_select(0, idx)
                     for k, v in self._staging.items()},
                    torch.as_tensor(weights, device=self.device))
            if finalized is not None:
                # the server-optimizer seam: without one (or with plain)
                # the finalized tree is the new global verbatim
                self.params = (finalized if self.server_opt is None
                               else self.server_opt.apply(
                                   self.params, finalized, self.round_idx))
        self._finish_round(len(admitted))

    # -- secure aggregation (secure/protocol.py) -----------------------------
    # a lost UNMASK/SHARES frame must not wedge the round: the request is
    # re-sent on each timer lap, and after this many laps below the share
    # threshold the round is abandoned loudly with the global unchanged
    _SECAGG_UNMASK_RETRIES = 3

    def _on_secagg_advert(self, msg: Message) -> None:
        """Agreement stage: bank a silo's advert; when the whole expected
        group advertised, relay the rosters."""
        self._beat(msg.sender_id)
        if msg.get(Message.ARG_ROUND) != self.round_idx \
                or self._secagg_stage != "agreement":
            log.info("discarding stale/late secagg advert from silo %d",
                     msg.sender_id)
            return
        with self._perf_phase("mask_agreement"):
            complete = self.secagg.note_advert(msg.sender_id,
                                               msg.get(Message.ARG_SECAGG))
        if complete:
            self._send_rosters()

    def _send_rosters(self, subset=None) -> None:
        """Fix the roster and fan the roster frames out; silos that never
        advertised leave the roster and the barrier."""
        try:
            with self._perf_phase("mask_agreement"):
                rosters = self.secagg.flush_roster(subset)
        except SecAggError as e:
            # below the share threshold: keep waiting for adverts
            log.warning("round %d: cannot fix secagg roster yet (%s)",
                        self.round_idx, e)
            self._arm_timer()
            return
        self._secagg_stage = "upload"
        lost = self._expected - set(rosters)
        if lost:
            log.warning("round %d: silos %s never advertised; dropped from "
                        "the masking roster and the barrier",
                        self.round_idx, sorted(lost))
            self.dropped_silos.setdefault(self.round_idx, []).extend(
                sorted(lost))
            self._expected = self._expected - lost
        per = {silo: {Message.ARG_SECAGG: payload}
               for silo, payload in rosters.items()}
        self.send_many(MSG_SECAGG_ROSTER, sorted(per),
                       shared_params={Message.ARG_ROUND: self.round_idx},
                       per_receiver_params=per)
        self._arm_timer()

    def _secagg_agreement_timeout(self) -> None:
        advertised = self.secagg.advertised()
        missing = sorted(self._expected - advertised)
        if not missing:
            return  # the roster flush is already under way
        log.warning("round %d: silos %s have not advertised after %.1fs "
                    "(policy=%s)", self.round_idx, missing,
                    self.round_timeout_s, self.straggler_policy)
        if self.straggler_policy == "abort":
            self.aborted = True
            for silo in range(1, self._num_silos + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
            return
        quorum = max(1, math.ceil(self.min_silo_frac * len(self._expected)))
        if self.straggler_policy == "drop" and len(advertised) >= quorum:
            self._send_rosters(subset=sorted(advertised))
            # a roster refused below the share threshold counts a lap, so
            # a cohort that can never reach t abandons the round
            if self._secagg_stage == "agreement":
                self._secagg_agreement_laps += 1
                if self._secagg_agreement_laps > self._SECAGG_UNMASK_RETRIES:
                    log.error("round %d: mask agreement cannot reach the "
                              "share threshold after %d laps; abandoning "
                              "the round", self.round_idx,
                              self._secagg_agreement_laps - 1)
                    self._secagg_stage = None
                    self._timer.cancel()
                    self._finish_round(0)
            return
        self._arm_timer()  # wait policy (or below quorum): keep waiting

    def _begin_unmask(self, admitted_count: int) -> None:
        """The barrier closed over masked uploads: ask the survivors for
        the shares that unmask the sum."""
        self._secagg_stage = "unmask"
        self._secagg_quorum = admitted_count
        self._secagg_unmask_laps = 0
        self._send_unmask_request()
        self._arm_timer()

    def _send_unmask_request(self) -> None:
        with self._span("ingest:unmask", deterministic=True), \
                self._perf_phase("unmask"):
            survivors, dead = self.secagg.unmask_request()
            if dead:
                log.warning("round %d: reconstructing %d dead silo(s) %s "
                            "from surviving shares", self.round_idx,
                            len(dead), dead)
            self.send_many(
                MSG_SECAGG_UNMASK, survivors,
                shared_params={Message.ARG_ROUND: self.round_idx,
                               Message.ARG_SECAGG: {"survivors": survivors,
                                                    "dead": dead}})

    def _on_secagg_shares(self, msg: Message) -> None:
        self._beat(msg.sender_id)
        if msg.get(Message.ARG_ROUND) != self.round_idx \
                or self._secagg_stage != "unmask":
            return
        with self._span("ingest:unmask", deterministic=True), \
                self._perf_phase("unmask"):
            complete = self.secagg.note_reveal(msg.sender_id,
                                               msg.get(Message.ARG_SECAGG))
        if complete:
            self._finalize_secagg()

    def _secagg_unmask_timeout(self) -> None:
        if self.secagg.can_finalize():
            log.warning("round %d: unmask quorum reached but not every "
                        "survivor revealed; finalizing from the available "
                        "shares", self.round_idx)
            self._finalize_secagg()
            return
        self._secagg_unmask_laps += 1
        if self._secagg_unmask_laps > self._SECAGG_UNMASK_RETRIES:
            log.error("round %d: unmask share threshold unreachable after "
                      "%d request retries; abandoning the round",
                      self.round_idx, self._SECAGG_UNMASK_RETRIES)
            self._secagg_stage = None
            self._finish_round(0)
            return
        log.warning("round %d: below the unmask share threshold; "
                    "re-requesting reveals (lap %d/%d)", self.round_idx,
                    self._secagg_unmask_laps, self._SECAGG_UNMASK_RETRIES)
        self._send_unmask_request()
        self._arm_timer()

    def _finalize_secagg(self) -> None:
        """Unmask the ring sum, run the sum-level defenses and publish, or
        on an unrecoverable round keep the global and say so."""
        if self.faultline is not None:
            # shares collected, the sum not yet recovered: recovery
            # restarts the round from the boundary, global unchanged
            self.faultline.maybe_crash("mid_unmask",
                                       round_idx=self.round_idx)
        self._secagg_stage = None
        self._timer.cancel()
        with self._span("aggregate", parent=self._round_span,
                        round=self.round_idx, quorum=self._secagg_quorum), \
                self._perf_phase("unmask"):
            try:
                mean, _ = self.secagg.finalize(
                    reference=self._host_params())
            except SecAggError:
                log.exception("round %d: secure unmask FAILED; the global "
                              "model is unchanged this round",
                              self.round_idx)
                mean = None
            if mean is not None:
                self.params = {
                    k: as_tensor(v, self.device).to(self.params[k].dtype)
                    for k, v in flatten_nested(mean).items()}
        self._finish_round(self._secagg_quorum if mean is not None else 0)

    def _finish_round(self, quorum: int) -> None:
        """The round-close tail shared by the plaintext barrier close and
        the secure unmask completion: staging release, the health,
        controller, checkpoint, journal and perf hooks, then the next
        broadcast (or FINISH)."""
        # release the stack buffer; drop half-assembled straggler slices
        # so a late slice never splices into the next round
        self._staging = None
        self._staged_silos.clear()
        self._g_staged.set(0)
        if self.shard_wire is not None:
            self.shard_wire.round_end()
        if self._round_span is not None:
            self._round_span.end()
            self._round_span = None
        if self.health is not None:
            # the health round closes on the post-aggregate host mirror
            # (shared with the checkpoint), BEFORE perf.round_end so the
            # health phase lands in this round's ledger line
            with self._perf_phase("health"):
                self.health.round_end(self.round_idx,
                                      new_global=self._host_params(),
                                      quorum=quorum)
        decision = None
        if self.controller is not None:
            # the verdict for the NEXT round, decided before the checkpoint
            # so the controller's levers land in this round's boundary
            kw = {}
            if self.degrade is not None:
                # the controller may widen on participation debt, but a
                # shrink never fights the quorum floor
                kw["debt"] = self.degrade.max_debt()
                qf = self.degrade.quorum_for(self._num_silos)
                if qf is not None:
                    kw["quorum_floor"] = qf
            decision = self.controller.decide(
                self.round_idx,
                self.health.last_line if self.health is not None else None,
                **kw)
        if self.faultline is not None:
            # the aggregate is applied in memory, not yet durable
            self.faultline.maybe_crash("mid_checkpoint_write",
                                       round_idx=self.round_idx)
        if self.checkpointer is not None:
            with self._perf_phase("checkpoint"):
                self.checkpointer.maybe_save(
                    self.round_idx,
                    lambda: self._checkpoint_state(self.round_idx),
                    last_round=self.round_idx + 1 >= self.num_rounds)
        if self.journal is not None:
            # after the checkpoint: a crash between the two leaves an open
            # round whose snapshot re-finalizes to the same global
            with self._perf_phase("journal"):
                self.journal.round_end(self.round_idx)
        if self.faultline is not None:
            self.faultline.maybe_crash("publish", round_idx=self.round_idx)
        if self.publish is not None:
            # serve-while-train: a HOST copy, so serving never holds a
            # buffer the next round's aggregation overwrites
            with self._perf_phase("publish"):
                self.publish(self._host_params(), self.round_idx)
        if self.perf is not None:
            # the ledger line closes BEFORE the eval hook: round_s is the
            # server's own round cost.  A strict-mode RecompileError
            # raises here, on the event loop, and fails the run loudly
            extra = ({"shards": self.shard_wire.num_shards}
                     if self.shard_wire is not None else {})
            # the round's post-aggregate global CRC (the checksum the
            # journal trusts): pipelined and inline twins compare it
            extra["global_crc"] = tree_crc(self._host_params())
            if self.server_opt is not None:
                extra["server_opt"] = self.server_opt.name
            if decision is not None:
                extra["adapt"] = decision.as_ledger()
            if self.degrade is not None:
                extra["degrade"] = self.degrade.as_ledger()
            self.perf.round_end(self.round_idx, quorum=quorum,
                                dropped=len(self.dropped_silos.get(
                                    self.round_idx, [])), **extra)
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, self.params)
        self.round_idx += 1
        if self.round_idx >= self.num_rounds:
            for silo in range(1, self._num_silos + 1):
                self.send(MsgType.S2C_FINISH, silo)
            self.finish()
        else:
            self._broadcast(MsgType.S2C_SYNC)

    def finish(self) -> None:
        """Stop the federation: cancel and join the straggler timer, stop
        the ingest workers (no drain: finish may run on a fold worker),
        then stop the transport."""
        self._finished = True
        self._timer.cancel(join=True)
        if self.ingest is not None:
            self.ingest.stop()
        super().finish()


class FedAvgClientActor(ClientManager):
    """Silo-side trainer actor.  ``train_fn(params, client_idx, round_idx)
    -> (new_params, num_samples)`` takes the global as a flat dict of host
    arrays (read-only views into the frame) and returns a flat dict of
    tensors or arrays; the upload leaves as numpy in the wire layout.

    ``heartbeat_interval_s``: when set, ``run()`` starts a daemon thread
    that sends C2S_HEARTBEAT (tagged with the last synced round) every
    interval; ``finish()`` stops and joins it.  The thread only sends.

    ``secagg``: a `secure.protocol.SecAggClient`; the silo advertises its
    round keys on sync (then trains while the agreement completes),
    uploads only once the ROSTER has fixed the masking cohort —
    quantized and masked on the client's device — and answers the
    server's UNMASK request with exactly the share kinds asked for.

    ``encode_upload(upload, global) -> payload``: the wire-compression
    (or async delta) transform of the host upload against the synced
    global, both in the wire layout.  ``on_accepted(accepted_ids)`` fires
    on every sync before training, so deferred error-feedback residuals
    settle before the next encode reads them.  ``server_id``: the root,
    or the silo's edge aggregator.
    """

    def __init__(self, node_id: int, transport: Transport,
                 train_fn: SiloTrainFn, server_id: int = 0,
                 heartbeat_interval_s: Optional[float] = None,
                 secagg=None, encode_upload: Optional[Callable] = None,
                 on_accepted: Optional[Callable] = None):
        super().__init__(node_id, transport)
        if secagg is not None and encode_upload is not None:
            raise ValueError("secagg and encode_upload (wire compression) "
                             "are mutually exclusive: a compressed payload "
                             "cannot ride the masking ring")
        self.server_id = server_id
        self.train_fn = train_fn
        self.heartbeat_interval_s = heartbeat_interval_s
        self.secagg = secagg
        self.encode_upload = encode_upload
        self.on_accepted = on_accepted
        # (round, trained update, num_samples) waiting for its roster
        self._pending_upload: Optional[tuple] = None
        self._round: Optional[int] = None  # last round synced
        self._shard_rx: Optional[SiloShardAssembler] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def register_handlers(self) -> None:
        self.register_handler(MsgType.S2C_INIT, self._on_sync)
        self.register_handler(MsgType.S2C_SYNC, self._on_sync)
        self.register_handler(MsgType.S2C_FINISH, lambda m: self.finish())
        if self.secagg is not None:
            self.register_handler(MSG_SECAGG_ROSTER, self._on_secagg_roster)
            self.register_handler(MSG_SECAGG_UNMASK, self._on_secagg_unmask)

    def run(self) -> None:
        if self.heartbeat_interval_s is not None and self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"heartbeat-silo-{self.node_id}")
            self._hb_thread.start()
        super().run()

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            try:
                self.send(MsgType.C2S_HEARTBEAT, self.server_id,
                          **({} if self._round is None
                             else {Message.ARG_ROUND: self._round}))
            except Exception:  # noqa: BLE001 — transport mid-shutdown
                return

    def finish(self) -> None:
        self._hb_stop.set()
        hb, self._hb_thread = self._hb_thread, None
        if hb is not None and hb is not threading.current_thread():
            hb.join(timeout=5)
        super().finish()

    def _train(self, params, client_idx, round_idx, host: bool = True):
        """Train on the nested wire tree; the result in the wire layout
        (``host=False``: leaves left where the trainer put them)."""
        # deterministic span ids: a chaos-duplicated sync re-trains, but
        # its train/upload spans collapse onto the first delivery's
        with self._span("train", deterministic=True, round=round_idx,
                        client=client_idx):
            new_params, num_samples = self.train_fn(
                flatten_nested(params), client_idx, round_idx)
        tree = nest({k: new_params[k] for k in tree_keys(new_params)})
        return (to_host(tree) if host else tree), num_samples

    def _on_sync(self, msg: Message) -> None:
        if msg.get(Message.ARG_SHARD) is not None:
            self._on_shard_sync(msg)
            return
        round_idx = msg.get(Message.ARG_ROUND)
        self._round = round_idx
        if self.on_accepted is not None:
            self.on_accepted(msg.get(Message.ARG_ACCEPTED))
        secagg_info = (msg.get(Message.ARG_SECAGG)
                       if self.secagg is not None else None)
        if self.secagg is not None and secagg_info is None:
            # a sync without masking parameters (the rejoin warm-up) must
            # never fall through to a plaintext upload
            log.info("silo %d: sync without secagg parameters (rejoin "
                     "warm-up?); not uploading this round", self.node_id)
            return
        if secagg_info is not None:
            # advertise before training, so the agreement overlaps it
            advert = self.secagg.begin_round(round_idx, secagg_info)
            self.send(MSG_SECAGG_ADVERT, self.server_id,
                      **{Message.ARG_SECAGG: advert,
                         Message.ARG_ROUND: round_idx})
            update, num_samples = self._train(
                msg.get(Message.ARG_MODEL_PARAMS),
                msg.get(Message.ARG_CLIENT_INDEX), round_idx, host=False)
            # the masks derive from the fixed roster: wait for it
            self._pending_upload = (round_idx, update, float(num_samples))
            self._maybe_masked_upload()
            return
        params = msg.get(Message.ARG_MODEL_PARAMS)
        upload, num_samples = self._train(
            params, msg.get(Message.ARG_CLIENT_INDEX), round_idx)
        if self.encode_upload is not None:
            upload = self.encode_upload(upload, params)
        with self._span("upload", deterministic=True, round=round_idx):
            self.send(MsgType.C2S_MODEL, self.server_id,
                      **{Message.ARG_MODEL_PARAMS: upload,
                         Message.ARG_NUM_SAMPLES: int(num_samples),
                         Message.ARG_ROUND: round_idx})

    def _on_shard_sync(self, msg: Message) -> None:
        """Bank one broadcast shard slice; when the round's model is
        complete, train on the joined tree and upload it as S slice
        frames (split by the plan spec shard 0's frame carried)."""
        if self.secagg is not None:
            raise ValueError(
                "sharded sync frames cannot compose with secagg on the "
                "silo (masked payloads are whole-model by construction); "
                "this combination should have failed at config time")
        if self._shard_rx is None:
            self._shard_rx = SiloShardAssembler()
        round_idx = msg.get(Message.ARG_ROUND)
        meta = {}
        if msg.get(Message.ARG_CLIENT_INDEX) is not None:
            meta["client_idx"] = msg.get(Message.ARG_CLIENT_INDEX)
        done = self._shard_rx.offer(
            round_idx, msg.get(Message.ARG_SHARD),
            msg.get(Message.ARG_SHARD_COUNT),
            msg.get(Message.ARG_MODEL_PARAMS),
            msg.get(Message.ARG_SHARD_SPEC), meta=meta)
        if not done:
            return
        params, meta = self._shard_rx.take()
        self._round = round_idx
        upload, num_samples = self._train(params, meta.get("client_idx"),
                                          round_idx)
        slices = self._shard_rx.split_upload(upload)
        with self._span("upload", deterministic=True, round=round_idx):
            for s, sl in enumerate(slices):
                self.send(MsgType.C2S_MODEL, self.server_id,
                          **{Message.ARG_MODEL_PARAMS: sl,
                             Message.ARG_NUM_SAMPLES: int(num_samples),
                             Message.ARG_ROUND: round_idx,
                             Message.ARG_SHARD: s,
                             Message.ARG_SHARD_COUNT: len(slices)})

    # -- secure aggregation --------------------------------------------------
    def _on_secagg_roster(self, msg: Message) -> None:
        if self.secagg.on_roster(msg.get(Message.ARG_ROUND),
                                 msg.get(Message.ARG_SECAGG)):
            self._maybe_masked_upload()

    def _maybe_masked_upload(self) -> None:
        """Ship the trained update once both the training and the roster
        have landed (in either order)."""
        if self._pending_upload is None:
            return
        round_idx, update, num_samples = self._pending_upload
        if not self.secagg.has_roster(round_idx):
            return
        masked = self.secagg.mask(round_idx, update, num_samples)
        self._pending_upload = None
        with self._span("upload", deterministic=True, round=round_idx):
            self.send(MsgType.C2S_MODEL, self.server_id,
                      **{Message.ARG_MODEL_PARAMS: masked,
                         Message.ARG_NUM_SAMPLES: int(num_samples),
                         Message.ARG_ROUND: round_idx})

    def _on_secagg_unmask(self, msg: Message) -> None:
        round_idx = msg.get(Message.ARG_ROUND)
        info = msg.get(Message.ARG_SECAGG) or {}
        try:
            reveal = self.secagg.reveal(round_idx, info.get("survivors", []),
                                        info.get("dead", []))
        except SecAggError as e:
            # a malformed or adversarial request: reveal nothing
            log.error("silo %d: refusing unmask request for round %s: %s",
                      self.node_id, round_idx, e)
            return
        self.send(MSG_SECAGG_SHARES, self.server_id,
                  **{Message.ARG_SECAGG: reveal,
                     Message.ARG_ROUND: round_idx})
