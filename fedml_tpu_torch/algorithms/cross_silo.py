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
  only the silos not durably folded) and the `Faultline` crash points.

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
from fedml_tpu_torch.obs import telemetry
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

# JAX actor options this port does not run yet, with where they arrive
_REFUSED = {
    "secagg": "live SecAgg over the wire (secure/protocol.py)",
    "ingest": "the pipelined receive path (comm/ingest.py)",
    "health": "the health observatory (obs/health.py)",
    "perf": "the perf ledger (obs/perf.py)",
    "server_opt": "server optimizers (server_opt/)",
    "controller": "the adaptive controller (server_opt/)",
    "degrade": "the reliability tracker (robust/degrade.py)",
    "decode_upload": "wire compression (comm/compress.py)",
    "publish": "serve-while-train (serve/)",
}


def refuse_unported(**options) -> None:
    """Raise, naming the option and its ROADMAP item, for any JAX actor
    option that is set."""
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"FedAvgServerActor({name}=...) is not ported yet: it needs "
                f"{_REFUSED[name]} (ROADMAP Queue 1)")


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
        refuse_unported(
            secagg=secagg, ingest=ingest, health=health, perf=perf,
            server_opt=server_opt, controller=controller, degrade=degrade,
            decode_upload=decode_upload, publish=publish)
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
        if journal is not None and stream_agg is None:
            raise ValueError(
                "journal (crash consistency) rides the streaming-fold "
                "receive path: pass --agg_mode stream (or --secagg); the "
                "stack path has no incremental fold state to snapshot")
        self.params = init_params
        self.device = next(iter(init_params.values())).device
        self.client_num_in_total = client_num_in_total
        self.client_num_per_round = client_num_per_round
        self.num_rounds = num_rounds
        self.round_idx = 0
        self.on_round_done = on_round_done
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
        self._round_t0: Optional[float] = None
        self._first_upload_t: Optional[float] = None

    def register_handlers(self) -> None:
        self.register_handler(MsgType.C2S_MODEL, self._on_model)
        self.register_handler(MsgType.ROUND_TIMEOUT, self._on_timeout)
        self.register_handler(MsgType.C2S_HEARTBEAT,
                              lambda m: self._beat(m.sender_id))

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
        refuses a journal written under another one."""
        if self.shard_wire is not None:
            return self.shard_wire.journal_mode()
        return f"stream_{self.stream_agg.method}"

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
                      "(reservoir rules have no durable draw stream); "
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
        return sample_clients(self.round_idx, self.client_num_in_total,
                              self.client_num_per_round)

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
        self._expected = cohort - dead
        if dead:
            log.info("round %d: excluding dead/quarantined silos %s from "
                     "the quorum", self.round_idx, sorted(dead))
            self.dropped_silos.setdefault(self.round_idx, []).extend(
                sorted(dead))
        self._round_t0 = time.monotonic()
        self._first_upload_t = None
        if self.stream_agg is not None:
            self.stream_agg.reset(self.params)
            if resume is not None:
                # continue the crashed round's fold where its last durable
                # snapshot left it (device <- host), and re-arm the fresh
                # journal's round state so it keeps snapshotting
                self.stream_agg.load_state_dict(resume.state)
                self.journal.note_resume(self.round_idx, resume.folded,
                                         global_crc=resume.global_crc)
        host_params = self._host_params()
        if self.shard_wire is not None:
            self.shard_wire.round_start(host_params)
        if self.journal is not None and resume is None:
            self.journal.round_start(
                self.round_idx, mode=self._journal_mode(),
                resumable=self.stream_agg.method == "mean",
                global_crc=tree_crc(host_params),
                expected=sorted(self._expected))
        extra = ({} if self._last_accepted is None
                 else {Message.ARG_ACCEPTED: self._last_accepted})
        receivers = sorted(cohort - dead - set(folded))
        per_silo = {silo: {Message.ARG_CLIENT_INDEX: int(ids[silo - 1])}
                    for silo in receivers}
        with self._span("broadcast", round=self.round_idx):
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
    def _arm_timer(self) -> None:
        if self.round_timeout_s is None:
            return
        round_at_arm = self.round_idx
        # the fire only ENQUEUES a self-message: all policy logic runs on
        # the transport's event loop
        self._timer.arm(
            self.round_timeout_s,
            lambda: self.send(MsgType.ROUND_TIMEOUT, 0,
                              **{Message.ARG_ROUND: round_at_arm}))

    def _on_timeout(self, msg: Message) -> None:
        if msg.get(Message.ARG_ROUND) != self.round_idx or self._finished:
            return  # stale timer from an already-completed round
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
        if self.straggler_policy == "drop" and len(self._received) >= quorum:
            self.dropped_silos.setdefault(self.round_idx, []).extend(missing)
            self._complete_round()
            return
        self._arm_timer()  # wait (or drop below quorum): keep waiting

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
        if not self._upload_guards(msg):
            return
        if self._first_upload_t is None:
            self._first_upload_t = time.monotonic()
        if self.shard_wire is not None:
            self._on_shard_upload(msg)
        else:
            self._on_plain_upload(msg)

    def _upload_guards(self, msg: Message) -> bool:
        """The envelope guards: round tag, quorum membership, duplicates."""
        upload_round = msg.get(Message.ARG_ROUND)
        if upload_round is not None and upload_round != self.round_idx:
            log.warning("discarding round-%s upload from silo %d (current "
                        "round %d)", upload_round, msg.sender_id,
                        self.round_idx)
            return False
        if self._expected and msg.sender_id not in self._expected:
            log.info("discarding round-%d upload from unexpected silo %d",
                     self.round_idx, msg.sender_id)
            return False
        if msg.sender_id in self._received:
            log.info("ignoring duplicate round-%d upload from silo %d",
                     self.round_idx, msg.sender_id)
            return False
        return True

    def _on_plain_upload(self, msg: Message) -> None:
        upload = msg.get(Message.ARG_MODEL_PARAMS)
        entry = (upload, msg.get(Message.ARG_NUM_SAMPLES))
        if self.admission is not None:
            with self._span("ingest:admission"):
                verdict = self.admission.admit(
                    msg.sender_id, upload, msg.get(Message.ARG_NUM_SAMPLES),
                    self._host_params(), self.round_idx)
            if verdict.ok:
                entry = (upload, verdict.num_samples)
            else:
                log.warning("round %d: rejecting upload from silo %d "
                            "(reason=%s)", self.round_idx, msg.sender_id,
                            verdict.reason)
                entry = None
        self._note_upload(msg.sender_id, entry)

    def _on_shard_upload(self, msg: Message) -> None:
        """One shard slice of a silo's upload: screened per shard at
        arrival; the silo reaches the barrier when its LAST slice completes
        admission (or its first slice fails it).  A whole-model upload on
        the sharded wire is structural damage, rejected at weight 0."""
        silo = msg.sender_id
        shard = msg.get(Message.ARG_SHARD)
        adm = self.shard_wire.admission
        with self._span("ingest:admission"):
            if shard is None:
                log.warning("round %d: silo %d sent a whole-model upload on "
                            "the sharded wire; rejecting as structural "
                            "damage", self.round_idx, silo)
                status, info = adm.reject(silo, self.round_idx,
                                          "fingerprint")
            else:
                status, info = adm.offer(
                    silo, shard, msg.get(Message.ARG_SHARD_COUNT),
                    msg.get(Message.ARG_MODEL_PARAMS),
                    msg.get(Message.ARG_NUM_SAMPLES), self.round_idx)
        if status == WAIT:
            return
        if status != ACCEPT:
            log.warning("round %d: rejecting sharded upload from silo %d "
                        "(reason=%s)", self.round_idx, silo,
                        info.get("reason"))
            self._note_upload(silo, None)
            return
        self._note_upload(silo, (info["slices"], info["num_samples"]))

    # marker: the upload's bytes already live in the fold or the buffer
    _STAGED = object()

    def _note_upload(self, silo: int, entry: Optional[tuple]) -> None:
        """Record a silo's report (``None``: reported but inadmissible),
        fold or stage an admitted upload at arrival, and close the round
        when the barrier is met.  With a journal, each report is
        recorded and the fold state snapshotted on its cadence."""
        if entry is not None and self.faultline is not None:
            # admitted, not yet folded
            self.faultline.maybe_crash("post_admission_pre_fold",
                                       round_idx=self.round_idx, silo=silo)
        if entry is not None:
            with self._span("ingest:fold"):
                if self.shard_wire is not None:
                    self.stream_agg.fold_slices(entry[0], entry[1])
                elif self.stream_agg is not None:
                    self.stream_agg.fold(flatten_nested(entry[0]), entry[1])
                else:
                    self._stage(silo, flatten_nested(entry[0]))
            if self.journal is not None:
                state_fn = (self.stream_agg.state_dict
                            if self.stream_agg.method == "mean" else None)
                with self._span("ingest:journal"):
                    self.journal.note_accept(self.round_idx, silo,
                                             float(entry[1]),
                                             state_fn=state_fn)
            entry = (self._STAGED, entry[1])
        elif self.journal is not None:
            # reported but inadmissible: recorded, never folded
            self.journal.note_accept(self.round_idx, silo, 0.0,
                                     folded=False, reason="rejected")
        if self.faultline is not None:
            # folded (or recorded), the report not yet banked
            self.faultline.maybe_crash("post_fold_pre_ack",
                                       round_idx=self.round_idx, silo=silo)
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
        if self.round_idx in self.dropped_silos:
            self.dropped_silos[self.round_idx] = sorted(
                set(self.dropped_silos[self.round_idx]))
        admitted = {s: v for s, v in self._received.items() if v is not None}
        # possibly EMPTY (all rejected), never None: "no ack info" differs
        # from "nothing was aggregated"
        self._last_accepted = np.asarray(sorted(admitted), np.int32)
        self._received.clear()
        with self._span("aggregate", round=self.round_idx):
            if not admitted:
                log.warning("round %d: no admissible uploads; the global "
                            "model is unchanged this round", self.round_idx)
            elif self.stream_agg is not None:
                self.params = self.stream_agg.finalize(self.round_idx)
            elif self.aggregate_fn is not None:
                self.params = self.aggregate_fn(
                    self.params, self._staged_cohort(),
                    self._cohort_weights(admitted), self.round_idx)
            else:
                order = sorted(admitted)
                idx = torch.as_tensor([s - 1 for s in order],
                                      device=self.device)
                weights = np.array([admitted[s][1] for s in order],
                                   dtype=np.float32)
                self.params = tree_weighted_mean(
                    {k: v.index_select(0, idx)
                     for k, v in self._staging.items()},
                    torch.as_tensor(weights, device=self.device))
        self._finish_round()

    def _finish_round(self) -> None:
        # release the stack buffer; drop half-assembled straggler slices
        # so a late slice never splices into the next round
        self._staging = None
        self._staged_silos.clear()
        if self.shard_wire is not None:
            self.shard_wire.round_end()
        if self.faultline is not None:
            # the aggregate is applied in memory, not yet durable
            self.faultline.maybe_crash("mid_checkpoint_write",
                                       round_idx=self.round_idx)
        if self.checkpointer is not None:
            self.checkpointer.maybe_save(
                self.round_idx,
                lambda: self._checkpoint_state(self.round_idx),
                last_round=self.round_idx + 1 >= self.num_rounds)
        if self.journal is not None:
            # after the checkpoint: a crash between the two leaves an open
            # round whose snapshot re-finalizes to the same global
            self.journal.round_end(self.round_idx)
        if self.faultline is not None:
            self.faultline.maybe_crash("publish", round_idx=self.round_idx)
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
        """Stop the federation: cancel and join the straggler timer, then
        stop the transport."""
        self._finished = True
        self._timer.cancel(join=True)
        super().finish()


class FedAvgClientActor(ClientManager):
    """Silo-side trainer actor.  ``train_fn(params, client_idx, round_idx)
    -> (new_params, num_samples)`` takes the global as a flat dict of host
    arrays (read-only views into the frame) and returns a flat dict of
    tensors or arrays; the upload leaves as numpy in the wire layout.

    ``heartbeat_interval_s``: when set, ``run()`` starts a daemon thread
    that sends C2S_HEARTBEAT (tagged with the last synced round) every
    interval; ``finish()`` stops and joins it.  The thread only sends.
    """

    def __init__(self, node_id: int, transport: Transport,
                 train_fn: SiloTrainFn, server_id: int = 0,
                 heartbeat_interval_s: Optional[float] = None):
        super().__init__(node_id, transport)
        self.server_id = server_id
        self.train_fn = train_fn
        self.heartbeat_interval_s = heartbeat_interval_s
        self._round: Optional[int] = None  # last round synced
        self._shard_rx: Optional[SiloShardAssembler] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def register_handlers(self) -> None:
        self.register_handler(MsgType.S2C_INIT, self._on_sync)
        self.register_handler(MsgType.S2C_SYNC, self._on_sync)
        self.register_handler(MsgType.S2C_FINISH, lambda m: self.finish())

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

    def _train(self, params, client_idx, round_idx):
        """Train on the nested wire tree; the result in the wire layout."""
        with self._span("train", round=round_idx, client=client_idx):
            new_params, num_samples = self.train_fn(
                flatten_nested(params), client_idx, round_idx)
        flat = {k: new_params[k] for k in tree_keys(new_params)}
        return to_host(nest(flat)), num_samples

    def _on_sync(self, msg: Message) -> None:
        if msg.get(Message.ARG_SHARD) is not None:
            self._on_shard_sync(msg)
            return
        round_idx = msg.get(Message.ARG_ROUND)
        self._round = round_idx
        upload, num_samples = self._train(
            msg.get(Message.ARG_MODEL_PARAMS),
            msg.get(Message.ARG_CLIENT_INDEX), round_idx)
        with self._span("upload", round=round_idx):
            self.send(MsgType.C2S_MODEL, self.server_id,
                      **{Message.ARG_MODEL_PARAMS: upload,
                         Message.ARG_NUM_SAMPLES: int(num_samples),
                         Message.ARG_ROUND: round_idx})

    def _on_shard_sync(self, msg: Message) -> None:
        """Bank one broadcast shard slice; when the round's model is
        complete, train on the joined tree and upload it as S slice
        frames (split by the plan spec shard 0's frame carried)."""
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
        with self._span("upload", round=round_idx):
            for s, sl in enumerate(slices):
                self.send(MsgType.C2S_MODEL, self.server_id,
                          **{Message.ARG_MODEL_PARAMS: sl,
                             Message.ARG_NUM_SAMPLES: int(num_samples),
                             Message.ARG_ROUND: round_idx,
                             Message.ARG_SHARD: s,
                             Message.ARG_SHARD_COUNT: len(slices)})
