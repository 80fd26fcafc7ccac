"""Hierarchical FL: two-tier client -> group (edge) -> global averaging.

The port of ``fedml_tpu/algorithms/hierarchical.py`` (:1-839), in two
parts.

The simulated engine (`HierarchicalFedAvg`, JAX :161-280, over
``make_grouped_round`` :47-88): clients are assigned to ``group_num``
groups by ``RandomState(seed).randint``; each global round samples the
cohort with the seeded sampler, routes it to its groups, runs
``group_comm_round`` FedAvg rounds in each group, and averages the group
models weighted by their sampled clients' sample counts.  JAX runs the G
groups under ``vmap`` of a scanned group round; the port loops over the
groups on one card (each group's cohort padded to ``client_num_per_round``
and trained as one vmapped cohort step, as JAX's vmap pads it), with
JAX's keys: ``fold_in(round_key, g)``, then one ``split`` per group
round.  A group with no sampled client keeps the params and weighs 0 in
the global mean, as JAX's ``total > 0`` select and its uniform
``safe_w`` make it.  The loop costs G sequential cohort steps where JAX
pays one vmapped program; the clients of a group still train in
parallel.  On a 1-D ``clients`` mesh the same group loop runs over the
sharded cohort step.  On the two-level ``[groups, clients]`` mesh
(``make_two_level_round``, JAX :97-160) rank ``(g, c)`` trains block
``c`` of group ``g``'s cohort: each group round sums over the group's
``clients`` subgroup, and the global tier is the sample-weighted sum of
the group models over each ``groups`` subgroup; every group takes part,
an empty one with weight 0 and its params unchanged.

The live edge tier (`EdgeAggregatorActor`, JAX :283-839): an edge folds
its block of silos' uploads at arrival — with its own admission screen
and straggler timer — and ships ONE ``(mean, weight, count)`` frame a
round to an unmodified root `FedAvgServerActor`, whose "silos" are the
edges.  ``secagg`` (``--secagg grouped``) makes the edge the
`SecAggServer` of its block (advert relay, roster, ring fold, unmask) and
ships the plaintext partial mean in the same frame.  ``journal``: the
edge's own round journal, with the round reference inside its snapshot,
so `resume()` on a respawned edge restores its block mid-round.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.cross_silo import MsgType
from fedml_tpu_torch.algorithms.fedavg import FedAvg, FedAvgConfig
from fedml_tpu_torch.comm.actors import ClientManager, SelfMessageTimer
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import (flatten_nested, nest, to_host,
                                         tree_weighted_mean)
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data.stacking import gather_cohort
from fedml_tpu_torch.device import synchronize
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.parallel.cohort import bcast, train_cohort
from fedml_tpu_torch.parallel.mesh import broadcast_params, stage_global
from fedml_tpu_torch.secure.protocol import (MSG_SECAGG_ADVERT,
                                             MSG_SECAGG_ROSTER,
                                             MSG_SECAGG_SHARES,
                                             MSG_SECAGG_UNMASK, SecAggError)
from fedml_tpu_torch.utils.journal import tree_crc

logger = logging.getLogger(__name__)

# edge straggler timer self-message (continues the MsgType numbering of
# algorithms/cross_silo.py (1-6) and async_fl's MSG_RETASK_TICK (7))
MSG_EDGE_TIMEOUT = 8

@dataclasses.dataclass
class HierarchicalConfig(FedAvgConfig):
    group_num: int = 2
    group_comm_round: int = 2
    group_method: str = "random"


def make_two_level_round(local_train, group_comm_round: int, mesh):
    """The ``[groups, clients]`` mesh round (JAX :97-160):
    ``two_level(params, cohorts, round_key) -> new_params`` with cohort
    leaves ``[G, M, S, B, ...]`` (host or staged), G the mesh's groups
    axis and M divisible by its clients axis.  The keys are the grouped
    round's: ``fold_in(round_key, g)``, one ``split`` per group round, and
    a client's its slot in its group's cohort."""
    g = mesh.axis_index("groups")

    def two_level(params, cohorts, round_key):
        local = dict(stage_global(cohorts, mesh, ("groups", "clients")))
        offset = mesh.axis_index("clients") * local["num_samples"].shape[0]
        w = local["num_samples"].to(torch.float32)
        total_g = mesh.allsum(torch.sum(w), "clients")
        ratio = w / torch.clamp_min(total_g, 1.0)
        p = {k: v.to(mesh.device) for k, v in params.items()}
        r_g = prng.fold_in(round_key, g)
        for _ in range(group_comm_round):
            r_g, rloc = prng.split(r_g)
            stacked, _ = train_cohort(local_train, p, local,
                                      prng.key_words_int32(rloc),
                                      index_offset=offset)
            # accumulate in f32 and cast back, as tree_weighted_mean does
            p_new = mesh.allsum({k: torch.sum(
                x.to(torch.float32) * bcast(ratio, x.dim()), 0)
                for k, x in stacked.items()}, "clients")
            p = {k: torch.where(total_g > 0, p_new[k].to(v.dtype), v)
                 for k, v in p.items()}
        # the global tier: each group's model weighted by its share of
        # the round's samples, summed over the groups
        share = total_g / torch.clamp_min(
            mesh.allsum(total_g, "groups"), 1.0)
        out = mesh.allsum({k: v.to(torch.float32) * share
                           for k, v in p.items()}, "groups")
        return {k: out[k].to(v.dtype) for k, v in p.items()}

    return two_level


class HierarchicalFedAvg(FedAvg):
    def __init__(self, workload, data, config: HierarchicalConfig,
                 mesh=None, sink=None, device=None):
        # on the two-level mesh the inherited cohort step and evaluation
        # shard over each group's ``clients`` subgroup; the rounds go
        # through make_two_level_round
        super().__init__(workload, data, config, sink=sink, device=device,
                         mesh=mesh)
        two_level = mesh is not None and "groups" in mesh.axis_names
        cfg = config
        if cfg.group_method != "random":
            raise ValueError(f"unknown group_method {cfg.group_method!r}")
        if cfg.client_axis != "vmap":
            # the grouped rounds vmap inside their own bodies
            raise ValueError("client_axis is not wired into hierarchical "
                             "FL's grouped rounds; drop --client_axis")
        rng = np.random.RandomState(cfg.seed)
        self.group_indexes = rng.randint(0, cfg.group_num, data.client_num)
        self._two_level = None
        if two_level:
            if cfg.group_num != mesh.shape["groups"]:
                raise ValueError(
                    f"group_num={cfg.group_num} must equal the mesh groups "
                    f"axis ({mesh.shape['groups']})")
            self._two_level = make_two_level_round(
                self._local_train, cfg.group_comm_round, mesh)

    def _group_clients(self, ids: np.ndarray) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for cid in ids:
            groups.setdefault(int(self.group_indexes[cid]),
                              []).append(int(cid))
        return groups

    def _grouped_round(self, params, groups, round_key):
        """One two-tier round: ``group_comm_round`` cohort steps a group,
        then the weighted mean of the group models."""
        cfg = self.cfg
        if self._two_level is not None:
            cohorts = [gather_cohort(self.data.train, groups.get(g, []),
                                     pad_to=cfg.client_num_per_round)
                       for g in range(cfg.group_num)]
            return self._two_level(params, {k: torch.stack(
                [c[k] for c in cohorts]) for k in cohorts[0]}, round_key)
        group_params, group_weights = [], []
        for gidx in sorted(groups):
            gids = groups[gidx]
            cohort = self._gather(gids)
            w_group = params
            r_g = prng.fold_in(round_key, gidx)
            for _ in range(cfg.group_comm_round):
                r_g, rloc = prng.split(r_g)
                w_group, _ = self.cohort_step(w_group, cohort,
                                              prng.key_words_int32(rloc))
            group_params.append(w_group)
            group_weights.append(
                float(self.data.train["num_samples"][gids].sum()))
        return tree_weighted_mean(group_params, torch.as_tensor(
            group_weights, dtype=torch.float32, device=self.device))

    def run(self, params=None, checkpointer=None):
        cfg = self.cfg
        rng = prng.key(cfg.seed)
        if params is None:
            rng, _ = prng.split(rng)     # the JAX run's init key
            params = self.init_params()
        params = {k: v.to(self.device) for k, v in params.items()}
        params, rng, start_round = self._maybe_resume(checkpointer, params,
                                                      rng)
        params = broadcast_params(params, self.mesh)
        for global_round in range(start_round, cfg.comm_round):
            t0 = time.perf_counter()
            c0 = self._collective_ms()
            ids = sample_clients(global_round, self.data.client_num,
                                 cfg.client_num_per_round)
            groups = self._group_clients(np.asarray(ids))
            rng, rr = prng.split(rng)
            params = self._grouped_round(params, groups, rr)
            synchronize(self.device)
            round_s = time.perf_counter() - t0
            self.round_times.append(round_s)
            self._count_collectives(c0)
            self._maybe_eval(params, global_round, round_s)
            if checkpointer is not None:
                checkpointer.maybe_save(
                    global_round,
                    lambda: self._ckpt_state(params, rng, global_round),
                    last_round=global_round == cfg.comm_round - 1)
        if checkpointer is not None:
            checkpointer.flush()
        return params


# ---------------------------------------------------------------------------
# the live multi-level aggregator topology (edge aggregators -> root)
# ---------------------------------------------------------------------------

class _EdgeManager(ClientManager):
    """The edge's manager plumbing: a client to the root, a server to its
    silos."""

    def __init__(self, edge, node_id: int, transport):
        super().__init__(node_id, transport)
        self._edge = edge

    def register_handlers(self) -> None:
        edge = self._edge
        self.register_handler(MsgType.S2C_INIT, edge._on_sync)
        self.register_handler(MsgType.S2C_SYNC, edge._on_sync)
        self.register_handler(MsgType.C2S_MODEL, edge._on_upload)
        self.register_handler(MsgType.C2S_HEARTBEAT, lambda m: None)
        self.register_handler(MSG_EDGE_TIMEOUT, edge._on_timeout)
        self.register_handler(MsgType.S2C_FINISH, edge._on_finish)
        if edge.secagg is not None:
            self.register_handler(MSG_SECAGG_ADVERT, edge._on_secagg_advert)
            self.register_handler(MSG_SECAGG_SHARES, edge._on_secagg_shares)


class EdgeAggregatorActor:
    """An intermediate aggregator: folds its silos' uploads locally and
    ships one pre-reduced update a round to the root.

    * root ``S2C_INIT/SYNC`` -> edge: re-broadcast to the block with one
      payload serialization; each silo's client comes from the flat
      deployment's seeded sampler (``cohort_total``), so a silo trains
      identically under any topology;
    * silo ``C2S_MODEL`` -> edge: screened by the edge's own
      ``admission``, folded into its ``stream_agg`` at arrival;
    * edge ``C2S_MODEL`` -> root: the block's weighted mean as
      ``model_params``, its weight total as ``num_samples``, its fold
      count as ``edge_count``.  An edge with nothing admissible stays
      silent and the root's straggler policy closes over it.

    ``silos`` maps transport node id -> 1-based global cohort slot.
    ``timeout_s``: the edge's straggler bound, after which it flushes
    what folded.  ``secagg``: the block's `SecAggServer` (exclusive with
    ``stream_agg``).  ``journal``/``faultline``: the edge's round journal
    and crash points.  ``health``: a statistics-only
    `obs.health.HealthAccumulator` (``alarms=False``: the root owns the
    verdicts); the edge folds its silos' learning-health statistics and
    ships the block's compact rollup inside its round frame
    (``Message.ARG_HEALTH``)."""

    def __init__(self, node_id: int, transport, silos: Dict[int, int],
                 cohort_total: int, client_num_in_total: int,
                 stream_agg, admission=None, root_id: int = 0,
                 timeout_s: Optional[float] = None, health=None,
                 secagg=None, journal=None, faultline=None):
        if (secagg is None) == (stream_agg is None):
            raise ValueError("EdgeAggregatorActor needs exactly one of "
                             "stream_agg (plaintext fold) or secagg "
                             "(masked ring fold)")
        self.secagg = secagg
        self.journal = journal
        self.faultline = faultline
        self.health = health
        self._mgr = _EdgeManager(self, node_id, transport)
        self.node_id = node_id
        self.silos = dict(silos)
        self.cohort_total = cohort_total
        self.client_num_in_total = client_num_in_total
        self.stream_agg = stream_agg
        self.admission = admission
        self.root_id = root_id
        self.timeout_s = timeout_s
        self.round_idx: Optional[int] = None
        self._round_params = None
        self._received: set = set()
        self._timer = SelfMessageTimer()
        self._flushed = False
        self._secagg_stage: Optional[str] = None
        self._c_flush = telemetry.get_registry().counter(
            "fedml_stream_edge_flush_total")

    # -- lifecycle -----------------------------------------------------------
    def register_handlers(self) -> None:
        self._mgr.register_handlers()

    def run(self) -> None:
        self._mgr.run()

    def finish(self) -> None:
        self._timer.cancel(join=True)
        self._mgr.finish()

    @property
    def transport(self):
        return self._mgr.transport

    def _per_silo(self, round_idx: int, skip=()) -> Dict[int, dict]:
        ids = sample_clients(round_idx, self.client_num_in_total,
                             self.cohort_total)
        return {silo: {Message.ARG_CLIENT_INDEX: int(ids[g - 1])}
                for silo, g in sorted(self.silos.items())
                if g - 1 < len(ids) and silo not in skip}

    def resume(self) -> bool:
        """Mid-round recovery for a respawned edge: restore the journal's
        open round (the snapshot carries the reference, the fold and the
        durable fold list), re-sync only the silos whose uploads were not
        durable, and flush at once when all folded.  A round with no
        resumable snapshot is given up (the root's straggler policy closes
        over the edge).  True when a recovery engaged."""
        if self.journal is None:
            return False
        rec = self.journal.recover()
        if rec is None:
            return False
        if (not rec.resumable or rec.state is None or not rec.folded
                or rec.state.get("reference") is None):
            logger.warning(
                "edge %d: round %d crashed mid-flight without a "
                "resumable snapshot (mode=%s); giving the round up — "
                "the root's straggler policy closes over this edge",
                self.node_id, rec.round_idx, rec.mode)
            self.journal.abandon(rec.round_idx, "not resumable on edge")
            return False
        self.stream_agg.load_state_dict(rec.state)
        self.round_idx = rec.round_idx
        self._round_params = to_host(nest(self.stream_agg.reference))
        self._flushed = False
        self._received = {int(s) for s, _, _ in rec.folded}
        self.journal.note_resume(rec.round_idx, rec.folded,
                                 global_crc=rec.global_crc)
        if self.health is not None:
            # health is soft state: the recovery round reopens with the
            # fairness denominator intact; the folded silos' payload
            # statistics are gone with the process
            self.health.round_start(rec.round_idx, self._round_params,
                                    expected=sorted(self.silos))
        per_silo = self._per_silo(rec.round_idx, skip=self._received)
        logger.warning("edge %d: resuming round %d mid-round — %d fold(s) "
                       "restored, re-syncing silos %s", self.node_id,
                       rec.round_idx, len(self._received), sorted(per_silo))
        if per_silo:
            self._mgr.send_many(
                MsgType.S2C_SYNC, sorted(per_silo),
                shared_params={Message.ARG_MODEL_PARAMS: self._round_params,
                               Message.ARG_ROUND: rec.round_idx},
                per_receiver_params=per_silo)
            self._arm_timer()
        if self._received >= set(self.silos):
            self._flush()
        return True

    # -- root-facing side ----------------------------------------------------
    def _on_finish(self, msg) -> None:
        for silo in sorted(self.silos):
            self._mgr.send(MsgType.S2C_FINISH, silo)
        self.finish()

    def _on_sync(self, msg) -> None:
        round_idx = msg.get(Message.ARG_ROUND)
        params = msg.get(Message.ARG_MODEL_PARAMS)
        self.round_idx = round_idx
        self._received.clear()
        self._flushed = False
        self._secagg_stage = None
        # the round's reference global, kept for the admission screen
        self._round_params = params
        if self.journal is not None:
            self.journal.round_start(
                round_idx,
                mode=("secagg" if self.secagg is not None
                      else f"stream_{self.stream_agg.method}"),
                resumable=(self.secagg is None
                           and self.stream_agg.method == "mean"),
                global_crc=tree_crc(params),
                expected=sorted(self.silos))
        shared_extra = {}
        if self.secagg is not None:
            # the re-broadcast carries the block's masking parameters
            self.secagg.round_start(round_idx, sorted(self.silos))
            self._secagg_stage = "agreement"
            shared_extra[Message.ARG_SECAGG] = self.secagg.sync_info()
        else:
            self.stream_agg.reset(flatten_nested(params))
        if self.health is not None:
            self.health.round_start(round_idx, params,
                                    expected=sorted(self.silos))
        per_silo = self._per_silo(round_idx)
        self._mgr.send_many(
            msg.type, sorted(per_silo),
            shared_params={Message.ARG_MODEL_PARAMS: params,
                           Message.ARG_ROUND: round_idx, **shared_extra},
            per_receiver_params=per_silo)
        self._arm_timer()

    # -- silo-facing side ----------------------------------------------------
    def _arm_timer(self) -> None:
        if self.timeout_s is None:
            return
        round_at_arm = self.round_idx
        self._timer.arm(
            self.timeout_s,
            lambda: self._mgr.send(MSG_EDGE_TIMEOUT, self.node_id,
                                   **{Message.ARG_ROUND: round_at_arm}))

    def _on_timeout(self, msg) -> None:
        if msg.get(Message.ARG_ROUND) != self.round_idx or self._flushed:
            return
        if self._secagg_stage == "agreement":
            advertised = sorted(self.secagg.advertised())
            logger.warning("edge %d round %s: fixing the masking roster on "
                           "the %d silo(s) that advertised", self.node_id,
                           self.round_idx, len(advertised))
            try:
                self._send_rosters(subset=advertised)
            except SecAggError as e:
                self._give_up(f"roster below the share threshold ({e})")
            return
        if self._secagg_stage == "unmask":
            if self.secagg.can_finalize():
                self._finalize_secagg()
            else:
                self._give_up("below the unmask share threshold")
            return
        missing = sorted(set(self.silos) - self._received)
        logger.warning("edge %d round %s: silos %s missing after %.1fs; "
                       "flushing the partial fold", self.node_id,
                       self.round_idx, missing, self.timeout_s)
        self._flush()

    # -- secure aggregation (grouped masking) --------------------------------
    def _on_secagg_advert(self, msg) -> None:
        if msg.sender_id not in self.silos \
                or msg.get(Message.ARG_ROUND) != self.round_idx \
                or self._secagg_stage != "agreement":
            return
        if self.secagg.note_advert(msg.sender_id,
                                   msg.get(Message.ARG_SECAGG)):
            try:
                self._send_rosters()
            except SecAggError as e:  # unreachable with a full group
                self._give_up(str(e))

    def _send_rosters(self, subset=None) -> None:
        rosters = self.secagg.flush_roster(subset)  # raises below threshold
        self._secagg_stage = "upload"
        per = {silo: {Message.ARG_SECAGG: payload}
               for silo, payload in rosters.items()}
        self._mgr.send_many(MSG_SECAGG_ROSTER, sorted(per),
                            shared_params={Message.ARG_ROUND: self.round_idx},
                            per_receiver_params=per)
        self._arm_timer()

    def _begin_unmask(self) -> None:
        self._secagg_stage = "unmask"
        survivors, dead = self.secagg.unmask_request()
        if dead:
            logger.warning("edge %d round %s: reconstructing dead silo(s) "
                           "%s from surviving shares", self.node_id,
                           self.round_idx, dead)
        self._mgr.send_many(
            MSG_SECAGG_UNMASK, survivors,
            shared_params={Message.ARG_ROUND: self.round_idx,
                           Message.ARG_SECAGG: {"survivors": survivors,
                                                "dead": dead}})
        self._arm_timer()

    def _on_secagg_shares(self, msg) -> None:
        if msg.get(Message.ARG_ROUND) != self.round_idx \
                or self._secagg_stage != "unmask":
            return
        if self.secagg.note_reveal(msg.sender_id,
                                   msg.get(Message.ARG_SECAGG)):
            self._finalize_secagg()

    def _finalize_secagg(self) -> None:
        """Unmask the block's ring sum and ship the plaintext partial mean
        in the same one-frame-a-round format."""
        if self.faultline is not None:
            self.faultline.maybe_crash("mid_unmask",
                                       round_idx=self.round_idx)
        self._secagg_stage = None
        self._timer.cancel()
        try:
            mean, _den = self.secagg.finalize(reference=self._round_params)
        except SecAggError as e:
            self._give_up(f"unmask failed: {e}")
            return
        if mean is None:  # the post-unmask sum screen fired
            self._give_up("recovered sum rejected by the norm screen")
            return
        self._ship(mean, self.secagg.weight_total, self.secagg.count)

    def _give_up(self, why: str) -> None:
        """An unrecoverable masked round: stay silent; a partially
        unmasked sum never ships."""
        logger.warning("edge %d round %s: giving up the masked round (%s); "
                       "not reporting", self.node_id, self.round_idx, why)
        self._secagg_stage = None
        self._flushed = True
        self._timer.cancel()
        if self.journal is not None:
            self.journal.abandon(self.round_idx, why)
            self.journal.round_end(self.round_idx)
        if self.health is not None:
            self.health.round_end(self.round_idx)

    def _on_upload(self, msg) -> None:
        if msg.sender_id not in self.silos:
            logger.warning("edge %d: upload from foreign silo %d dropped",
                           self.node_id, msg.sender_id)
            return
        upload_round = msg.get(Message.ARG_ROUND)
        if upload_round != self.round_idx or self._flushed:
            logger.warning("edge %d: discarding round-%s upload from silo %d "
                           "(current round %s%s)", self.node_id,
                           upload_round, msg.sender_id, self.round_idx,
                           ", already flushed" if self._flushed else "")
            return
        if msg.sender_id in self._received:
            logger.info("edge %d: ignoring duplicate round-%s upload from "
                        "silo %d", self.node_id, upload_round,
                        msg.sender_id)
            return
        self._received.add(msg.sender_id)
        upload = msg.get(Message.ARG_MODEL_PARAMS)
        num_samples = msg.get(Message.ARG_NUM_SAMPLES)
        upload_norm = None
        if self.admission is not None:
            verdict = self.admission.admit(
                msg.sender_id, upload, num_samples,
                self._round_params, self.round_idx)
            if not verdict.ok:
                logger.warning("edge %d round %s: rejecting upload from "
                               "silo %d (reason=%s)", self.node_id,
                               self.round_idx, msg.sender_id,
                               verdict.reason)
                if self.health is not None:
                    self.health.observe_rejected(msg.sender_id,
                                                 verdict.reason)
                num_samples = None
            else:
                num_samples = verdict.num_samples
                upload_norm = verdict.norm
        if num_samples is not None:
            if self.health is not None:
                # health folds before the aggregation fold consumes the
                # upload (payload statistics suppressed under masking)
                self.health.observe_admitted(msg.sender_id, upload,
                                             float(num_samples),
                                             norm=upload_norm)
            if self.faultline is not None:
                self.faultline.maybe_crash("post_admission_pre_fold",
                                           round_idx=self.round_idx,
                                           silo=msg.sender_id)
            if self.secagg is not None:
                self._fold_masked(msg.sender_id, upload, float(num_samples))
            else:
                self.stream_agg.fold(flatten_nested(upload),
                                     float(num_samples))
                if self.journal is not None:
                    # the reference rides inside the edge snapshot
                    self.journal.note_accept(
                        self.round_idx, msg.sender_id, float(num_samples),
                        state_fn=(
                            (lambda: self.stream_agg.state_dict(
                                include_reference=True))
                            if self.stream_agg.method == "mean" else None))
        elif self.journal is not None:
            self.journal.note_accept(self.round_idx, msg.sender_id, 0.0,
                                     folded=False, reason="rejected")
        if self.faultline is not None:
            self.faultline.maybe_crash("post_fold_pre_ack",
                                       round_idx=self.round_idx,
                                       silo=msg.sender_id)
        if self.secagg is not None:
            # the masked barrier closes over the ROSTER by reports, so a
            # reported-but-rejected upload closes it as on the flat root
            if self._secagg_stage == "upload" \
                    and self._received >= \
                    set(self.secagg.roster_members()):
                self._flush()
            return
        if self._received >= set(self.silos):
            self._flush()

    def _fold_masked(self, silo: int, upload, num_samples: float) -> None:
        if self._secagg_stage != "upload":
            logger.warning("edge %d: masked upload from silo %d outside "
                           "the upload stage; dropped", self.node_id, silo)
            return
        try:
            self.secagg.fold(silo, upload, num_samples)
        except SecAggError as e:
            logger.warning("edge %d: rejecting masked upload from silo %d "
                           "(%s)", self.node_id, silo, e)
            return
        if self.journal is not None:
            # metadata only: masked edge rounds are abort-only
            self.journal.note_accept(self.round_idx, silo, num_samples)

    def _flush(self) -> None:
        """Close the block's upload phase: ship the plaintext fold's mean,
        or begin the masked block's unmask."""
        if self.faultline is not None:
            self.faultline.maybe_crash("barrier_close",
                                       round_idx=self.round_idx)
        self._timer.cancel()
        if self.secagg is not None:
            if self.secagg.count == 0:
                self._give_up("no admissible masked uploads")
                return
            self._begin_unmask()
            return
        self._flushed = True
        if self.stream_agg.count == 0:
            logger.warning("edge %d round %s: no admissible uploads; not "
                           "reporting", self.node_id, self.round_idx)
            if self.journal is not None:
                self.journal.round_end(self.round_idx)
            if self.health is not None:
                # the fairness ledger still records who never showed
                self.health.round_end(self.round_idx)
            return
        mean = to_host(nest(self.stream_agg.finalize(self.round_idx)))
        self._ship(mean, self.stream_agg.weight_total, self.stream_agg.count)

    def _ship(self, mean, weight_total: float, count: int) -> None:
        """One pre-reduced frame to the root: the block mean, its weight
        total and the fold count."""
        self._flushed = True
        self._c_flush.inc()
        extra = {}
        if self.health is not None:
            # closed on the edge's own mean: its global_delta_norm says
            # how far this block moved off the broadcast global
            self.health.round_end(self.round_idx, new_global=mean)
            summary = self.health.round_summary()
            if summary is not None:
                extra[Message.ARG_HEALTH] = summary
        self._mgr.send(
            MsgType.C2S_MODEL, self.root_id,
            **{Message.ARG_MODEL_PARAMS: mean,
               Message.ARG_NUM_SAMPLES: float(weight_total),
               Message.ARG_ROUND: self.round_idx,
               Message.ARG_EDGE_COUNT: int(count), **extra})
        if self.journal is not None:
            # after the send: a crash between the two re-ships, and the
            # root's duplicate guard discards the second frame
            self.journal.round_end(self.round_idx)
