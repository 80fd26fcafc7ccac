"""The shard spine bundle: plan + sharded fold + sharded admission, and
the wire helpers both actor ends speak.

Port of ``fedml_tpu/shard_spine/spine.py``.  Server side, `ShardSpine` is
what ``--model_shards S`` hands `FedAvgServerActor` (``shard_wire=``): the
per-round broadcast slices (one encode-once `SharedPayload` fan-out PER
SHARD), the per-silo upload assembly + admission, and the plan spec shard
0's sync frame ships.  Silo side, `SiloShardAssembler` banks a round's
inbound shard slices until all S arrived (any order), joins them into the
params tree the train fn consumes, and splits the trained tree back into
upload slices — all from the plan spec, so a silo needs no shard
configuration.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.comm.message import _flatten_arrays
from fedml_tpu_torch.core.pytree import to_host
from fedml_tpu_torch.parallel.mesh import make_model_mesh
from fedml_tpu_torch.shard_spine.admission import ShardAdmission
from fedml_tpu_torch.shard_spine.agg import ShardedStreamingAggregator
from fedml_tpu_torch.shard_spine.plan import (ShardPlan, SiloShardCodec,
                                              build_shard_plan)

log = logging.getLogger(__name__)


class ShardSpine:
    """Everything the sharded round needs, built once per federation."""

    def __init__(self, plan: ShardPlan, agg: ShardedStreamingAggregator,
                 admission: Optional[ShardAdmission]):
        self.plan = plan
        self.agg = agg
        self.admission = admission
        self._spec = plan.spec()

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    def round_start(self, host_params) -> None:
        if self.admission is not None:
            self.admission.round_start(host_params)

    def round_end(self) -> None:
        if self.admission is not None:
            self.admission.round_end()

    def broadcast_slices(self, host_params) -> List[dict]:
        """The round's per-shard broadcast payloads from the global's host
        mirror (views — each becomes ONE `SharedPayload` for the whole
        cohort)."""
        leaves, _ = _flatten_arrays(host_params)
        return self.plan.split_leaves(leaves)

    def spec(self) -> dict:
        """The plan descriptor shard 0's sync frame ships."""
        return self._spec

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """The layout, a fixed-shape record in the round checkpoint: a
        resume re-derives the plan and checks it against this."""
        return {"num_shards": np.asarray(self.plan.num_shards, np.int64),
                "plan_fp": np.asarray(self.plan.fingerprint(), np.int64)}

    def restore_checkpoint_state(self, state) -> None:
        want_s = int(np.asarray(state["num_shards"]))
        want_fp = int(np.asarray(state["plan_fp"]))
        if want_s != self.plan.num_shards:
            raise ValueError(
                f"checkpoint was written under --model_shards {want_s} "
                f"but this run uses {self.plan.num_shards}; resume with "
                f"the original shard count (the layout is part of the "
                f"checkpointed state)")
        if want_fp != self.plan.fingerprint():
            raise ValueError(
                "checkpoint records a different shard-plan fingerprint "
                "than this run re-derived (the model or split threshold "
                "changed); refusing to resume under a mismatched layout")

    def journal_mode(self) -> str:
        """The journal's round-mode tag: recovery refuses a journal
        written under another shard count (or by the replicated fold)."""
        return f"shard_mean[S={self.plan.num_shards}]"


def build_shard_spine(template, *, num_shards: int,
                      norm_clip: float = 0.0, noise_std: float = 0.0,
                      seed: int = 0, fused: str = "auto",
                      admission_on: bool = True,
                      max_num_samples: float = 1e6, norm_k: float = 6.0,
                      norm_window: int = 64, norm_min_history: int = 8,
                      trust=None, min_split_elems: int = 1024
                      ) -> ShardSpine:
    """Build the spine from the live template (the port's flat params
    dict; its device is where the fold state lives).

    ``fused``: ``"on"`` finalizes through K2 everywhere (the CUDA kernel
    on the GPU, its plain version on the CPU — the JAX package's interpret
    mode); ``"auto"`` uses K2 on the GPU and the compose on the CPU;
    ``"off"`` keeps the compose everywhere.

    On the GPU each shard gets its own device when the host has at least
    S of them (`parallel.mesh.make_model_mesh`); otherwise, and on the
    CPU, every shard lives on the template's device.
    """
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be auto|on|off, got {fused!r}")
    first = next(iter(template.values()))
    device = (first.device if isinstance(first, torch.Tensor)
              else torch.device("cpu"))
    use_fused = fused == "on" or (fused == "auto" and device.type == "cuda")
    mesh = make_model_mesh(num_shards) if device.type == "cuda" else None
    if mesh is None and num_shards > 1:
        log.info("--model_shards %d: the shards share %s (same math; a "
                 "per-device split needs >= %d devices)", num_shards, device,
                 num_shards)
    plan = build_shard_plan(template, num_shards,
                            min_split_elems=min_split_elems)
    agg = ShardedStreamingAggregator(
        plan, template, norm_clip=norm_clip, noise_std=noise_std,
        seed=seed, fused=use_fused, devices=mesh, device=device)
    admission = None
    if admission_on:
        admission = ShardAdmission(
            plan, template, max_num_samples=max_num_samples,
            norm_k=norm_k, norm_window=norm_window,
            norm_min_history=norm_min_history, trust=trust)
    return ShardSpine(plan, agg, admission)


class SiloShardAssembler:
    """Client-side shard choreography: bank sync slices per round until
    complete, join for training, split the trained tree for upload."""

    def __init__(self):
        self._codec: Optional[SiloShardCodec] = None
        self._round: Optional[int] = None
        self._slices: Dict[int, dict] = {}
        self._meta: Dict[str, object] = {}

    def offer(self, round_idx, shard, num_shards, slice_payload,
              spec: Optional[dict], meta: Optional[dict] = None) -> bool:
        """Bank one sync slice; returns True when the round's model is
        complete.  ``spec`` rides shard 0's frame; ``meta`` (client_idx,
        EF ack, ...) is banked from whichever frame carries it."""
        if spec is not None:
            if self._codec is None \
                    or self._codec.fingerprint != ShardPlan.from_spec(
                        spec).fingerprint():
                self._codec = SiloShardCodec(spec)
        if self._codec is None:
            log.warning("shard slice arrived before any plan spec; "
                        "dropping it (shard 0's frame carries the spec)")
            return False
        if num_shards is not None \
                and int(num_shards) != self._codec.num_shards:
            log.warning("shard slice claims %s shards but the plan has "
                        "%d; dropping it", num_shards,
                        self._codec.num_shards)
            return False
        if round_idx != self._round:
            if self._round is not None and round_idx is not None \
                    and round_idx < self._round:
                # a STALE frame (chaos delay/dup of an older round) must
                # not destroy the current round's partial assembly —
                # only a NEWER round supersedes it
                log.info("dropping stale round-%s shard slice (current "
                         "round %s)", round_idx, self._round)
                return False
            self._round = round_idx
            self._slices = {}
            self._meta = {}
        if meta:
            self._meta.update(meta)
        try:
            shard = int(shard)
        except (TypeError, ValueError):
            shard = -1
        if not 0 <= shard < self._codec.num_shards:
            # a mislabeled frame banked out of range would make the
            # completion count lie and take() KeyError mid-handler —
            # drop it like the server-side ShardAdmission does
            log.warning("dropping shard slice with out-of-range index "
                        "%s (plan has %d shards)", shard,
                        self._codec.num_shards)
            return False
        self._slices[shard] = slice_payload
        return len(self._slices) == self._codec.num_shards

    def take(self):
        """The completed round's ``(params_tree, meta)``; clears the
        bank."""
        slices = [self._slices[s]
                  for s in range(self._codec.num_shards)]
        params = self._codec.join(slices)
        meta = dict(self._meta)
        self._slices = {}
        self._meta = {}
        return params, meta

    def split_upload(self, new_params) -> List[dict]:
        if self._codec is None:
            raise RuntimeError("split_upload before any sync: no plan "
                               "spec has arrived")
        return self._codec.split(to_host(new_params))
