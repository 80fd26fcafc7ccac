"""Sharded global-model spine: the round state, wire path, streaming fold
and defended finalize of the live federation, laid out per shard (the
port of ``fedml_tpu/shard_spine``).

* `plan` — the deterministic leaf→shard layout;
* `agg` — the sharded streaming fold (per-shard folds, two-phase clip,
  the fused K2 finalize);
* `admission` — per-shard structural screens + the combined-norm outlier
  screen, over the shared `TrustTracker`;
* `spine` — the server bundle (``--model_shards``) and the silo
  assembler.
"""

from fedml_tpu_torch.shard_spine.admission import ShardAdmission
from fedml_tpu_torch.shard_spine.agg import ShardedStreamingAggregator
from fedml_tpu_torch.shard_spine.plan import (ShardPlan, SiloShardCodec,
                                              build_shard_plan)
from fedml_tpu_torch.shard_spine.spine import (ShardSpine,
                                               SiloShardAssembler,
                                               build_shard_spine)

__all__ = [
    "ShardAdmission", "ShardedStreamingAggregator", "ShardPlan",
    "ShardSpine", "SiloShardAssembler", "SiloShardCodec",
    "build_shard_plan", "build_shard_spine",
]
