"""Serving for the port (twin of ``fedml_tpu/serve``): the train →
aggregate → **serve** leg, stdlib + torch only.

    registry  versioned model registry: atomic hot swap of the live
              (params, apply_fn, version) snapshot, pin/rollback,
              canaries, a checkpoint watcher (serve-while-train)
    batcher   dynamic micro-batching: size/deadline flush triggers,
              power-of-two buckets, deadline shedding, admission tiers,
              drain on stop
    server    ThreadingHTTPServer frontend: /predict, /healthz (deep),
              /version, /metrics
    pool      N SO_REUSEPORT accept loops x N micro-batchers over ONE
              registry, worker-labeled telemetry
    decode    continuous-batching decode: one CUDA-graph step over fixed
              [slots], per-step admission, the swap barrier
    release   the release gate: canary shadow eval, health and held-out
              eval signals, promote or roll back, crash-consistent

Everything is instrumented through `obs.telemetry` under
``fedml_serve_*`` and ``fedml_release_*``.
"""

from fedml_tpu_torch.serve.batcher import (MicroBatcher, ShedError,
                                           TierGate, TIERS)
from fedml_tpu_torch.serve.decode import DecodeResult, DecodeScheduler
from fedml_tpu_torch.serve.pool import ServeWorkerPool
from fedml_tpu_torch.serve.registry import ModelRegistry, ServedModel
from fedml_tpu_torch.serve.release import ReleaseController, ShadowSampler
from fedml_tpu_torch.serve.server import ServeFrontend

__all__ = ["MicroBatcher", "ShedError", "TierGate", "TIERS",
           "DecodeResult", "DecodeScheduler", "ServeWorkerPool",
           "ModelRegistry", "ServedModel", "ServeFrontend",
           "ReleaseController", "ShadowSampler"]
