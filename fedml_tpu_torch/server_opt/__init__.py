"""The server-optimizer seam (``optimizer``): plain | momentum | adam |
fedac over the live finalize, and the health-driven adaptive round
controller (``controller``)."""

from fedml_tpu_torch.server_opt.controller import (  # noqa: F401
    AdaptiveController, Decision)
from fedml_tpu_torch.server_opt.optimizer import (  # noqa: F401
    SERVER_OPT_NAMES, ServerOptConfigError, ServerOptimizer,
    ServerOptMismatchError)
