"""The server-optimizer seam (``optimizer``): plain | momentum | adam |
fedac over the live finalize.  The adaptive controller of the JAX package
(``server_opt/controller.py``) needs the health observatory and arrives
with it (ROADMAP Queue 1 item 9)."""

from fedml_tpu_torch.server_opt.optimizer import (  # noqa: F401
    SERVER_OPT_NAMES, ServerOptConfigError, ServerOptimizer,
    ServerOptMismatchError)
