"""Start a run's ranks from one invocation (the ``mpirun -np N``
replacement for one host).

`spawn_ranks(fn, world, args)` starts ``world`` processes with the
``spawn`` start method (a caller that already holds CUDA can fork none),
joins them into one process group through a file store in a temporary
directory (no port to race for), runs ``fn(*args)`` on each rank and
returns every rank's return value, in rank order.  A rank that raises or
dies fails the whole launch with that rank's error, and the others are
stopped; a rendezvous or a collective that waits past its timeout raises
in its rank the same way, so a launch never hangs."""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

from fedml_tpu_torch.parallel import mesh as mesh_lib


class RankFailed(RuntimeError):
    """A rank of a launch raised or died; the message carries its error."""


def _rank_entry(rank: int, fn: Callable, world: int, store: str,
                platform, out_dir: str, args, timeout_s: float) -> None:
    if platform == "cpu":
        # the ranks share the host's cores
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh_lib.init_from_file(store, rank, world, platform=platform,
                                timeout_s=timeout_s)
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        # the error and when it happened: a rank's failure makes its
        # peers' collectives fail after it, and the first one is the cause
        with open(os.path.join(out_dir, f"rank{rank}.err"), "wb") as f:
            pickle.dump((time.time(), traceback.format_exc()), f)
        raise
    finally:
        mesh_lib.shutdown_distributed()


def _rank_errors(out_dir: str, world: int) -> str:
    """The failed ranks' errors, the earliest first."""
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path, "rb") as f:
                at, tb = pickle.load(f)
            errors.append((at, r, tb))
    return "\n".join(f"rank {r} of {world} failed:\n{tb}"
                     for _, r, tb in sorted(errors))


def spawn_ranks(fn: Callable, world: int, args=(), platform=None,
                join_timeout_s: Optional[float] = None,
                timeout_s: float = mesh_lib.DIST_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new ranks of one process group;
    their return values in rank order.  ``fn`` must be importable by name
    (a module-level function); ``platform`` "cpu" puts every rank on the
    CPU.  ``join_timeout_s``: stop every rank and raise once the launch
    takes longer."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    if world < 1:
        raise ValueError(f"a launch needs >= 1 rank, got {world}")
    with tempfile.TemporaryDirectory(prefix="fedml_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, store, platform, tmp, tuple(args),
                               timeout_s),
            nprocs=world, join=False, start_method="spawn")
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise RankFailed(
                        f"the {world} ranks did not finish within "
                        f"{join_timeout_s:g} s")
        except ProcessException as e:
            for p in ctx.processes:
                p.join(5)
            raise RankFailed(_rank_errors(tmp, world) or
                             f"rank {e.error_index} of {world} failed: "
                             f"{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
