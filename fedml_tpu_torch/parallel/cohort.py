"""The cohort engine: one FL round over a stacked cohort.

Port of ``fedml_tpu/parallel/cohort.py``.  A cohort is a dict of tensors
``{x, y, mask: [C, S, B, ...], num_samples: [C]}``; the local trainer runs
over its client axis in one of two ways, which give identical stacked
outputs:

* ``"vmap"`` — ``torch.func.vmap`` trains all clients together; convs
  with per-client weights become grouped convs;
* ``"scan"`` — a Python loop trains one client at a time; every conv is a
  dense cuDNN conv.

A client's keys are those of its *global* cohort slot, ``index_offset +
i`` (the JAX package's ``fold_in(round_key, slot)``), so a cohort trained
in chunks (the cross-device engine's waves) draws what one whole cohort
would: a keyed trainer's dropout keys (`client_keys`) and a per-client
hook's noise generator (`client_generator`).

The device-resident round (`make_device_round`) keeps the whole stacked
train split on the device and gathers the cohort by ids inside the round,
so only the ids cross per round; `make_scanned_rounds` runs K such rounds
per call.  On the CPU both are the eager round body.  On a CUDA device
the round is captured once as a ``torch.cuda.CUDAGraph`` (`GraphedRounds`)
and replayed, K times a chunk, with the chunk's ids and live masks copied
to the device in one transfer and a device-side round counter picking
each replay's row.

On a mesh (`parallel.mesh.Mesh`, one rank a position of its ``clients``
axis) each rank trains its block of the cohort's rows with the keys of
their global slots and the round's reductions become sums over the ranks
(`Mesh.allsum`): `make_cohort_step` and `cohort_eval` take ``mesh=``, and
`make_sharded_stateful_round` is the one wrap the stateful algorithms
share.  With a `parallel.mesh.Placement` the step is the ``[clients,
model]`` (tensor-parallel) or ``[clients, experts]`` round.  A mesh always
takes the host loop: no resident split and no CUDA
graph (gloo's collectives cannot be captured).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree, tree_stack, tree_weighted_mean
from fedml_tpu_torch.parallel.mesh import Shard, stage_global

CohortData = Dict[str, torch.Tensor]


def client_generator(seed_words: Sequence[int], slot: int,
                     device) -> torch.Generator:
    """The noise generator of one cohort slot in one round, keyed by the
    round's seed words and the slot's index in the cohort."""
    seq = np.random.SeedSequence([int(w) & 0xFFFFFFFF for w in seed_words]
                                 + [0x7FFFFFFF, int(slot)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
    return gen


def client_keys(seed_words: Sequence[int], n: int, index_offset: int,
                device) -> torch.Tensor:
    """``fold_in(round_key, index_offset + i)`` for the ``n`` slots, as a
    ``[n, 2]`` int64 tensor on ``device``; the round key is the one whose
    words are ``seed_words``."""
    key = (int(seed_words[0]) & prng.M32, int(seed_words[1]) & prng.M32)
    slots = torch.arange(n, dtype=torch.int64, device=device) \
        + int(index_offset)
    return prng.fold_in_many(key, slots)


def cohort_rngs(local_train, data: CohortData, seed_words: Sequence[int],
                index_offset: int = 0) -> Optional[torch.Tensor]:
    """A keyed trainer's per-client step keys ``[C, steps, 2]`` for the
    cohort ``data``, or None for a trainer that takes no key."""
    rng_inputs = getattr(local_train, "rng_inputs", None)
    if rng_inputs is None:
        return None
    n = data["num_samples"].shape[0]
    keys = client_keys(seed_words, n, index_offset,
                       data["num_samples"].device)
    return rng_inputs(keys, data["mask"].shape[1])


def train_cohort(local_train, params: Tree, data: CohortData,
                 seed_words: Sequence[int] = (0, 0), transform_update=None,
                 client_axis: str = "vmap", index_offset: int = 0):
    """Run ``local_train`` over the stacked client axis; returns the
    stacked client params and metrics.  ``transform_update(client_params,
    global_params, generator) -> client_params`` runs per client after
    training (the defense hook).  ``index_offset``: the global cohort
    slot of ``data``'s first client, which keys its dropout and noise."""
    if client_axis not in ("vmap", "scan"):
        raise ValueError(f"client_axis must be 'vmap' or 'scan', "
                         f"got {client_axis!r}")
    n_clients = data["num_samples"].shape[0]
    batches = {k: v for k, v in data.items() if k != "num_samples"}
    rngs = cohort_rngs(local_train, data, seed_words, index_offset)
    extra = () if rngs is None else (rngs,)
    if client_axis == "scan":
        outs = [local_train(params, {k: v[i] for k, v in batches.items()},
                            *(r[i] for r in extra))
                for i in range(n_clients)]
        new_params = tree_stack([o[0] for o in outs])
        metrics = tree_stack([o[1] for o in outs])
    else:
        new_params, metrics = vmap(
            local_train, in_dims=(None, 0) + (0,) * len(extra))(
            params, batches, *extra)
    if transform_update is not None:
        device = data["num_samples"].device
        rows = [transform_update({k: v[i] for k, v in new_params.items()},
                                 params, client_generator(
                                     seed_words, index_offset + i, device))
                for i in range(n_clients)]
        new_params = tree_stack(rows)
    return new_params, metrics


def _call_aggregate(aggregate, stacked, weights, global_params, seed_words):
    """Aggregates take (stacked, weights); fused ones that also need the
    round context (clip relative to the global, noise keyed by the round)
    set ``needs_global``."""
    if getattr(aggregate, "needs_global", False):
        return aggregate(stacked, weights, global_params, seed_words)
    return aggregate(stacked, weights)


def bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-client ``[C]`` vector shaped to broadcast over ``[C, ...]``
    leaves of ``ndim`` dims."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def psum_fn(psum_axis) -> Callable:
    """The sum over the ranks of a mesh axis that a shared round body
    applies to its partial sums (a tensor or a dict of tensors): the
    identity off a mesh."""
    return (lambda x: x) if psum_axis is None else psum_axis


def cohort_rows(cohort) -> int:
    """The whole cohort's client count, of a cohort or of a rank's staged
    block of it."""
    return getattr(cohort, "global_rows", None) \
        or cohort["num_samples"].shape[0]


def _local(tree):
    """A staged tree as the plain dict the trainers take."""
    return dict(tree) if isinstance(tree, Shard) else tree


def make_cohort_step(local_train, aggregate=tree_weighted_mean,
                     transform_update=None, client_axis: str = "vmap",
                     mesh=None, placement=None) -> Callable:
    """Build ``step(global_params, cohort_data, seed_words) -> (new_global,
    metrics)``: train the cohort, apply the per-client hook, aggregate.

    ``mesh``: shard the cohort's rows over the mesh's ``clients`` axis.
    Each rank trains its block (its clients keyed by their global slots),
    takes the weighted partial sums of its rows and one sum over the ranks
    gives every rank the new global; the per-client metrics come back
    gathered.  The cohort (all of it, or a `stage_global` shard) must
    divide over the axis; the aggregate is the weighted mean.

    ``placement`` (`parallel.mesh.Placement`, from ``tp_shard_params`` or
    ``ep_shard_params``): the ``[clients, model]`` or ``[clients,
    experts]`` round.  The parameters are sharded on the placement's
    axis; ``local_train`` is a trainer whose workload runs the model on
    that axis (``forward_kwargs={"tp_axis": mesh.axis(...)}``).  A rank
    trains its clients one after another (``torch.func.vmap`` cannot
    carry a collective), the weighted mean sums each block over the
    ``clients`` subgroup, and the blocks are gathered back into the whole
    tree in its leaf order, so every rank returns the same bytes; the
    step takes the whole tree or the rank's blocks."""

    if placement is not None:
        if transform_update is not None or aggregate is not \
                tree_weighted_mean:
            raise ValueError(
                "the model-parallel step averages blocks of the update: a "
                "per-client hook or another aggregate needs whole updates")
        return _model_parallel_step(local_train, mesh, placement)
    if mesh is None:
        def step(global_params: Tree, cohort_data: CohortData,
                 seed_words: Sequence[int] = (0, 0)):
            stacked, metrics = train_cohort(
                local_train, global_params, cohort_data, seed_words,
                transform_update=transform_update, client_axis=client_axis)
            new_global = _call_aggregate(aggregate, stacked,
                                         cohort_data["num_samples"],
                                         global_params, seed_words)
            return new_global, metrics
        return step

    if aggregate is not tree_weighted_mean:
        raise ValueError(
            "the mesh cohort step aggregates with the weighted mean, a sum "
            "over the ranks; another aggregate needs the whole cohort on "
            "one rank")

    def sharded(global_params: Tree, cohort_data: CohortData,
                seed_words: Sequence[int] = (0, 0)):
        local = stage_global(cohort_data, mesh, "clients")
        params = stage_global(global_params, mesh)
        offset = mesh.axis_index("clients") * local["num_samples"].shape[0]
        stacked, metrics = train_cohort(
            local_train, params, _local(local), seed_words,
            transform_update=transform_update, client_axis=client_axis,
            index_offset=offset)
        w = local["num_samples"].to(torch.float32)
        ratio = w / mesh.allsum(torch.sum(w))
        new_global = mesh.allsum({
            k: torch.sum(x * bcast(ratio, x.dim()).to(x.dtype), 0)
            for k, x in stacked.items()})
        return new_global, mesh.all_gather_rows(metrics)

    return sharded


def _model_parallel_step(local_train, mesh, placement):
    if "clients" not in mesh.shape:
        raise ValueError(f"the cohort step needs a clients axis; the mesh "
                         f"is {mesh.shape}")
    workload = getattr(local_train, "workload", None)
    if workload is not None:
        placement.check(workload.model)

    def step(global_params: Tree, cohort_data: CohortData,
             seed_words: Sequence[int] = (0, 0)):
        local = stage_global(cohort_data, mesh, "clients")
        params = placement.shard(stage_global(dict(global_params), mesh))
        offset = mesh.axis_index("clients") * local["num_samples"].shape[0]
        stacked, metrics = train_cohort(
            local_train, params, _local(local), seed_words,
            client_axis="scan", index_offset=offset)
        w = local["num_samples"].to(torch.float32)
        ratio = w / mesh.allsum(torch.sum(w))
        blocks = mesh.allsum({
            k: torch.sum(x * bcast(ratio, x.dim()).to(x.dtype), 0)
            for k, x in stacked.items()})
        return placement.gather(blocks), mesh.all_gather_rows(metrics)

    return step


def make_sharded_stateful_round(core, mesh, in_specs, out_specs):
    """Wrap a shared round body ``core(*args, psum_axis=, index_offset=)``
    for the mesh: the one home of the stateful algorithms' mesh convention
    (FedNova, SCAFFOLD, FedDyn, Ditto, FedAC, DP-FedAvg share it).

    ``in_specs``: per positional argument, None (replicated: moved to the
    rank's device) or ``"clients"`` (the rank's block of rows); the second
    argument is the cohort, whose block gives the rank's global slot
    offset.  ``core`` reduces with ``psum_axis`` (a sum over the ranks of
    the ``clients`` axis).  ``out_specs``: per output, None or
    ``"clients"``; a ``"clients"`` output is gathered over the axis, so
    every rank holds the whole cohort's rows and mirrors the host state
    as every other rank does (the JAX package's multi-process branch)."""
    in_specs = in_specs if isinstance(in_specs, tuple) else (in_specs,)
    single = not isinstance(out_specs, tuple)
    out_specs = (out_specs,) if single else out_specs

    def psum(tree):
        return mesh.allsum(tree, "clients")

    def staged(*args):
        args = [_local(stage_global(a, mesh, s))
                for a, s in zip(args, in_specs)] + list(args[len(in_specs):])
        offset = (mesh.axis_index("clients")
                  * args[1]["num_samples"].shape[0])
        out = core(*args, psum_axis=psum, index_offset=offset)
        outs = tuple(mesh.all_gather_rows(o, "clients") if s == "clients"
                     else o
                     for o, s in zip((out,) if single else out, out_specs))
        return outs[0] if single else outs

    return staged


def pad_clients(data: CohortData, n: int) -> CohortData:
    """Zero-pad the leading client axis to a multiple of ``n``; padded rows
    carry mask 0 and weight 0."""
    C = next(iter(data.values())).shape[0]
    if C % n == 0:
        return data
    pad = n - C % n
    return {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            for k, v in data.items()}


def cohort_eval(evaluate, mesh=None):
    """Evaluate one (global) model over a stacked cohort of datasets;
    returns the summed metric dict.  ``mesh``: the cohort (host or device
    tensors, any client count) is padded to the ``clients`` axis, each
    rank evaluates its block and the sums are summed over the ranks."""

    def _eval_cohort(params: Tree, data: CohortData) -> Dict[str, torch.Tensor]:
        return evaluate(params, {k: v for k, v in data.items()
                                 if k != "num_samples"})

    if mesh is None:
        return _eval_cohort

    def sharded(params: Tree, data: CohortData) -> Dict[str, torch.Tensor]:
        data = pad_clients({k: torch.as_tensor(v) for k, v in data.items()},
                           mesh.shape["clients"])
        local = _local(stage_global(data, mesh, "clients"))
        return mesh.allsum(_eval_cohort(stage_global(params, mesh), local))

    return sharded


# ---------------------------------------------------------------------------
# the device-resident round
# ---------------------------------------------------------------------------

def gather_live_cohort(stacked: CohortData, ids: torch.Tensor,
                       live: torch.Tensor) -> CohortData:
    """The cohort, gathered on the device from the resident split by
    ``ids`` ([m] int64), with padded slots (``live`` 0) masked out: the
    one definition of the live-masking convention, the same arithmetic as
    the host gather (`data.stacking.gather_cohort`)."""
    cohort = {k: v.index_select(0, ids) for k, v in stacked.items()}
    cohort["mask"] = cohort["mask"] * live[:, None, None]
    cohort["num_samples"] = cohort["num_samples"] * live
    return cohort


def _device_round_body(local_train, aggregate, transform_update,
                       client_axis: str = "vmap"):
    """One device-resident round: gather by ids, mask, train the cohort,
    aggregate.  Shared by `make_device_round` and `make_scanned_rounds`,
    so the two paths cannot drift apart."""

    def body(params, stacked, ids, live, seed_words=(0, 0)):
        cohort = gather_live_cohort(stacked, ids, live)
        stacked_out, metrics = train_cohort(
            local_train, params, cohort, seed_words,
            transform_update=transform_update, client_axis=client_axis)
        return _call_aggregate(aggregate, stacked_out,
                               cohort["num_samples"], params,
                               seed_words), metrics

    return body


PLAN_BUFFERS = 16    # pinned plan copies a graphed round cycles through
WARMUP_ROUNDS = 1    # eager rounds on the capture stream before capturing

# when set to a directory, every capture writes its CUDA graph there as a
# Graphviz file (``cudaGraphDebugDotPrint``), for a caller that counts the
# kernel nodes the graph holds
GRAPH_DOT_DIR: Optional[str] = None


def _launch_counters() -> Dict[str, Dict[str, int]]:
    """The kernel wrappers' launch counters, by module."""
    from fedml_tpu_torch.core import fused_agg
    from fedml_tpu_torch.models import flash_attention
    from fedml_tpu_torch.secure import fused_mask
    return {"fused_agg": fused_agg.launch_counts,
            "flash_attention": flash_attention.launch_counts,
            "fused_mask": fused_mask.launch_counts}


def _launch_snapshot() -> Dict[str, int]:
    return {name: n for counts in _launch_counters().values()
            for name, n in counts.items()}


class GraphedRounds:
    """A device-resident round captured once as a CUDA graph and replayed.

    ``body`` is `_device_round_body`'s round (the base cohort step only:
    nothing on the captured path may synchronise with the host or draw
    from a CPU generator); ``stacked`` the resident split on the card.
    The graph reads the static params buffer (`params`) and a plan
    buffer ``[counter, rows]`` of ``max_rounds`` rows ``[ids (m), live
    (m)]``; it gathers row ``counter``'s cohort, trains it, aggregates,
    copies the new global into `params` and advances ``counter``.  So a
    chunk of K rounds is one host-to-device copy of the plan and K
    replays.

    The first `run` warms the round up on the capture stream (cuDNN picks
    its algorithms, kernel modules load) with outputs discarded, then
    captures.  A failed capture raises; there is no eager fallback.

    ``state``: persistent tensors a custom round body updates in place
    (FedNova's server momentum).  The graph reads and writes them on each
    replay; the warm-up's writes are undone before the capture, so the
    first replay is the first round.  Read or write them only between
    replays.

    Counted for callers: ``captures``, ``replays``, ``capture_s`` (warm-up
    and capture wall time), ``warmup_launches`` and
    ``captured_launches`` — the kernel wrappers' launch-counter deltas
    during the warm-up and during the capture (each replay launches the
    captured kernels once more, without the wrappers).  With
    `GRAPH_DOT_DIR` set, ``dot_path`` names the captured graph's file.
    """

    def __init__(self, body, stacked: CohortData, clients_per_round: int,
                 max_rounds: int = 1,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        device = next(iter(stacked.values())).device
        if device.type != "cuda":
            raise ValueError(
                f"GraphedRounds captures a CUDA graph; the resident split is "
                f"on {device}")
        for k, v in stacked.items():
            if v.device != device:
                raise ValueError(f"resident split leaf {k} is on {v.device}, "
                                 f"the rest on {device}")
        if max_rounds < 1 or clients_per_round < 1:
            raise ValueError(f"max_rounds and clients_per_round must be >= "
                             f"1, got {max_rounds}, {clients_per_round}")
        self._body = body
        self._state = state
        self.stacked = stacked
        self.device = device
        self.m = int(clients_per_round)
        self.max_rounds = int(max_rounds)
        self.warmup_rounds = WARMUP_ROUNDS
        n = 1 + self.max_rounds * 2 * self.m
        self._plan = torch.zeros(n, dtype=torch.int64, device=device)
        # pinned host copies of the plan, used in turn; a slot is rewritten
        # only once the copy that read it has run (its event), so no round
        # allocates pinned memory
        self._plan_host = [torch.zeros(n, dtype=torch.int64, pin_memory=True)
                           for _ in range(PLAN_BUFFERS)]
        self._plan_copied = [torch.cuda.Event() for _ in range(PLAN_BUFFERS)]
        self._plan_next = 0
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.metrics = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.warmup_launches: Dict[str, int] = {}
        self.captured_launches: Dict[str, int] = {}
        self.dot_path: Optional[str] = None

    def _round(self):
        rows = self._plan[1:].view(self.max_rounds, 2 * self.m)
        row = rows.index_select(0, self._plan[:1])[0]
        ids = row[:self.m]
        live = row[self.m:].to(torch.float32)
        return self._body(self.params, self.stacked, ids, live)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        before = _launch_snapshot()
        saved = ({k: v.clone() for k, v in self._state.items()}
                 if self._state else {})
        with torch.cuda.stream(stream):
            for _ in range(self.warmup_rounds):
                self._round()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        for k, v in saved.items():     # the warm-up was not a round
            self._state[k].copy_(v)
        mid = _launch_snapshot()
        dump = GRAPH_DOT_DIR is not None
        keep = False
        graph = torch.cuda.CUDAGraph()
        if dump:
            try:    # keep the captured graph past instantiation to print it
                graph, keep = torch.cuda.CUDAGraph(keep_graph=True), True
            except TypeError:
                pass
            graph.enable_debug_mode()
        # no garbage collection inside the capture: a collected object
        # that frees pinned memory or an event calls into CUDA off the
        # capture stream, which invalidates the capture
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                new_params, metrics = self._round()
                for k, v in self.params.items():
                    v.copy_(new_params[k])
                self._plan[:1].add_(1)
        except Exception as e:
            raise RuntimeError(
                f"capturing the device round as a CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            gc.enable()
        after = _launch_snapshot()
        self.metrics = metrics
        self.warmup_launches = {k: mid[k] - before[k] for k in mid
                                if mid[k] != before[k]}
        self.captured_launches = {k: after[k] - mid[k] for k in after
                                  if after[k] != mid[k]}
        if dump:
            import os
            os.makedirs(GRAPH_DOT_DIR, exist_ok=True)
            self.dot_path = os.path.join(GRAPH_DOT_DIR,
                                         f"round_graph_{id(self):x}.dot")
            if keep:
                graph.instantiate()
            graph.debug_dump(self.dot_path)
        self._graph = graph
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def _cache_size(self) -> int:
        """The recompile sentry's probe (`obs.perf.RecompileSentry`): the
        graphs captured — a capture after the first round is the port's
        recompile."""
        return self.captures

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        if self.params is None:
            self.params = {k: torch.empty_like(v, device=self.device)
                           for k, v in params.items()}
        if params is self.params:
            return
        if sorted(params) != sorted(self.params):
            raise ValueError("params do not match the captured round's "
                             "leaf set")
        for k, v in params.items():
            if v.device != self.device:
                raise ValueError(f"param {k} is on {v.device}; the graphed "
                                 f"round runs on {self.device}")
            self.params[k].copy_(v)

    def run(self, params: Dict[str, torch.Tensor], ids: np.ndarray,
            live: np.ndarray):
        """Run ``K = len(ids)`` rounds from ``params``; ``ids`` and
        ``live`` are ``[K, m]``.  Returns the static params and metrics
        buffers, which the next call overwrites: clone what must be
        kept."""
        ids = np.asarray(ids, np.int64)
        live = np.asarray(live, np.float32)
        k_rounds = ids.shape[0]
        if ids.shape != (k_rounds, self.m) or live.shape != ids.shape \
                or not 1 <= k_rounds <= self.max_rounds:
            raise ValueError(f"ids/live must be [K, {self.m}] with 1 <= K <= "
                             f"{self.max_rounds}, got {ids.shape}, "
                             f"{live.shape}")
        self._load_params(params)
        slot = self._plan_next
        self._plan_next = (slot + 1) % PLAN_BUFFERS
        self._plan_copied[slot].synchronize()
        n = 1 + k_rounds * 2 * self.m
        host = self._plan_host[slot][:n]
        plan = host.numpy()
        plan[0] = 0                                   # the round counter
        rows = plan[1:].reshape(k_rounds, 2 * self.m)
        rows[:, :self.m] = ids
        rows[:, self.m:] = live != 0
        self._plan[:n].copy_(host, non_blocking=True)
        self._plan_copied[slot].record()
        if self._graph is None:
            self._capture()
        for _ in range(k_rounds):
            self._graph.replay()
            self.replays += 1
        return self.params, self.metrics


def _graph_ready(stacked: CohortData, aggregate, transform_update,
                 keyed: bool = False) -> bool:
    """Whether the round is captured as a graph: on a CUDA device, for the
    base cohort step only (a per-client hook or a round-keyed aggregate
    draws from host generators or host scalars), and not for a keyed
    trainer (its dropout keys change every round; the graph replays one
    round's): that round runs eager on the card."""
    device = next(iter(stacked.values())).device
    if device.type != "cuda" or keyed:
        return False
    if transform_update is not None \
            or getattr(aggregate, "needs_global", False):
        raise ValueError(
            "the graphed device round serves the base cohort step only; "
            "a transform_update hook or a round-keyed aggregate runs the "
            "host loop")
    return True


class _DeviceRounds:
    """The device-resident round behind `make_device_round` and
    `make_scanned_rounds`: the eager body on the CPU, a `GraphedRounds`
    (``.graph``, captured at the first call) on a CUDA device."""

    def __init__(self, body, aggregate, transform_update,
                 clients_per_round: int, max_rounds: int, state=None,
                 keyed: bool = False):
        self._body = body
        self.keyed = keyed
        self._aggregate = aggregate
        self._transform_update = transform_update
        self.m = clients_per_round
        self.max_rounds = max_rounds
        self.state = state
        self.graph: Optional[GraphedRounds] = None

    def graphed(self, stacked) -> bool:
        return _graph_ready(stacked, self._aggregate, self._transform_update,
                            self.keyed)

    def eager(self, params, stacked, ids, live, seed_words=(0, 0)):
        # the cohort's ids and live mask on the resident split's device
        device = next(iter(stacked.values())).device
        return self._body(params, stacked,
                          torch.as_tensor(np.asarray(ids, np.int64),
                                          device=device),
                          torch.as_tensor(np.asarray(live, np.float32),
                                          device=device),
                          seed_words)

    def replay(self, params, stacked, ids, live):
        """Rows ``[K, m]`` of ids and live masks through the graph."""
        if self.graph is None:
            self.graph = GraphedRounds(self._body, stacked, self.m,
                                       self.max_rounds, state=self.state)
        elif self.graph.stacked is not stacked:
            raise ValueError("the graphed round was captured for another "
                             "resident split")
        return self.graph.run(params, np.asarray(ids).reshape(-1, self.m),
                              np.asarray(live).reshape(-1, self.m))


class _DeviceRound(_DeviceRounds):
    def __call__(self, params, stacked, ids, live, seed_words=(0, 0)):
        if self.graphed(stacked):
            return self.replay(params, stacked, ids, live)
        return self.eager(params, stacked, ids, live, seed_words)


class _ScannedRounds(_DeviceRounds):
    def __call__(self, params, stacked, ids, live, seed_words=None):
        if self.graphed(stacked):
            return self.replay(params, stacked, ids, live)
        metrics = None
        for k in range(len(ids)):
            words = (0, 0) if seed_words is None else seed_words[k]
            params, metrics = self.eager(params, stacked, ids[k], live[k],
                                         words)
        return params, metrics


def make_device_round(local_train, clients_per_round: int,
                      aggregate=tree_weighted_mean, transform_update=None,
                      client_axis: str = "vmap", body=None, state=None,
                      keyed: Optional[bool] = None):
    """The device-resident round: ``round_fn(params, stacked_dev, ids,
    live, seed_words=(0, 0)) -> (new_params, metrics)``, where
    ``stacked_dev`` is the resident ``{x, y, mask, num_samples}`` split,
    ``ids`` an int [m] cohort padded with any valid id and ``live`` its
    1/0 mask of real slots.

    On the CPU it is the eager round body.  On a CUDA device it is a
    `GraphedRounds` captured at the first call (``round_fn.graph`` after
    that) for that ``stacked_dev``; its outputs are the graph's static
    buffers, which the next call overwrites.

    ``body``: a custom round of the same signature in place of the base
    one (it gathers with `gather_live_cohort` itself), with ``state`` the
    dict of persistent tensors it updates in place (see `GraphedRounds`);
    the dict's tensors must exist before the first call.  ``keyed``: the
    round draws dropout keys (default: whether ``local_train`` is keyed),
    so it runs eager, never captured."""
    if keyed is None:
        keyed = getattr(local_train, "rng_inputs", None) is not None
    if body is None:
        body = _device_round_body(local_train, aggregate, transform_update,
                                  client_axis)
    return _DeviceRound(body, aggregate, transform_update,
                        clients_per_round, 1, state=state, keyed=keyed)


def make_scanned_rounds(local_train, clients_per_round: int,
                        aggregate=tree_weighted_mean, transform_update=None,
                        client_axis: str = "vmap", max_rounds: int = 1):
    """K rounds per call over the resident split: ``rounds_fn(params,
    stacked_dev, ids [K, m], live [K, m], seed_words=None) ->
    (params, metrics)``, ``seed_words`` one pair per round.  On the CPU a
    loop of the eager round body; on a CUDA device one `GraphedRounds`
    with room for ``max_rounds`` rows, replayed K times
    (``rounds_fn.graph``)."""
    return _ScannedRounds(_device_round_body(local_train, aggregate,
                                             transform_update, client_axis),
                          aggregate, transform_update, clients_per_round,
                          max_rounds, keyed=getattr(
                              local_train, "rng_inputs", None) is not None)
