"""Meshes over ``torch.distributed`` (port of ``fedml_tpu/parallel/mesh.py``
and of ``make_sp_mesh`` from ``fedml_tpu/parallel/sequence.py``).

JAX places one controller over many devices; the port runs one process
(rank) per mesh position, as PyTorch does, and a `Mesh` is the rank's view
of the grid: its axis sizes (``mesh.shape["clients"]``, ``axis_names``),
its coordinates on each axis, its device and one process group per axis
(the ``clients`` subgroup it shares with the ranks of its row, and on the
two-level mesh the ``groups`` subgroup of its column).

* Each rank owns one device: ``cuda:(local_rank % device_count)``, or the
  CPU when the run asks for it.
* The backend follows from that layout and never changes on a failure:
  NCCL when every rank of a host has a card of its own, gloo on the CPU or
  when ranks share a card (NCCL refuses two ranks on one device).
* Every collective goes through the mesh (`Mesh.allsum`,
  `Mesh.all_gather_rows`, `Mesh.broadcast`, and on one axis
  `Mesh.axis(name)`'s ring shift and gradient-free sum).  ``allsum``
  over every axis at once (``mesh.axis_names``) reduces over the world.  On gloo a CUDA tensor is
  staged through a pinned host buffer explicitly: the collective runs on
  the host copy and the result is copied back.  A sum over ranks is one
  ``all_reduce`` per dtype: NCCL's and gloo's reductions hand every rank
  the same reduced bits, which the runs' per-rank sha256 of the globals
  (`Mesh.gather_hashes`) checks.
* A collective that fails raises; nothing is retried on another backend.

Tensor parallelism (`tp_shard_params`, JAX's placement rule) is a
placement in the JAX package, where GSPMD inserts the collectives.  Here a
rank holds its shards (`Placement`) and the layers that compute on them
(`models.layers`, `models.transformer`, `models.moe`) call Megatron's
three operators on the axis (`MeshAxis.copy`, ``reduce``, ``gather``),
custom autograd functions whose time counts as ``collective_ms("tp")``.

`init_distributed` is the ``mpirun -np N`` replacement: the coordinator
flags (``tcp://`` rendezvous), torchrun's environment, or a file store
(`init_from_file`, which `parallel.launch` uses for the ranks one
invocation starts).  Without any of them a run is one process and a mesh
of one position needs no process group.

`stage_global` moves host data to the rank: replicated trees to its
device, a ``"clients"``-sharded tree as the rank's block of rows
``[r·C/D, (r+1)·C/D)``.  Every rank holds the same host dataset, as in
the JAX package."""

from __future__ import annotations

import datetime
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# seconds a rendezvous or a collective waits for the other ranks before
# it raises
DIST_TIMEOUT_S = 300.0


class _Runtime:
    """What `init_distributed` chose for this process."""

    def __init__(self, device: torch.device, backend: str):
        self.device = device
        self.backend = backend


_RUNTIME: Optional[_Runtime] = None


def rank_device(local_rank: int, platform=None) -> torch.device:
    """The device of the rank with ``local_rank`` on its host: the CPU when
    ``platform`` asks for it, else ``cuda:(local_rank % device_count)``."""
    if platform is not None and torch.device(str(platform)).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --platform cpu (or "
            "device='cpu') to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when every rank of the host has a card of its own; gloo on the
    CPU or when ranks share a card."""
    if device.type == "cuda" \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init(init_method: str, rank: int, world: int, local_rank: int,
          local_world: int, platform, timeout_s: float) -> bool:
    global _RUNTIME
    device = rank_device(local_rank, platform)
    backend = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RUNTIME = _Runtime(device, backend)
    return True


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0,
                     platform=None, timeout_s: float = DIST_TIMEOUT_S
                     ) -> bool:
    """Join the run's process group: ``tcp://coordinator_address`` with
    ``num_processes`` ranks, this one ``process_id``; or, without a
    coordinator, torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
    environment.  Returns whether a group is up (a no-op, False, for one
    process with neither, as the JAX package's bootstrap is)."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return _init("env://", rank, world, local_rank, local_world,
                     platform, timeout_s)
    if coordinator_address is None or num_processes <= 1:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} must lie in [0, "
                         f"{num_processes})")
    # every rank named by the coordinator flags is taken to be on this
    # host: their count decides whether each has a card of its own
    return _init(f"tcp://{coordinator_address}", process_id, num_processes,
                 process_id, num_processes, platform, timeout_s)


def init_from_file(store_path: str, rank: int, world: int, platform=None,
                   timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Join a group of ``world`` ranks on this host through a file store
    (no port to race for): the ranks one invocation starts."""
    return _init(f"file://{store_path}", rank, world, rank, world, platform,
                 timeout_s)


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    global _RUNTIME
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _RUNTIME = None


def rank_and_world() -> Tuple[int, int]:
    """This process's rank and the number of ranks (0 and 1 without a
    process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _mesh_device(device) -> torch.device:
    if _RUNTIME is not None:
        if device is not None \
                and torch.device(str(device)).type != _RUNTIME.device.type:
            raise ValueError(f"the mesh's ranks run on "
                             f"{_RUNTIME.device}; device={device} asks for "
                             f"another kind")
        return _RUNTIME.device
    from fedml_tpu_torch.device import resolve_device
    return resolve_device(device)


class Mesh:
    """One rank's view of an ``[a0, a1]`` grid of ranks (row-major: rank
    ``r`` sits at ``(r // a1, r % a1)``).

    ``shape`` maps axis names to sizes; ``coords`` this rank's index on
    each; ``device`` and ``backend`` what `init_distributed` chose.  Once
    a process group is up, each axis has a group of the ranks that differ
    only in its coordinate; without one (a mesh of one position) the
    collectives return their input.

    ``collective_ms()`` is the time spent in collectives so far: CUDA
    events around each one on a card (the host staging of gloo included),
    the host clock on the CPU; ``collective_ms("p2p")`` the ring shifts'
    share."""

    def __init__(self, shape: Dict[str, int], device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank, self.world_size = rank_and_world()
        self.device = _mesh_device(device)
        self.backend = _RUNTIME.backend if _RUNTIME is not None else None
        sizes = [self.shape[a] for a in self.axis_names]
        strides = [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]
        self.coords = {a: (self.rank // s) % n for a, s, n in
                       zip(self.axis_names, strides, sizes)}
        self._groups: Dict[Any, Any] = {}
        # each axis's ranks (global), in the order of their coordinate
        self._axis_ranks = {
            a: [self.rank + (k - self.coords[a]) * s for k in range(n)]
            for a, s, n in zip(self.axis_names, strides, sizes)}
        if self.world_size > 1 or self.backend is not None:
            for i, axis in enumerate(self.axis_names):
                self._groups[axis] = self._axis_group(i, sizes, strides)
            self._groups[self.axis_names] = dist.group.WORLD
        self._events: List[Tuple[Any, Any, str]] = []
        self._host_ms: Dict[str, float] = {}

    def _axis_group(self, i: int, sizes, strides):
        if sizes[i] == self.world_size:
            return dist.group.WORLD
        mine = None
        # every rank creates every subgroup, in the same order
        others = [a for a in range(len(sizes)) if a != i]
        for fixed in np.ndindex(*[sizes[a] for a in others]):
            base = sum(c * strides[a] for c, a in zip(fixed, others))
            ranks = [base + k * strides[i] for k in range(sizes[i])]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    # -- the grid ------------------------------------------------------------
    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis(self, name: str) -> "MeshAxis":
        """This rank's view of the axis ``name``: its size and index, and
        the collectives along it that autograd sees."""
        return MeshAxis(self, name)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")

    # -- collectives ---------------------------------------------------------
    def _timed_start(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _timed_end(self, start, kind: str = "reduce") -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((start, ev, kind))
        else:
            self._host_ms[kind] = self._host_ms.get(kind, 0.0) \
                + (time.perf_counter() - start) * 1e3

    def collective_ms(self, kind: Optional[str] = None) -> float:
        """Milliseconds spent in collectives so far (synchronises with the
        device on a card); ``kind`` "p2p" counts the ring shifts alone,
        "tp" the tensor- and expert-parallel layers' operators, "reduce"
        every other collective."""
        if self._events:
            self._events[-1][1].synchronize()
            for a, b, k in self._events:
                self._host_ms[k] = self._host_ms.get(k, 0.0) \
                    + a.elapsed_time(b)
            self._events = []
        if kind is not None:
            return self._host_ms.get(kind, 0.0)
        return sum(self._host_ms.values())

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: a pinned host copy for gloo."""
        if self.backend == "gloo" and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t

    def _gather_flat(self, flat: torch.Tensor, axis: str,
                     kind: str = "reduce") -> List[torch.Tensor]:
        """Every rank's ``flat`` along ``axis``, in rank order, on this
        rank's device."""
        group = self._groups.get(axis)
        if group is None:
            return [flat]
        start = self._timed_start()
        src = self._staged(flat.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=group)
        if src is not flat:
            parts = [p.to(flat.device, non_blocking=True) for p in parts]
        self._timed_end(start, kind)
        return parts

    def allsum(self, tree, axis: str = "clients", kind: str = "reduce"):
        """The sum over ``axis`` of a tensor or a dict of tensors; one
        ``all_reduce`` per dtype.  ``kind`` names the share of
        `collective_ms` the time counts in."""
        if isinstance(tree, torch.Tensor):
            return self.allsum({"_": tree}, axis, kind)["_"]
        group = self._groups.get(axis)
        if group is None:
            return tree
        out = {}
        for keys, flat in _by_dtype(tree):
            start = self._timed_start()
            # `_by_dtype`'s vector is a fresh copy: reduce it in place
            buf = self._staged(flat)
            dist.all_reduce(buf, group=group)
            if buf is not flat:
                flat.copy_(buf, non_blocking=True)
            self._timed_end(start, kind)
            out.update(_split(keys, flat, tree))
        return {k: out[k] for k in tree}

    def ring_shift(self, tensors, axis: str, reverse: bool = False):
        """Each of ``tensors`` as the previous rank of ``axis`` holds it
        (coordinate ``i - 1`` mod n; ``reverse``: the next, ``i + 1``).
        The sends and the receives go out together as one
        ``batch_isend_irecv`` on the axis's group: a rank that sent before
        it received would deadlock a blocking backend."""
        group = self._groups.get(axis)
        if group is None or self.shape[axis] == 1:
            return list(tensors)
        ranks, n = self._axis_ranks[axis], self.shape[axis]
        i = self.coords[axis]
        step = -1 if reverse else 1
        dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
        start = self._timed_start()
        sends = [self._staged(t.contiguous()) for t in tensors]
        recvs = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                             pin_memory=t.is_pinned()) for t in sends]
        ops = []
        for tag, (out, back) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, out, dst, group, tag))
            ops.append(dist.P2POp(dist.irecv, back, src, group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = [r.to(t.device, non_blocking=True) if r.device != t.device
               else r for r, t in zip(recvs, tensors)]
        self._timed_end(start, "p2p")
        return out

    def all_gather_rows(self, tree, axis: str = "clients"):
        """Each leaf's rows ``[c, ...]`` from every rank of ``axis``,
        concatenated in rank order (``[c·D, ...]``)."""
        if isinstance(tree, torch.Tensor):
            return self.all_gather_rows({"_": tree}, axis)["_"]
        out = {}
        for keys, flat in _by_dtype(tree):
            parts = self._gather_flat(flat, axis)
            pieces = [_split(keys, p, tree) for p in parts]
            out.update({k: torch.cat([pc[k] for pc in pieces])
                        for k in keys})
        return {k: out[k] for k in tree}

    def broadcast(self, tree, src: int = 0):
        """A dict of tensors (or one tensor) as rank ``src`` holds it, on
        every rank of the world."""
        if isinstance(tree, torch.Tensor):
            return self.broadcast({"_": tree}, src)["_"]
        if self.world_size == 1 and self.backend is None:
            return tree
        out = {}
        for keys, flat in _by_dtype(tree):
            start = self._timed_start()
            buf = self._staged(flat.contiguous())
            dist.broadcast(buf, src=src)
            out.update(_split(keys, buf.to(flat.device), tree))
            self._timed_end(start)
        return {k: out[k] for k in tree}

    def gather_hashes(self, params) -> List[str]:
        """Every rank's `params_sha256` of ``params``, in rank order."""
        digest = params_sha256(params)
        if self.world_size == 1 and self.backend is None:
            return [digest]
        t = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8,
                         device=self.device)
        src = self._staged(t)
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return [bytes(p.cpu().tolist()).hex() for p in parts]


def _fresh(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """A custom function's output, never its input itself (an axis of
    one rank moves nothing)."""
    return out.clone() if out is inp else out


class _RingShift(torch.autograd.Function):
    """``(x, pos)`` from the previous rank of an axis; the gradient of
    ``x`` goes back to it (the transpose of JAX's ``ppermute``: the
    reverse shift).  ``pos`` (integer positions) carries none."""

    @staticmethod
    def forward(axis, x, pos):
        return tuple(_fresh(o, i) for o, i in zip(
            axis.mesh.ring_shift([x, pos], axis.name), (x, pos)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[0]
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _gpos):
        axis = ctx.axis
        return None, axis.mesh.ring_shift([g], axis.name, reverse=True)[0], \
            None


class _AllSumNoGrad(torch.autograd.Function):
    """The sum over an axis of a value that carries no gradient (a
    normaliser, a reported loss)."""

    @staticmethod
    def forward(axis, x):
        return _fresh(axis.mesh.allsum(x.contiguous(), axis.name), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, _g):
        return None, None


class _CopyToAxis(torch.autograd.Function):
    """Megatron's copy to the model-parallel region: the identity forward;
    backward sums the ranks' partial gradients over the axis, so a
    replicated input (or parameter) gets the whole gradient on every
    rank."""

    @staticmethod
    def forward(axis, x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[0]

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return None, _fresh(axis.mesh.allsum(g.contiguous(), axis.name,
                                             "tp"), g)


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's reduce from the model-parallel region: forward sums the
    ranks' partial outputs over the axis; backward is the identity."""

    @staticmethod
    def forward(axis, x):
        return _fresh(axis.mesh.allsum(x.contiguous(), axis.name, "tp"), x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherFromAxis(torch.autograd.Function):
    """Megatron's gather from the model-parallel region: forward
    concatenates the ranks' column shards on the last dim; backward hands
    each rank exactly its own slice of the (replicated) gradient."""

    @staticmethod
    def forward(axis, x):
        return torch.cat(axis.mesh._gather_flat(x, axis.name, "tp"), dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[0]
        ctx.width = inputs[1].shape[-1]

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.index * ctx.width
        return None, g[..., lo:lo + ctx.width].contiguous()


class MeshAxis:
    """One axis of a `Mesh` as a model running along it sees it (the JAX
    package's ``axis_name`` inside ``shard_map``): ``size``, this rank's
    ``index``, the ring shift autograd carries, a gradient-free sum and
    the tensor-parallel layers' ``copy``, ``reduce`` and ``gather``.  All
    run as custom autograd functions, so ``torch.func.grad`` takes
    them."""

    def __init__(self, mesh: "Mesh", name: str):
        self.mesh, self.name = mesh, name
        self.size = mesh.shape[name]
        self.index = mesh.coords[name]

    def shift(self, x: torch.Tensor, pos: torch.Tensor):
        """``(x, pos)`` as the previous rank on the axis holds them."""
        return _RingShift.apply(self, x, pos)

    def sum_no_grad(self, x: torch.Tensor) -> torch.Tensor:
        return _AllSumNoGrad.apply(self, x.detach())

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged; its gradient summed over the axis."""
        return _CopyToAxis.apply(self, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of the ranks' partial ``x``."""
        return _ReduceFromAxis.apply(self, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' column shards of ``x`` joined on the last dim."""
        return _GatherFromAxis.apply(self, x)

    def slice(self, x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        """This rank's block ``[index·width, (index+1)·width)`` of a
        replicated ``x`` on ``dim``, its gradient summed over the axis
        (so the replicated leaf's gradient is whole on every rank)."""
        return self.copy(x).narrow(dim, self.index * width, width)


def _by_dtype(tree: Dict[str, torch.Tensor]):
    """(keys, one flat contiguous vector of their leaves) per dtype."""
    groups: Dict[torch.dtype, List[str]] = {}
    for k, v in tree.items():
        groups.setdefault(v.dtype, []).append(k)
    for keys in groups.values():
        yield keys, torch.cat([tree[k].reshape(-1) for k in keys])


def _split(keys, flat: torch.Tensor, like) -> Dict[str, torch.Tensor]:
    """``flat`` cut back into ``keys``' leaves, shaped as ``like``'s."""
    out, off = {}, 0
    for k in keys:
        n = like[k].numel()
        out[k] = flat[off:off + n].reshape(like[k].shape)
        off += n
    return out


def params_sha256(params) -> str:
    """sha256 of every leaf's bytes, in key order: equal hashes mean
    byte-equal globals."""
    h = hashlib.sha256()
    for k in sorted(params):
        v = params[k]
        h.update(k.encode())
        h.update(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes()
                 if isinstance(v, torch.Tensor) else np.asarray(v).tobytes())
    return h.hexdigest()


def _n_devices(devices) -> int:
    if devices is None:
        return rank_and_world()[1]
    return devices if isinstance(devices, int) else len(list(devices))


def check_mesh_factors(client_axis: Optional[int], model_axis: int,
                       n: int, axis_names=("clients", "model")
                       ) -> Tuple[int, int]:
    """The ``[clients, model]`` axis sizes over ``n`` devices (ranks), or
    the JAX package's factorization errors."""
    if model_axis < 1:
        raise ValueError(
            f"cannot build a mesh with model_axis={model_axis}: every mesh "
            f"axis must be >= 1 (got {n} devices)")
    if client_axis is None:
        client_axis = n // model_axis
    if client_axis < 1 or client_axis * model_axis != n:
        raise ValueError(
            f"cannot build a [{client_axis}, {model_axis}] "
            f"({axis_names[0]} x {axis_names[1]}) mesh from {n} devices: "
            f"the axes must be >= 1 and their product must equal the "
            f"device count — pass axis sizes that factor {n}, or a "
            f"matching devices= subset")
    return client_axis, model_axis


def check_two_level_factors(group_axis: int, client_axis: Optional[int],
                            n: int) -> Tuple[int, int]:
    """The ``[groups, clients]`` axis sizes over ``n`` devices (ranks), or
    the JAX package's factorization errors."""
    if group_axis < 1:
        raise ValueError(
            f"cannot build a two-level mesh with group_axis={group_axis}: "
            f"the groups axis must be >= 1 (got {n} devices)")
    if client_axis is None:
        client_axis = n // group_axis
    if client_axis < 1 or group_axis * client_axis != n:
        raise ValueError(
            f"cannot build a [{group_axis}, {client_axis}] two-level mesh "
            f"from {n} devices: the axes must be >= 1 and their product "
            f"must equal the device count — the groups axis must divide "
            f"{n} (pass a client_axis that factors it, or a matching "
            f"devices= subset)")
    return group_axis, client_axis


def _check_world(sizes, n: int) -> None:
    world = rank_and_world()[1]
    if n != world:
        raise ValueError(
            f"a [{', '.join(map(str, sizes))}] mesh needs {n} ranks, one a "
            f"position; this run has {world}")


def make_mesh(client_axis: Optional[int] = None, model_axis: int = 1,
              devices=None, axis_names=("clients", "model"),
              device=None) -> Mesh:
    """The ``[clients, model]`` mesh over the world's ranks (``devices``:
    their count or a sequence of them, for the factorization check).

    Defaults: every rank on the clients axis.  The model axis takes
    contiguous ranks (rank ``r`` is client block ``r // model_axis``,
    model shard ``r % model_axis``), each axis its subgroup;
    `tp_shard_params` places parameters on it."""
    n = _n_devices(devices)
    client_axis, model_axis = check_mesh_factors(client_axis, model_axis, n,
                                                 axis_names)
    _check_world((client_axis, model_axis), n)
    return Mesh({axis_names[0]: client_axis, axis_names[1]: model_axis},
                device=device)


def make_two_level_mesh(group_axis: int, client_axis: Optional[int] = None,
                        devices=None, device=None) -> Mesh:
    """The ``[groups, clients]`` mesh of hierarchical FL: group ``g`` is the
    ranks ``g·C .. g·C + C - 1``; the group tier reduces over each row's
    ``clients`` subgroup, the global tier over each column's ``groups``
    subgroup."""
    n = _n_devices(devices)
    group_axis, client_axis = check_two_level_factors(group_axis,
                                                      client_axis, n)
    _check_world((group_axis, client_axis), n)
    return Mesh({"groups": group_axis, "clients": client_axis},
                device=device)


def make_sp_mesh(n_clients: int, n_sequence: int, devices=None,
                 device=None) -> Mesh:
    """The ``[clients, sequence]`` mesh of sequence-parallel FedAvg over
    the world's ranks: the sequence axis takes contiguous ranks (rank
    ``r`` is client block ``r // n_sequence``, sequence block ``r %
    n_sequence``), the latency-critical ring on neighbours, as the JAX
    package lays its devices."""
    n = _n_devices(devices)
    if n_clients * n_sequence != n:
        raise ValueError(f"mesh {n_clients}x{n_sequence} != {n} devices")
    _check_world((n_clients, n_sequence), n)
    return Mesh({"clients": n_clients, "sequence": n_sequence},
                device=device)


def make_model_mesh(num_shards: int) -> Optional[List[torch.device]]:
    """One visible CUDA device per shard of the sharded spine, or None when
    fewer than ``num_shards`` exist — the spine then keeps every shard on
    its default device (same math, no per-device memory split), as the
    JAX package does on a one-device host."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if torch.cuda.device_count() < num_shards:
        return None
    return [torch.device("cuda", i) for i in range(num_shards)]


def client_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape["clients"]


class Shard(dict):
    """A rank's rows of a sharded tree (``global_rows`` the whole
    cohort's; ``spec`` its axes).  Staging it again passes it through."""

    def __init__(self, items, spec, global_rows: Optional[int] = None):
        super().__init__(items)
        self.spec = spec
        self.global_rows = global_rows


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def stage_global(tree, mesh: Optional[Mesh], spec=None):
    """Host data as the rank feeds it to a mesh step.

    ``spec=None`` replicates: the tree (a plain dict) on the rank's
    device.  ``"clients"``
    (or ``("clients",)``) takes the rank's block of rows of every leaf's
    leading axis; ``("groups", "clients")`` takes its group's row of the
    leading axis and its block of the second.  Trees that are not dicts
    (seed words, keys) pass through, and so does a tree staged already."""
    if mesh is None or not isinstance(tree, dict) or isinstance(tree, Shard):
        return tree
    axes = (spec,) if isinstance(spec, str) else tuple(spec or ())
    if not axes:
        return {k: _as_tensor(v).to(mesh.device) for k, v in tree.items()}
    if axes == ("groups", "clients"):
        g = mesh.axis_index("groups")
        tree = {k: _as_tensor(v)[g] for k, v in tree.items()}
    elif axes != ("clients",):
        raise ValueError(f"unknown staging spec {spec!r}")
    d, c = mesh.shape["clients"], mesh.axis_index("clients")
    rows = next(iter(tree.values())).shape[0]
    if rows % d:
        raise ValueError(
            f"cohort size {rows} not divisible by the mesh clients axis "
            f"({d}); pad the cohort (gather_cohort pad_to=) to a multiple "
            f"of the device count")
    lo, hi = c * rows // d, (c + 1) * rows // d
    return Shard({k: _as_tensor(v)[lo:hi].to(mesh.device)
                  for k, v in tree.items()}, axes, global_rows=rows)


def broadcast_params(params, mesh: Optional[Mesh]):
    """Rank 0's params on every rank (once, at the start of a run, so the
    ranks cannot start apart)."""
    if mesh is None:
        return params
    return mesh.broadcast({k: v.to(mesh.device).contiguous()
                           for k, v in params.items()})


# ---------------------------------------------------------------------------
# tensor and expert parallelism: placements
# ---------------------------------------------------------------------------

# what a model whose placement shards a leaf outside the layers that
# compute on shards raises, by ROADMAP item
TP_UNPORTED = ("ROADMAP Queue 1 item 12: tensor parallelism over this "
               "layer is not ported; the port computes on shards in the "
               "LR and transformer Dense, DenseGeneral and Embed layers "
               "and the Switch MoE experts only")


class Placement:
    """Where a tree's leaves lie on one mesh axis: ``dims[name]`` is the
    dim a leaf is sharded on (its blocks in the order of the axis's
    coordinates) or None (replicated); ``shapes`` the whole leaves'.

    ``spec(name)`` is the leaf's sharding in the JAX package's
    ``PartitionSpec`` form (``(None, "model")``; ``()`` replicated), which
    the tests hold against JAX's ``.sharding.spec``.  ``shard(tree)`` takes
    this rank's blocks (a leaf already a block passes), ``gather(tree)``
    joins every rank's blocks back into the whole tree in its leaf order,
    so every rank then holds the same bytes."""

    def __init__(self, mesh: Mesh, axis: str, dims: Dict[str, Optional[int]],
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.axis = mesh, axis
        self.size = mesh.shape[axis]
        self.index = mesh.coords[axis]
        self.dims = dict(dims)
        self.shapes = {k: tuple(s) for k, s in shapes.items()}

    @property
    def sharded(self) -> List[str]:
        return [k for k, d in self.dims.items() if d is not None]

    def spec(self, name: str) -> Tuple:
        dim = self.dims[name]
        if dim is None:
            return ()
        out = [None] * len(self.shapes[name])
        out[dim] = self.axis
        return tuple(out)

    def block_shape(self, name: str) -> Tuple[int, ...]:
        shape = list(self.shapes[name])
        dim = self.dims[name]
        if dim is not None:
            shape[dim] //= self.size
        return tuple(shape)

    def shard(self, tree):
        out = {}
        for k, v in tree.items():
            dim = self.dims.get(k)
            if dim is None or tuple(v.shape) == self.block_shape(k):
                out[k] = v
            elif tuple(v.shape) == self.shapes[k]:
                w = self.shapes[k][dim] // self.size
                out[k] = v.narrow(dim, self.index * w, w).contiguous()
            else:
                raise ValueError(
                    f"{k}: shape {tuple(v.shape)} is neither the whole "
                    f"leaf {self.shapes[k]} nor its block "
                    f"{self.block_shape(k)}")
        return out

    def gather(self, tree):
        """The whole tree from every rank's blocks (one ``all_gather`` a
        dtype over the axis)."""
        names = [k for k in self.sharded if k in tree]
        if not names:
            return dict(tree)
        blocks = {k: tree[k] for k in names}
        whole = {}
        for keys, flat in _by_dtype(blocks):
            parts = [_split(keys, p, blocks)
                     for p in self.mesh._gather_flat(flat, self.axis)]
            whole.update({k: torch.cat([p[k] for p in parts],
                                       dim=self.dims[k]) for k in keys})
        return {k: whole.get(k, v) for k, v in tree.items()}

    def sq_norm(self, tree) -> torch.Tensor:
        """The squared global norm of a tree of blocks: the replicated
        leaves counted once, the blocks summed over the axis."""
        rep = [torch.sum(torch.square(v)) for k, v in tree.items()
               if self.dims.get(k) is None]
        part = [torch.sum(torch.square(v)) for k, v in tree.items()
                if self.dims.get(k) is not None]
        total = sum(rep, torch.zeros((), device=self.mesh.device))
        if part:
            total = total + self.mesh.axis(self.axis).sum_no_grad(sum(part))
        return total

    def check(self, model) -> None:
        """Raise unless ``model`` computes on every sharded leaf: its class
        says so (``computes_on_shards``), and no leaf of a module outside
        the ported layers is sharded."""
        if not self.sharded:
            return
        if not getattr(model, "computes_on_shards", False):
            raise NotImplementedError(
                f"{type(model).__name__}: the placement shards "
                f"{self.sharded[:4]} on {self.axis!r}, and the model does "
                f"not compute on shards ({TP_UNPORTED})")


def tp_shard_params(params, mesh: Mesh, axis: str = "model",
                    min_size: int = 4096):
    """The JAX package's tensor-parallel placement rule (JAX
    ``mesh.py:98-151``), as this rank's shards and their `Placement`:

    * a 2-D kernel shards its output dim when it divides by the axis size
      n and the leaf has at least ``min_size`` elements;
    * a 3-D kernel with at least ``min_size`` elements shards its heads:
      at dim 1 when ``d0 > max(d1, d2)`` (``[d_model, H, dh]``, an
      in-projection), at dim 0 when ``d2 > max(d0, d1)`` (``[H, dh,
      d_model]``, the out-projection), when that dim divides by n;
    * everything else is replicated (a ``[k, c_in, c_out]`` Conv1D-like
      kernel included).

    ``params``: a flat dict (``"attn_0/query/kernel"``)."""
    n = mesh.shape[axis]
    dims: Dict[str, Optional[int]] = {}
    for k, x in params.items():
        nd, size, dim = x.dim(), x.numel(), None
        if nd == 2 and x.shape[-1] % n == 0 and size >= min_size:
            dim = 1
        elif nd == 3 and size >= min_size:
            d0, d1, d2 = x.shape
            if d0 > max(d1, d2):
                dim = 1
            elif d2 > max(d0, d1):
                dim = 0
            if dim is not None and x.shape[dim] % n:
                dim = None
        dims[k] = dim
    placement = Placement(mesh, axis, dims,
                          {k: tuple(v.shape) for k, v in params.items()})
    return placement.shard(params), placement
