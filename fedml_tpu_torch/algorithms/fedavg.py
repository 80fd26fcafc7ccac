"""FedAvg — the standalone round loop (port of
``fedml_tpu/algorithms/fedavg.py``).

Each round: seeded client sampling, the cohort step (local SGD per client
+ aggregate), then an evaluation over all clients every
``frequency_of_the_test`` rounds and on the last one.  Three ways to run
the rounds, chosen as the JAX package chooses them:

* the device-resident round, for the base cohort step whenever the
  stacked train split fits the device-data budget (4 GiB, or
  ``FEDML_TPU_DEVICE_DATA_BYTES``): the split is staged on the device once
  and each round gathers its cohort there by ids (on a CUDA device a
  captured CUDA graph, `parallel.cohort.GraphedRounds`);
* scanned rounds, ``rounds_per_dispatch = K > 1`` on that path without a
  checkpointer: K rounds per call, chunks ending at evaluation rounds;
* otherwise the host gather, one cohort copied to the device a round.

``mesh=`` (`parallel.mesh.Mesh`) shards each round's cohort over the
mesh's ``clients`` axis, one rank a position: the host loop always (no
resident split, no CUDA graph), the cohort gathered on the host and each
rank's block of rows staged to its device, the aggregate and the
evaluation's sums reduced over the ranks.  Rank 0's params are broadcast
once at the start, so the ranks cannot start apart.

A `utils.checkpoint.RoundCheckpointer` saves (params, round key, round,
and a stateful algorithm's ``_extra_state``) on its cadence; a run given
one resumes from its latest step and continues bit for bit as the
uninterrupted run would.

The seams the stateful algorithms use, as in the JAX package:

* ``local_train`` (constructor): another client trainer, which keeps
  every fast path (FedProx's proximal term);
* ``_server_update(prev_params, w_avg) -> params``: a server step after
  each round's aggregate, outside the round (and outside its CUDA graph);
  the scanned path is refused when it is set (FedOpt);
* ``_device_round_override``: a device round of the
  ``make_device_round`` signature that replaces the base one, so a
  custom round still rides the resident split (FedNova; on a CUDA device
  it is one captured graph whose state tensors the graph updates in
  place);
* ``_extra_state`` / ``_extra_state_template`` / ``_load_extra_state``:
  server state that rides the round checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data.stacking import (FederatedData, gather_cohort,
                                           to_device)
from fedml_tpu_torch.device import resolve_device, synchronize
from fedml_tpu_torch.parallel.cohort import (bcast, cohort_eval,
                                             make_cohort_step,
                                             make_device_round,
                                             make_scanned_rounds,
                                             pad_clients)
from fedml_tpu_torch.parallel.mesh import broadcast_params, stage_global
from fedml_tpu_torch.trainer.local_sgd import make_evaluator, make_local_trainer
from fedml_tpu_torch.trainer.workload import Workload, make_client_optimizer
from fedml_tpu_torch.utils.metrics import stats_from_metrics

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FedAvgConfig:
    comm_round: int = 10
    client_num_per_round: int = 10
    epochs: int = 1
    batch_size: int = 10
    lr: float = 0.03
    client_optimizer: str = "sgd"
    wd: float = 0.0
    frequency_of_the_test: int = 5
    seed: int = 0
    rounds_per_dispatch: int = 1
    client_axis: str = "vmap"
    eval_chunk_clients: int = 1024

    def __post_init__(self):
        if self.rounds_per_dispatch < 1:
            raise ValueError(f"rounds_per_dispatch must be >= 1, got "
                             f"{self.rounds_per_dispatch}")


DEVICE_DATA_BUDGET = 4 << 30     # bytes; FEDML_TPU_DEVICE_DATA_BYTES overrides


def device_data_budget() -> int:
    return int(os.environ.get("FEDML_TPU_DEVICE_DATA_BYTES",
                              str(DEVICE_DATA_BUDGET)))


def split_nbytes(stacked) -> int:
    return sum(np.asarray(v).nbytes for v in stacked.values())


def pad_ids(ids, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """A round's ids padded to the cohort size ``m`` (padding aliases
    client 0) and the 1/0 live mask of the real slots."""
    padded = np.zeros(m, np.int64)
    live = np.zeros(m, np.float32)
    padded[:len(ids)] = ids
    live[:len(ids)] = 1.0
    return padded, live


def sweep_eval_chunks(stacked, chunk: int, run_chunk, device):
    """Slice the stacked client axis into [chunk]-row pieces (the last one
    zero-padded to the chunk size), call ``run_chunk(part, lo)`` on each
    and sum the metric dicts, which are exact under chunking."""
    total = None
    n_clients = stacked["num_samples"].shape[0]
    for lo in range(0, n_clients, chunk):
        part = to_device({k: v[lo:lo + chunk] for k, v in stacked.items()},
                         device)
        m = run_chunk(pad_clients(part, chunk), lo)
        total = m if total is None else {k: total[k] + m[k] for k in total}
    return total


def evaluate_global(eval_cohort, data: FederatedData, params: Tree,
                    chunk: int, device, resident=None) -> Dict[str, float]:
    """Weighted train/test metrics of ``params`` over all clients, swept in
    chunks of ``chunk`` clients when the corpus is larger.  ``resident(split,
    stacked)`` may return the split already on the device (else None)."""
    out: Dict[str, float] = {}
    for split, stacked in (("train", data.train), ("test", data.test)):
        if stacked is None:
            continue
        if chunk and stacked["num_samples"].shape[0] > chunk:
            m = sweep_eval_chunks(
                stacked, chunk, lambda part, lo: eval_cohort(params, part),
                device)
        else:
            batch = resident(split, stacked) if resident else None
            m = eval_cohort(params, batch if batch is not None
                            else to_device(stacked, device))
        out.update(stats_from_metrics(m, prefix=f"{split}_"))
    return out


def round_keys(seed: int, drew_init: bool) -> Iterator[prng.Key]:
    """The round keys of the JAX package's ``FedAvg.run``: from
    ``key(seed)``, one ``split`` for the init when the run draws its own
    weights, then one ``split`` per round."""
    rng = prng.key(seed)
    if drew_init:
        rng, _ = prng.split(rng)
    while True:
        rng, round_key = prng.split(rng)
        yield round_key


def round_seed_words(seed: int, round_idx: int,
                     drew_init: bool = True) -> Tuple[int, int]:
    """The two int32 words that key one round's defense noise: the first
    two words of that round's key, as the JAX package's fused aggregate
    takes them."""
    keys = round_keys(seed, drew_init)
    for _ in range(round_idx):
        next(keys)
    return prng.key_words_int32(next(keys))


# -- stacked per-client persistent state -----------------------------------
# Algorithms with per-client state that outlives a round (SCAFFOLD's
# control variates, Ditto's personal models, FedDyn's corrections) keep it
# as one stacked tree [client_num_in_total, ...] of host numpy buffers, as
# the JAX package does: only the sampled cohort's rows go to the device
# each round.  Padded cohort slots alias client 0; round steps freeze them
# through the live mask, and the scatter writes live rows only.

def zeros_client_state(template: Tree, client_num: int) -> Dict[str, np.ndarray]:
    """A zeroed stacked host state, one row per client, shaped like
    ``template``."""
    return {k: np.zeros((client_num,) + tuple(v.shape),
                        str(v.dtype).replace("torch.", ""))
            for k, v in template.items()}


def gather_client_rows(stacked: Dict[str, np.ndarray], ids, pad_to: int,
                       device) -> Tree:
    """The cohort's rows of a stacked host state as device tensors, the id
    vector zero-padded to the cohort's width."""
    padded = np.zeros(pad_to, np.int64)
    padded[:len(ids)] = np.asarray(ids, np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v[padded])).to(device)
            for k, v in stacked.items()}


def scatter_client_rows(stacked: Dict[str, np.ndarray], ids,
                        new_rows: Tree) -> Dict[str, np.ndarray]:
    """Write the live cohort rows back into the stacked host state in
    place (padded rows are dropped); returns the same buffers."""
    idx = np.asarray(ids, np.int64)
    for k, v in stacked.items():
        v[idx] = new_rows[k][:len(idx)].detach().cpu().numpy()
    return stacked


def batch_leaves(cohort) -> Dict[str, torch.Tensor]:
    """A cohort's data leaves, without ``num_samples``."""
    return {k: v for k, v in cohort.items() if k != "num_samples"}


def round_key_of(seed_words) -> prng.Key:
    """The round key back from its two int32 seed words."""
    return (int(seed_words[0]) & 0xFFFFFFFF, int(seed_words[1]) & 0xFFFFFFFF)


def mesh_device(mesh, device):
    """The device of a run: the mesh rank's, which ``device`` may name the
    kind of, or ``device`` off a mesh."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and \
            torch.device(str(device)).type != mesh.device.type:
        raise ValueError(f"device={device} differs from the mesh rank's "
                         f"{mesh.device}")
    return mesh.device


class FedAvg:
    def __init__(self, workload: Workload, data: FederatedData,
                 config: FedAvgConfig, sink=None, device=None,
                 local_train=None, mesh=None):
        self.workload = workload
        self.data = data
        self.cfg = config
        self.sink = sink  # optional MetricsSink
        self.mesh = mesh
        if mesh is not None:
            n_dev = mesh.shape["clients"]
            if config.client_num_per_round % n_dev:
                raise ValueError(
                    f"client_num_per_round={config.client_num_per_round} "
                    f"must be a multiple of the mesh clients axis ({n_dev})")
        self.device = mesh_device(mesh, device)
        if local_train is None:
            opt = make_client_optimizer(config.client_optimizer, config.lr,
                                        config.wd)
            local_train = make_local_trainer(workload, opt, config.epochs)
        self._local_train = local_train
        self.cohort_step = make_cohort_step(self._local_train,
                                            client_axis=config.client_axis,
                                            mesh=mesh)
        # the device-resident path serves only this step (or an override);
        # subclasses that replace cohort_step (the defenses, secure rounds,
        # per-client state) keep the loop
        self._base_cohort_step = self.cohort_step
        # server_update(prev_params, w_avg) -> new_params, after each round
        self._server_update = None
        # a custom device round of make_device_round's signature
        self._device_round_override = None
        self._device_round = None
        self._scanned_rounds = None
        self._train_dev: Optional[Dict[str, torch.Tensor]] = None
        self._test_dev: Optional[Dict[str, torch.Tensor]] = None
        self.evaluate = make_evaluator(workload)
        self._eval_cohort = cohort_eval(self.evaluate, mesh=mesh)
        self.history: List[Dict[str, Any]] = []
        self.round_times: List[float] = []
        # the mesh whose ranks all run this loop (``mesh``, or a round
        # that brings its own: the sequence mesh, the wave mesh), and the
        # ms each round spent in its collectives
        self.rank_mesh = mesh
        self.collective_times: List[float] = []
        # ... and of those the ring shifts' (the sequence mesh)
        self.p2p_times: List[float] = []

    def _sample_round(self, round_idx: int):
        return sample_clients(round_idx, self.data.client_num,
                              self.cfg.client_num_per_round)

    def init_params(self) -> Tree:
        """Fresh weights from ``cfg.seed``, drawn on the CPU, so a seed
        gives the same init on every device."""
        return self.workload.init(torch.Generator().manual_seed(self.cfg.seed),
                                  self.device)

    # -- checkpoint hooks (a stateful server overrides the extra state) -----
    def _extra_state(self) -> Dict[str, Any]:
        return {}

    def _extra_state_template(self, params: Tree) -> Dict[str, Any]:
        return {}

    def _load_extra_state(self, extra) -> None:
        pass

    def _ckpt_state(self, params: Tree, rng: prng.Key, round_idx: int):
        state = {"params": params, "rng": np.asarray(rng, np.uint32),
                 "round": int(round_idx)}
        extra = self._extra_state()
        if extra:
            state["extra"] = extra
        return state

    def _maybe_resume(self, checkpointer, params: Tree, rng: prng.Key):
        """(params, round key, next round) from the latest round
        checkpoint (and the extra state loaded), or the inputs and round
        0 when there is none."""
        if checkpointer is None or checkpointer.latest_round() is None:
            return params, rng, 0
        template = {"params": params, "rng": np.asarray(rng, np.uint32),
                    "round": 0}
        extra_t = self._extra_state_template(params)
        if extra_t:
            template["extra"] = extra_t
        try:
            state = checkpointer.restore(like=template)
        except ValueError:
            # the snapshot's extra state has another layout (an older
            # snapshot, or another server optimizer): restore untemplated
            # and let _load_extra_state accept it or refuse it by name
            state = checkpointer.restore()
            state["params"] = {k: torch.as_tensor(v).to(
                device=params[k].device, dtype=params[k].dtype)
                for k, v in state["params"].items()}
        if "extra" in state:
            self._load_extra_state(state["extra"])
        logger.info("resumed from round %d (%s)", state["round"],
                    checkpointer.ckpt_dir)
        rng = tuple(int(w) for w in state["rng"])
        return state["params"], rng, int(state["round"]) + 1

    # -- the round loop ------------------------------------------------------
    def run(self, params: Optional[Tree] = None, checkpointer=None) -> Tree:
        cfg = self.cfg
        rng = prng.key(cfg.seed)
        if params is None:
            rng, _ = prng.split(rng)     # the JAX run's init key
            params = self.init_params()
        params = {k: v.to(self.device) for k, v in params.items()}
        params, rng, start_round = self._maybe_resume(checkpointer, params,
                                                      rng)
        params = broadcast_params(params, self.mesh)
        use_device_data = self._uses_device_data()
        if use_device_data and cfg.rounds_per_dispatch > 1 \
                and checkpointer is None and self._server_update is None \
                and self.cohort_step is self._base_cohort_step:
            return self._run_scanned(params, rng, start_round)
        for round_idx in range(start_round, cfg.comm_round):
            t0 = time.perf_counter()
            c0 = self._collective_ms()
            rng, round_key = prng.split(rng)
            params = self.run_round(params, round_idx,
                                    prng.key_words_int32(round_key),
                                    use_device_data)
            synchronize(self.device)
            round_s = time.perf_counter() - t0
            self.round_times.append(round_s)
            self._count_collectives(c0)
            self._maybe_eval(params, round_idx, round_s)
            if checkpointer is not None:
                checkpointer.maybe_save(
                    round_idx,
                    lambda: self._ckpt_state(params, rng, round_idx),
                    last_round=round_idx == cfg.comm_round - 1)
        if checkpointer is not None:
            # an async save must be on disk (or its error raised) before
            # the run reports success
            checkpointer.flush()
        return self._own(params)

    def _collective_ms(self):
        """(all collectives', ring shifts') ms so far on the rank mesh."""
        m = self.rank_mesh
        return (0.0, 0.0) if m is None else (m.collective_ms(),
                                             m.collective_ms("p2p"))

    def _count_collectives(self, before) -> None:
        if self.rank_mesh is not None:
            now = self._collective_ms()
            self.collective_times.append(now[0] - before[0])
            self.p2p_times.append(now[1] - before[1])

    def _uses_device_data(self) -> bool:
        """Whether the rounds take the device-resident path: off a mesh,
        the base cohort step or a device-round override, with the train
        split staged on the device (it is staged here)."""
        return (self.mesh is None
                and (self.cohort_step is self._base_cohort_step
                     or self._device_round_override is not None)
                and self._stage_train_on_device())

    def run_round(self, params: Tree, round_idx: int, words,
                  use_device_data: bool) -> Tree:
        """One round of the loop: the round's cohort, the device round or
        the host gather and cohort step, then the server update."""
        ids = self._sample_round(round_idx)
        prev = params
        if self._server_update is not None:
            # a graphed round overwrites its static params in place
            prev = {k: v.clone() for k, v in params.items()}
        if use_device_data:
            padded, live = pad_ids(ids, self.cfg.client_num_per_round)
            params, _ = self._device_round(params, self._train_dev,
                                           padded, live, words)
        else:
            params, _ = self.cohort_step(params, self._gather(ids), words)
        if self._server_update is not None:
            params = self._server_update(prev, params)
        return params

    def _state_device(self):
        """Where a stateful round's gathered rows go: the host for a mesh
        step, which stages each rank's block, else the run's device."""
        return "cpu" if self.mesh is not None else self.device

    def _gather(self, ids):
        """The round's cohort, padded to the cohort size, on the device; on
        a mesh gathered on the host and staged as this rank's rows."""
        return stage_global(
            gather_cohort(self.data.train, ids,
                          pad_to=self.cfg.client_num_per_round,
                          device=self._state_device()),
            self.mesh, "clients")

    def _own(self, params: Tree) -> Tree:
        """``params`` as tensors of the caller's: a copy when they are a
        graphed round's static buffers, which the next replay
        overwrites."""
        graph = getattr(self._device_round, "graph", None) or getattr(
            self._scanned_rounds, "graph", None)
        if graph is not None and params is graph.params:
            return {k: v.clone() for k, v in params.items()}
        return params

    def _maybe_eval(self, params: Tree, round_idx: int,
                    round_s: float) -> None:
        cfg = self.cfg
        if (round_idx % cfg.frequency_of_the_test == 0
                or round_idx == cfg.comm_round - 1):
            stats = self.evaluate_global(self._own(params))
            stats.update(round=round_idx, round_s=round_s)
            logger.info("round %d: %s", round_idx, stats)
            self.history.append(stats)
            if self.sink is not None:
                self.sink.log(stats, step=round_idx)

    def _run_scanned(self, params: Tree, rng: prng.Key,
                     start_round: int) -> Tree:
        """K rounds per call over the resident split, chunk boundaries at
        evaluation rounds; one key ``split`` per chunk and ``fold_in(chunk
        key, k)`` for its k-th round (the JAX package's schedule; the base
        cohort step draws no randomness, so the params equal the loop's)."""
        cfg = self.cfg
        m = cfg.client_num_per_round
        if self._scanned_rounds is None:
            self._scanned_rounds = make_scanned_rounds(
                self._local_train, m, client_axis=cfg.client_axis,
                max_rounds=cfg.rounds_per_dispatch)
        round_idx = start_round
        while round_idx < cfg.comm_round:
            nxt = round_idx
            while not (nxt % cfg.frequency_of_the_test == 0
                       or nxt == cfg.comm_round - 1):
                nxt += 1
            k_rounds = min(nxt - round_idx + 1, cfg.rounds_per_dispatch)
            ids = np.zeros((k_rounds, m), np.int64)
            live = np.zeros((k_rounds, m), np.float32)
            for k in range(k_rounds):
                ids[k], live[k] = pad_ids(self._sample_round(round_idx + k),
                                          m)
            rng, chunk_key = prng.split(rng)
            words = [prng.key_words_int32(prng.fold_in(chunk_key, k))
                     for k in range(k_rounds)]
            t0 = time.perf_counter()
            params, _ = self._scanned_rounds(params, self._train_dev, ids,
                                             live, words)
            synchronize(self.device)
            round_s = (time.perf_counter() - t0) / k_rounds
            self.round_times.extend([round_s] * k_rounds)
            round_idx += k_rounds
            self._maybe_eval(params, round_idx - 1, round_s)
        return self._own(params)

    def _stage_train_on_device(self, budget_bytes: Optional[int] = None
                               ) -> bool:
        """Stage the stacked train split on the device once; False (the
        host gather) when it exceeds the device-data budget."""
        if self._train_dev is not None:
            return True
        budget = (budget_bytes if budget_bytes is not None
                  else device_data_budget())
        nbytes = split_nbytes(self.data.train)
        if nbytes > budget:
            logger.info("train set %.1f MB > device budget; using host "
                        "gather", nbytes / 1e6)
            return False
        if self._device_round is None:
            self._device_round = (self._device_round_override
                                  or make_device_round(
                                      self._local_train,
                                      self.cfg.client_num_per_round,
                                      client_axis=self.cfg.client_axis))
        self._train_dev = to_device(self.data.train, self.device)
        if self._train_dev["x"].device.type != self.device.type:
            raise RuntimeError(f"the train split was staged on "
                               f"{self._train_dev['x'].device}, not on "
                               f"{self.device}")
        return True

    def _fits_with_train(self, stacked) -> bool:
        """Whether ``stacked`` fits the device-data budget beside the
        resident train split."""
        return (split_nbytes(self.data.train) + split_nbytes(stacked)
                <= device_data_budget())

    def evaluate_global(self, params: Tree) -> Dict[str, float]:
        """Weighted train/test metrics over all clients, swept in chunks of
        ``eval_chunk_clients`` clients when the corpus is larger; otherwise
        on the resident train split (and the test split, kept on the
        device when it fits beside it)."""
        if self.mesh is not None:     # the mesh eval stages each block
            return evaluate_global(self._eval_cohort, self.data, params,
                                   self.cfg.eval_chunk_clients, "cpu")
        return evaluate_global(self._eval_cohort, self.data, params,
                               self.cfg.eval_chunk_clients, self.device,
                               resident=self._resident_split)

    def _resident_split(self, split: str, stacked):
        if self._train_dev is None:
            return None
        if split == "train":
            return self._train_dev
        if self._test_dev is None and self._fits_with_train(stacked):
            self._test_dev = to_device(stacked, self.device)
        return self._test_dev
