"""Mega-cohort cross-device federation: client waves folded live into the
streaming mean (port of ``fedml_tpu/algorithms/cross_device.py``).

One round trains thousands of *sampled* clients without ever holding the
cohort:

* the seeded sampler picks the round's cohort: ``numpy`` (the reference's
  ``RandomState(round)`` chain, `core.sampling.sample_clients`) or ``jax``
  (the threefry permutation keyed by ``fold_in(fold_in(key(seed),
  0x5A4D50), round)``, `core.sampling.sample_clients_jax`); the two give
  different cohorts, so every metrics row names its sampler;
* `device_cohort.plan_waves` pads the cohort into static waves; each wave
  trains as one vmapped program on the card
  (`device_cohort.make_wave_fn`), its clients keyed by their global
  cohort slot;
* each wave's stacked updates fold into the `StreamingAggregator` at wave
  completion (`fold_wave`: slot by slot, in cohort order), so a
  wave-chunked round equals a single-wave round and server memory stays
  O(model) plus one wave;
* `device_cohort.WaveAdmission` screens each wave's summary (structure,
  finite, norm) before it folds;
* ``--local_alg {sgd,fedprox,scaffold,fednova}`` picks the per-client
  trainer inside the wave: fedprox the proximal local trainer; scaffold
  keeps its control variates as host-stacked per-client state, gathered
  and scattered per wave; fednova folds pseudo-params ``x - cum_grad /
  a_i`` and closes the round with the tau_eff step accumulated across
  waves.

* ``wave_adversary`` (JAX :90, :204-207, :376-411): seeded poisoned
  wave summaries, `robust.adversary.poison_wave_summary` on the wave's
  mean before admission; an admitted poisoned mean folds through the same
  stacked fold, broadcast to every slot;
* ``degrade`` (a `robust.degrade.ReliabilityTracker`, JAX :180-186,
  :308-316, :477-482, :582-583, :643-673): clients carrying
  participation debt (keyed ``client id + 1``) claim the head of the next
  round's sample (`merge_priority`), each wave's completion time feeds
  the latency history, and the tracker's state rides the checkpoint;
* ``ingest`` (a `comm.ingest.IngestPipeline`, JAX :187-200, :487-507,
  :627-629): the main thread keeps launching waves while the single fold
  worker runs admission → fold for the completed ones
  (``submit_wait``), drained before the finalize, so the round is
  bit-identical to the inline one.

Aggregation is stream-only by construction.  ``perf`` ledgers a line a
round (the ``wave`` phase, each completed wave an arrival on the critical
path, the wave program registered as ``wave_train``), ``health`` sketches
each admitted wave summary, ``slo`` evaluates once a round and
``controller`` paces the next round's cohort from the health line (the
sampler draws from the whole population; waves stay static-width);
``publish(params, version)`` hands each round's finalized global (the
engine's flat device dict) to serving, version ``round_idx + 1``.

``mesh`` (`parallel.mesh.Mesh`, one rank a position of its ``clients``
axis; JAX :99-155) shards each wave's training over the ranks
(`device_cohort.make_wave_fn`): the wave size must divide over the axis,
and SCAFFOLD and FedNova stay on one rank.  Sampling, the fold, the
finalize, evaluation and checkpoints run on every rank as on one (rank 0
writes), over the same gathered uploads, so the ranks' globals stay
byte-equal.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                               gather_client_rows,
                                               mesh_device, pad_ids,
                                               scatter_client_rows,
                                               zeros_client_state)
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.core.sampling import sample_clients, sample_clients_jax
from fedml_tpu_torch.core.stream_agg import StreamingAggregator
from fedml_tpu_torch.data.stacking import gather_cohort
from fedml_tpu_torch.device import synchronize
from fedml_tpu_torch.device_cohort import (WaveAdmission,
                                           make_scaffold_wave_fn,
                                           make_wave_fn, plan_waves)
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.parallel.cohort import gather_live_cohort, train_cohort
from fedml_tpu_torch.parallel.mesh import broadcast_params
from fedml_tpu_torch.robust.adversary import (parse_wave_adversary_spec,
                                              poison_wave_summary)
from fedml_tpu_torch.robust.degrade import merge_priority
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import make_client_optimizer
from fedml_tpu_torch.utils.journal import tree_crc

logger = logging.getLogger(__name__)

LOCAL_ALGS = ("sgd", "fedprox", "scaffold", "fednova")
SAMPLERS = ("numpy", "jax")
SAMPLER_SALT = 0x5A4D50        # the jax sampler's key: fold_in(key(seed), .)
AUTO_WAVE_MAX = 256            # wave_size 0: min(cohort, this)

def check_wave_mesh(local_alg: str, wave_size: int, n_dev: int) -> None:
    """JAX's gates on a wave mesh of ``n_dev`` ranks (JAX :116-137)."""
    if wave_size % n_dev:
        raise ValueError(
            f"--wave_size {wave_size} must be a multiple of the mesh "
            f"clients axis ({n_dev}): each rank trains an equal block of a "
            f"wave's slots")
    if local_alg in ("scaffold", "fednova"):
        raise ValueError(
            f"--local_alg {local_alg} rides the single-chip vmap wave "
            f"engine for now (its per-client state / normalized server "
            f"step need the stateful mesh wrap of "
            f"parallel/cohort.make_sharded_stateful_round); drop "
            f"--mesh_clients")


@dataclasses.dataclass
class CrossDeviceConfig(FedAvgConfig):
    wave_size: int = 0            # 0 = auto: min(cohort, 256)
    local_alg: str = "sgd"        # per-client trainer inside the wave
    sampler: str = "numpy"        # numpy (reference-bit-exact) | jax
    mu: float = 0.1               # fedprox proximal strength
    norm_clip: float = 0.0        # clip each update against the global
    agg_noise_std: float = 0.0    # weak-DP noise at finalize
    admission: str = "auto"       # auto/on: per-wave norm screen armed;
    #                               off: structure/finite only
    norm_screen_k: float = 6.0
    norm_screen_window: int = 64
    norm_screen_min_history: int = 8
    wave_adversary: str = ""      # "round:wave:kind[:param],...": seeded
    #                               poisoned wave summaries, pre-admission


class CrossDevice(FedAvg):
    """FedAvg's chassis (init, seeded key chain, chunked eval, checkpoint
    and resume) with the round replaced by the wave loop."""

    def __init__(self, workload, data, config: CrossDeviceConfig,
                 sink=None, device=None, mesh=None, server_opt=None,
                 perf=None, health=None, slo=None, publish=None,
                 controller=None, degrade=None, ingest=None):
        cfg = config
        if cfg.local_alg not in LOCAL_ALGS:
            raise ValueError(f"--local_alg must be one of {LOCAL_ALGS}, "
                             f"got {cfg.local_alg!r}")
        if cfg.sampler not in SAMPLERS:
            raise ValueError(f"--sampler must be one of {SAMPLERS}, "
                             f"got {cfg.sampler!r}")
        n_dev = mesh.shape["clients"] if mesh is not None else 1
        if cfg.wave_size == 0:
            # a copy: a caller reusing one config keeps its own value
            auto = min(max(cfg.client_num_per_round, 1), AUTO_WAVE_MAX)
            cfg = config = dataclasses.replace(
                cfg, wave_size=-(-auto // n_dev) * n_dev)
        if cfg.wave_size < 1:
            raise ValueError(f"--wave_size must be >= 1, got {cfg.wave_size}")
        if mesh is not None:
            check_wave_mesh(cfg.local_alg, cfg.wave_size, n_dev)
        if cfg.local_alg in ("scaffold", "fednova") \
                and cfg.client_axis != "vmap":
            raise ValueError(f"--client_axis is not wired into the "
                             f"{cfg.local_alg} wave; drop the flag")
        if cfg.local_alg == "scaffold" and cfg.client_optimizer != "sgd":
            raise ValueError(
                "scaffold's local update is plain SGD with control-variate "
                "correction; --client_optimizer sgd only (Karimireddy'20)")
        if cfg.local_alg == "scaffold" and workload.stateful:
            raise ValueError(
                "scaffold does not support stateful (BatchNorm) "
                "workloads: control variates over running statistics "
                "are undefined — use a GroupNorm model")
        if controller is not None and health is None:
            raise ValueError(
                "controller (--adaptive) requires the health observatory "
                "(--health): its decisions are a pure function of the "
                "per-round drift-alarm line")
        if server_opt is not None and cfg.local_alg == "fednova":
            raise ValueError(
                "--server_opt with --local_alg fednova is refused: "
                "fednova's tau_eff step IS a server update; stacking a "
                "second optimizer on top silently changes its normalized "
                "averaging semantics")
        # init, eval and checkpoints run as on one rank (mesh=None); the
        # mesh is the waves'
        super().__init__(workload, data, config, sink=sink,
                         device=mesh_device(mesh, device))
        self.wave_mesh = self.rank_mesh = mesh
        self.server_opt = server_opt
        self.degrade = degrade
        # the train-to-serve seam: each round's finalized global as
        # ``publish(params, version)``, version = round_idx + 1 so a
        # pre-published baseline can hold version 0
        self.publish = publish
        self.perf = perf
        self.health = health
        self.slo = slo
        self.controller = controller
        # the fold-side state (stream, admission, the local algorithm's
        # accumulators) belongs to the worker between the round's start
        # and its pre-finalize drain
        self.ingest = ingest
        self._wave_attacks = (parse_wave_adversary_spec(cfg.wave_adversary)
                              if cfg.wave_adversary else {})
        # bound at the first round (they need the params template)
        self.stream: Optional[StreamingAggregator] = None
        self.admission: Optional[WaveAdmission] = None
        # scaffold's per-client state (host-stacked)
        self.c_global: Optional[Tree] = None
        self.c_locals: Optional[Dict[str, np.ndarray]] = None
        reg = telemetry.get_registry()
        self._c_rounds = reg.counter("fedml_cohort_rounds_total")
        self._c_waves = reg.counter("fedml_cohort_waves_total")
        self._c_clients = reg.counter("fedml_cohort_clients_total")
        self._h_wave = reg.histogram("fedml_cohort_wave_seconds")
        self._h_fold = reg.histogram("fedml_cohort_fold_seconds")
        self._wave_fn = self._build_wave_fn(workload, cfg, mesh)
        if perf is not None:
            # the wave program is this engine's hot callable: the sentry
            # notes its signatures and (--device_obs) the compile ledger
            # and the FLOP count read it
            self._wave_fn = perf.instrument_jit("wave_train", self._wave_fn)

    # -- the wave program ----------------------------------------------------
    def _build_wave_fn(self, workload, cfg, mesh):
        if cfg.local_alg in ("sgd", "fedprox"):
            opt = make_client_optimizer(cfg.client_optimizer, cfg.lr, cfg.wd)
            local = make_local_trainer(
                workload, opt, cfg.epochs,
                prox_mu=cfg.mu if cfg.local_alg == "fedprox" else 0.0)

            def make_stacked(params, wave_data, seed_words, offset):
                stacked, _ = train_cohort(local, params, wave_data,
                                          seed_words, index_offset=offset,
                                          client_axis=cfg.client_axis)
                return stacked, {}

            return make_wave_fn(make_stacked, mesh=mesh)

        if cfg.local_alg == "fednova":
            # plain normalized averaging (momentum, prox and the gmf server
            # buffer off: algorithms/fednova.py carries the full variant);
            # tau_src = a_i
            from fedml_tpu_torch.algorithms.fednova import (
                FedNovaConfig, make_fednova_local_trainer)
            nova_local = make_fednova_local_trainer(workload, FedNovaConfig(
                lr=cfg.lr, epochs=cfg.epochs, wd=cfg.wd,
                batch_size=cfg.batch_size, seed=cfg.seed))

            def make_stacked(params, wave_data, seed_words, offset):
                _, aux = train_cohort(nova_local, params, wave_data,
                                      seed_words, index_offset=offset)
                a = torch.clamp_min(aux["a_i"], 1e-12)
                # pseudo-params y_i = x − cum_grad_i / a_i: their weighted
                # stream mean is x − Σ p_i d_i, so the one mean spine
                # serves Nova; the tau_eff step closes the round
                pseudo = {k: p[None] - aux["cum_grad"][k] / a.reshape(
                              (-1,) + (1,) * p.dim())
                          for k, p in params.items()}
                return pseudo, {"tau": aux["a_i"]}

            return make_wave_fn(make_stacked)

        from fedml_tpu_torch.algorithms.scaffold import make_scaffold_local
        return make_scaffold_wave_fn(
            make_scaffold_local(workload, cfg.lr, cfg.epochs), cfg.lr)

    # -- sampling ------------------------------------------------------------
    def _sample_round(self, round_idx: int) -> np.ndarray:
        """The round's cohort ids: ``numpy`` resamples from the round index
        alone (``--seed`` varies the init, never the schedule), ``jax`` from
        (seed, round); both re-derive the same cohorts on a resume."""
        cfg = self.cfg
        per = cfg.client_num_per_round
        if self.controller is not None:
            # the adaptive cohort lever is live here: the sampler draws
            # from the whole population and the waves pad to a static
            # width, so widening builds nothing new
            per = max(1, min(self.controller.cohort, self.data.client_num))
        if cfg.sampler == "jax":
            key = prng.fold_in(prng.fold_in(prng.key(cfg.seed),
                                            SAMPLER_SALT), round_idx)
            ids = sample_clients_jax(key, self.data.client_num, per)
        else:
            ids = sample_clients(round_idx, self.data.client_num, per)
        if self.degrade is not None:
            # indebted clients claim the cohort head; zero debt leaves
            # the draw untouched
            pri = [c - 1 for c in self.degrade.priority_clients(per)]
            if pri:
                ids = np.asarray(
                    merge_priority([int(c) for c in ids], pri, per),
                    dtype=np.int64)
        return ids

    # -- the round ------------------------------------------------------------
    def _ensure_bound(self, params: Tree) -> None:
        cfg = self.cfg
        if self.stream is None:
            perf = self.perf
            self.stream = StreamingAggregator(
                params, method="mean", kind="params",
                norm_clip=cfg.norm_clip, noise_std=cfg.agg_noise_std,
                seed=cfg.seed, device=self.device,
                sentry=perf.sentry if perf is not None else None,
                device_obs=perf.device if perf is not None else None)
            self.admission = WaveAdmission(
                _host(params), norm_k=cfg.norm_screen_k,
                norm_window=cfg.norm_screen_window,
                norm_min_history=cfg.norm_screen_min_history,
                norm_screen=cfg.admission != "off")
        if cfg.local_alg == "scaffold" and self.c_global is None:
            self.c_global = {k: torch.zeros_like(v)
                             for k, v in params.items()}
            self.c_locals = zeros_client_state(params, self.data.client_num)

    def _perf_phase(self, name: str, seconds: float) -> None:
        if self.perf is not None:
            self.perf.add_phase(name, seconds)

    def _gather_wave(self, wave, width: int):
        """The wave's cohort on the card: gathered from the resident train
        split when it is staged, else copied from the host."""
        if self._train_dev is not None:
            ids, live = pad_ids(wave.ids, width)
            return gather_live_cohort(
                self._train_dev, torch.as_tensor(ids, device=self.device),
                torch.as_tensor(live, device=self.device))
        return gather_cohort(self.data.train, wave.ids, pad_to=width,
                             device=self.device)

    def _fold_one(self, round_idx, wi, wave, stacked, w, mean, wave_weight,
                  aux_sums, new_c, c_delta, host_params, acc) -> None:
        """One completed wave: admission screen, stream fold, then the
        local algorithm's accumulation."""
        if wave_weight <= 0:
            # only weightless clients (all-pad, all-empty shards): folds as
            # weight 0, never a 0/0 in the normalizer
            return
        t0 = time.perf_counter()
        mean_host = _host(mean)
        attack = self._wave_attacks.get((round_idx, wi))
        if attack is not None:
            # poison the wave summary before admission: the screen and
            # the fold see the attacked mean
            mean_host = poison_wave_summary(attack, mean_host, host_params,
                                            seed=self.cfg.seed)
            logger.warning("round %d wave %d POISONED (%s:%g)", round_idx,
                           wi, attack.kind, attack.param)
        verdict = self.admission.screen(mean_host, host_params)
        self._perf_phase("admission", time.perf_counter() - t0)
        if not verdict.ok:
            logger.warning("round %d wave %d REJECTED (%s): %d clients' "
                           "work discarded", round_idx, wi, verdict.reason,
                           wave.n_live)
            if self.health is not None:
                self.health.observe_rejected(wi + 1, verdict.reason)
            return
        t0 = time.perf_counter()
        if attack is not None:
            # every member ships the attacked mean (the weighted mean of
            # identical rows is the row), through the same stacked fold
            stacked = {k: torch.as_tensor(mean_host[k]).to(
                device=s.device, dtype=s.dtype).expand(s.shape)
                for k, s in stacked.items()}
        self.stream.fold_wave(stacked, w.cpu())
        dt = time.perf_counter() - t0
        self._h_fold.observe(dt)
        self._perf_phase("fold", dt)
        acc["folded"] += 1
        acc["live"] += wave.n_live
        self._c_clients.inc(wave.n_live)
        if self.health is not None:
            t0 = time.perf_counter()
            self.health.observe_admitted(wi + 1, mean_host, wave_weight,
                                         norm=verdict.norm)
            self._perf_phase("health", time.perf_counter() - t0)
        if self.cfg.local_alg == "fednova":
            acc["tau"] += float(aux_sums["tau"])
        elif self.cfg.local_alg == "scaffold":
            # admitted waves only: a rejected wave's variates are discarded
            self.c_locals = scatter_client_rows(self.c_locals, wave.ids,
                                                new_c)
            acc["c_delta"] = (c_delta if acc["c_delta"] is None else
                              {k: acc["c_delta"][k] + c_delta[k]
                               for k in c_delta})

    def _run_round(self, params: Tree, ids, words, round_idx: int):
        cfg = self.cfg
        width = cfg.wave_size
        waves = plan_waves(ids, width)
        self._ensure_bound(params)
        self.admission.round_start()
        host_params = _host(params)
        if self.health is not None:
            self.health.round_start(round_idx, host_params,
                                    expected=range(1, len(waves) + 1))
        self.stream.reset(params)
        acc = {"tau": 0.0, "c_delta": None, "folded": 0, "live": 0}
        for wi, wave in enumerate(waves):
            if wave.n_live == 0:
                continue  # the empty-cohort edge: nothing sampled
            t0 = time.perf_counter()
            wave_data = self._gather_wave(wave, width)
            if cfg.local_alg == "scaffold":
                c_cohort = gather_client_rows(self.c_locals, wave.ids, width,
                                              self.device)
                (stacked, w, mean, total, new_c, c_delta,
                 _live) = self._wave_fn(params, wave_data, words,
                                        wave.offset, self.c_global, c_cohort)
                aux_sums = {}
            else:
                stacked, w, mean, total, aux_sums = self._wave_fn(
                    params, wave_data, words, wave.offset)
                new_c = c_delta = None
            wave_weight = float(total)   # blocks: the wave ran to the end
            dt = time.perf_counter() - t0
            self._c_waves.inc()
            self._h_wave.observe(dt)
            self._perf_phase("wave", dt)
            if self.degrade is not None:
                # every live client completed with the wave
                for cid in wave.ids:
                    self.degrade.observe_completion(int(cid) + 1, dt)
                    self.degrade.note_accept(int(cid) + 1)
            if self.perf is not None:
                # a completed wave is this regime's upload arrival on the
                # round's critical-path timeline
                self.perf.note_arrival()
            fold = functools.partial(
                self._fold_one, round_idx, wi, wave, stacked, w, mean,
                wave_weight, aux_sums, new_c, c_delta, host_params, acc)
            if self.ingest is not None:
                # a wave the server produced is never load-shed: the
                # bounded queue paces the launches instead
                self.ingest.submit_wait(0, fold)
            else:
                fold()
        if self.ingest is not None:
            # every queued fold lands before the finalize reads the stream
            t0 = time.perf_counter()
            self.ingest.drain()
            self._perf_phase("barrier_wait", time.perf_counter() - t0)

        if self.stream.count == 0:
            logger.warning("round %d: every wave empty or rejected; the "
                           "global is unchanged", round_idx)
            new_params = params
        else:
            t0 = time.perf_counter()
            new_params = self.stream.finalize(round_idx)
            self._perf_phase("fold", time.perf_counter() - t0)
            if cfg.local_alg == "fednova":
                # x+ = x − tau_eff·Σ p_i d_i, with the mean x − Σ p_i d_i
                tau_eff = acc["tau"] / self.stream.weight_total
                new_params = {
                    k: (p.to(torch.float32) - tau_eff
                        * (p.to(torch.float32)
                           - new_params[k].to(torch.float32))).to(p.dtype)
                    for k, p in params.items()}
            elif cfg.local_alg == "scaffold" and acc["c_delta"] is not None:
                # c+ = c + (|S|/N)·mean(c_i+ − c_i) = c + Σ delta / N
                n_total = float(self.data.client_num)
                self.c_global = {k: cg + acc["c_delta"][k] / n_total
                                 for k, cg in self.c_global.items()}
            if self.server_opt is not None:
                new_params = self.server_opt.apply(params, new_params,
                                                   round_idx)
        self._c_rounds.inc()
        if self.health is not None:
            self.health.round_end(round_idx, new_global=_host(new_params),
                                  cohort=len(ids), waves=len(waves),
                                  folded_waves=acc["folded"])
        return new_params, {"waves": len(waves),
                            "folded_waves": acc["folded"],
                            "clients": acc["live"]}

    # -- the run --------------------------------------------------------------
    def run(self, params: Optional[Tree] = None, checkpointer=None) -> Tree:
        cfg = self.cfg
        rng = prng.key(cfg.seed)
        if params is None:
            rng, _ = prng.split(rng)     # the JAX run's init key
            params = self.init_params()
        params = {k: v.to(self.device) for k, v in params.items()}
        params, rng, start_round = self._maybe_resume(checkpointer, params,
                                                      rng)
        params = broadcast_params(params, self.wave_mesh)
        self._stage_train_on_device()
        for round_idx in range(start_round, cfg.comm_round):
            t0 = time.perf_counter()
            c0 = self._collective_ms()
            if self.perf is not None:
                self.perf.round_start(round_idx)
            ids = self._sample_round(round_idx)
            rng, round_key = prng.split(rng)
            params, info = self._run_round(
                params, ids, prng.key_words_int32(round_key), round_idx)
            synchronize(self.device)
            if self.publish is not None:
                self.publish(params, round_idx + 1)
            decision = None
            if self.controller is not None:
                # the pacing verdict for the NEXT round, from this round's
                # health line, decided before the checkpoint so a resume
                # continues the same trajectory
                kw = ({"debt": self.degrade.max_debt()}
                      if self.degrade is not None else {})
                decision = self.controller.decide(
                    round_idx, self.health.last_line
                    if self.health is not None else None, **kw)
            round_s = time.perf_counter() - t0
            self.round_times.append(round_s)
            self._count_collectives(c0)
            if self.perf is not None:
                extra = dict(info)
                # the round's post-finalize global CRC (the checksum the
                # journal trusts): pipelined and inline twins compare it
                extra["global_crc"] = tree_crc(_host(params))
                if self.server_opt is not None:
                    extra["server_opt"] = self.server_opt.name
                if decision is not None:
                    extra["adapt"] = decision.as_ledger()
                self.perf.round_end(round_idx, cohort=len(ids),
                                    wave_size=cfg.wave_size, **extra)
            if self.slo is not None:
                self.slo.evaluate()
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == cfg.comm_round - 1):
                stats = self.evaluate_global(params)
                # provenance: which sampler and trainer made this curve
                stats.update(round=round_idx, round_s=round_s,
                             cohort=len(ids), waves=info["waves"],
                             folded_waves=info["folded_waves"],
                             wave_size=cfg.wave_size, sampler=cfg.sampler,
                             local_alg=cfg.local_alg)
                logger.info("round %d: %s", round_idx, stats)
                self.history.append(stats)
                if self.sink is not None:
                    self.sink.log(stats, step=round_idx)
            if checkpointer is not None:
                checkpointer.maybe_save(
                    round_idx,
                    lambda: self._ckpt_state(params, rng, round_idx),
                    last_round=round_idx == cfg.comm_round - 1)
        if checkpointer is not None:
            checkpointer.flush()
        if self.ingest is not None:
            self.ingest.stop()
        return params

    # -- checkpoint extra state (scaffold's variates, the server optimizer,
    # the reliability tracker) ----------------------------------------------
    def _extra_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.cfg.local_alg == "scaffold" and self.c_global is not None:
            out["scaffold"] = {"c_global": self.c_global,
                               "c_locals": self.c_locals}
        if self.server_opt is not None:
            out["srv_opt"] = self.server_opt.state_dict()
        if self.controller is not None:
            out["adapt"] = self.controller.state_dict()
        if self.degrade is not None:
            out["degrade"] = self.degrade.state_dict()
        return out

    def _extra_state_template(self, params: Tree) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.cfg.local_alg == "scaffold":
            out["scaffold"] = {
                "c_global": {k: torch.zeros_like(v)
                             for k, v in params.items()},
                "c_locals": zeros_client_state(params, self.data.client_num)}
        if self.server_opt is not None:
            out["srv_opt"] = self.server_opt.state_template()
        if self.controller is not None:
            out["adapt"] = self.controller.state_dict()
        if self.degrade is not None:
            out["degrade"] = self.degrade.state_dict()
        return out

    def _load_extra_state(self, extra) -> None:
        if self.cfg.local_alg == "scaffold" and "scaffold" in extra:
            self.c_global = {k: torch.as_tensor(v).to(self.device)
                             for k, v in extra["scaffold"]["c_global"].items()}
            self.c_locals = {k: np.asarray(v) for k, v in
                             extra["scaffold"]["c_locals"].items()}
        if self.server_opt is not None and "srv_opt" in extra:
            self.server_opt.load_state_dict(extra["srv_opt"])
        if self.controller is not None and "adapt" in extra:
            self.controller.load_state_dict(extra["adapt"])
        if self.degrade is not None and "degrade" in extra:
            self.degrade.load_state_dict(extra["degrade"])


def _host(tree: Tree) -> Dict[str, np.ndarray]:
    """Host copies in JAX's leaf order (the wave attacks draw in it)."""
    return {k: tree[k].detach().cpu().numpy() for k in tree_keys(tree)}
