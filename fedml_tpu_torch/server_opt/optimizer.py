"""The server-optimizer seam: a pluggable step over the streaming and
sharded finalize (port of ``fedml_tpu/server_opt/optimizer.py``).

The live server's finalize produces the cohort's weighted-mean model.  The
seam reads it as a pseudo-gradient (the FedOpt contract, Reddi et al.
2020)

    Δ = w_global − finalize(round)

and lets a ``ServerOptimizer`` apply it:

    plain     — the finalized tree verbatim, with zero arithmetic (a
                round trip ``w − 1.0·Δ`` is not bit-identical in f32).
    momentum  — optax-sgd's trace: ``t ← Δ + m·t;  w ← w − lr·t``.
    adam      — optax-adam's moments (b1, b2, eps, eps_root 0, the count
                incremented before the bias correction) on Δ.
    fedac     — FedAC (Yuan & Ma 2020) at server granularity: the global
                is the output iterate x^ag, the coupled x sequence is the
                optimizer's state, and Δ stands in for the local gradient:

                    x^md  = x/β + (1 − 1/β)·x^ag
                    x^ag' = x^md − lr·Δ
                    x'    = (1 − 1/α)·x + x^md/α − γ·Δ

                ``(α=1, β=1, γ=lr)`` collapses it onto the plain SGD step,
                the parity hook against ``algorithms/fedac.py``'s local
                form; ``fedac_mu > 0`` derives (γ, α, β) by the same
                coupling (``fedac.fedac_coupling``).

The state is O(model), zero-initialised at construction on the template's
device, so the checkpoint template has fixed shapes from round 0.
``state_dict``/``load_state_dict`` ride the round checkpoints bit for bit
and refuse a snapshot of another optimizer, other hyperparameters or
another shard plan (``ServerOptMismatchError``).  On the sharded spine the
step sees the full tree (the sharded finalize joins its shards first);
only the serialized state lays out shard-major along the plan, so
per-shard checkpoint pieces stay O(model/S).

Params are the port's flat dicts of tensors; the step is a few eager
tensor ops a leaf on the params' device.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from fedml_tpu_torch.core.pytree import Tree, tree_global_norm, tree_keys
from fedml_tpu_torch.obs import telemetry

SERVER_OPT_NAMES = ("plain", "momentum", "adam", "fedac")


class ServerOptConfigError(ValueError):
    """A ``--server_opt`` flag combination that would mislabel a run,
    refused at config time with the reason."""


class ServerOptMismatchError(ValueError):
    """A snapshot written under another server optimizer (or shard plan)
    than the one restoring it; restoring it would continue a foreign
    trajectory, so it is refused."""


class ServerOptimizer:
    """One pseudo-gradient step per round over the finalize seam.

    ``apply(params, finalized, round_idx)`` forms Δ from the finalized
    tree, updates ``self.state`` and returns the new global; ``plain``
    returns the finalized tree itself.  ``apply_delta(params, delta,
    round_idx)`` is the async seam (JAX :297-313): Δ comes from the caller
    already staleness-discounted, and ``plain`` is the SGD step
    ``w − lr·Δ``.  ``state_template()`` (JAX :412-426) is the zero-filled
    restore template of ``state_dict``.  ``sentry``/``device``: the perf
    recorder's sentry and device observatory, which ledger the step.
    """

    def __init__(self, name: str, template: Tree, *,
                 lr: float = 1.0, momentum: float = 0.9,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8,
                 fedac_mu: float = 0.0, fedac_gamma: float = 0.0,
                 fedac_alpha: float = 1.0, fedac_beta: float = 1.0,
                 local_steps: int = 1, plan=None, sentry=None,
                 device=None):
        if name not in SERVER_OPT_NAMES:
            raise ServerOptConfigError(
                f"unknown --server_opt {name!r}; "
                f"have {list(SERVER_OPT_NAMES)}")
        self.name = name
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.beta1, self.beta2, self.eps = (float(beta1), float(beta2),
                                            float(eps))
        if name == "fedac":
            if fedac_mu > 0.0:
                from fedml_tpu_torch.algorithms.fedac import fedac_coupling
                gamma, alpha, beta = fedac_coupling(
                    self.lr, fedac_mu, max(int(local_steps), 1))
            else:
                gamma = fedac_gamma or self.lr
                alpha, beta = fedac_alpha, fedac_beta
            if alpha < 1.0 or beta < 1.0:
                raise ServerOptConfigError(
                    f"--server_opt fedac needs alpha >= 1 and beta >= 1 "
                    f"(got alpha={alpha:g}, beta={beta:g}); with "
                    f"--fedac_mu the coupling needs mu <= 1/lr")
            self.coupling = {"gamma": float(gamma), "alpha": float(alpha),
                             "beta": float(beta)}
        else:
            self.coupling = None
        self.plan = plan
        self._keys: List[str] = tree_keys(template)
        self._template_leaves = [template[k].detach().cpu().numpy()
                                 for k in self._keys]
        # the hyperparameters a restore must match (the JAX package's
        # fingerprint, so a snapshot carries the same number in both)
        self.fp = zlib.crc32(json.dumps(
            {"name": name, "lr": self.lr, "momentum": self.momentum,
             "beta1": self.beta1, "beta2": self.beta2, "eps": self.eps,
             "coupling": self.coupling}, sort_keys=True).encode())
        self.step_count = 0
        self.state = self._init_state(template)
        reg = telemetry.get_registry()
        self._norms_on = reg.enabled
        self._m_steps = reg.counter("fedml_srvopt_steps_total")
        self._m_delta = reg.gauge("fedml_srvopt_delta_norm_value")
        self._m_update = reg.gauge("fedml_srvopt_update_norm_value")
        self._m_secs = reg.histogram(
            "fedml_srvopt_step_seconds",
            buckets=(.0005, .002, .01, .05, .2, 1., 5.))
        self._step_fn = self._delta_step_fn = self._step
        if device is not None and name != "plain":
            # the recorder's ledger sees the step as ``srvopt_step[name]``
            # (the sync finalize seam) and ``srvopt_delta_step[name]``
            # (the async seam); nothing is built, so there is no probe
            self._step_fn = device.instrument(
                f"srvopt_step[{name}]", self._step, sentry=sentry,
                sentry_name=f"server_opt[{name}]")
            self._delta_step_fn = device.instrument(
                f"srvopt_delta_step[{name}]", self._step)

    # -- state ----------------------------------------------------------------
    def _init_state(self, template: Tree) -> dict:
        def zeros():
            return {k: torch.zeros_like(template[k]) for k in self._keys}
        if self.name == "plain":
            return {}
        if self.name == "momentum":
            return {"trace": zeros()}
        if self.name == "adam":
            device = template[self._keys[0]].device
            return {"mu": zeros(), "nu": zeros(),
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=device)}
        # fedac: the coupled x sequence starts at the global
        return {"x": {k: template[k].detach().clone() for k in self._keys}}

    # -- the step ------------------------------------------------------------
    def _step(self, w: Tree, delta: Tree, state: dict):
        lr = self.lr
        if self.name == "momentum":
            m = self.momentum
            t = {k: delta[k].to(state["trace"][k].dtype)
                 + m * state["trace"][k] for k in self._keys}
            new = {k: w[k] - lr * t[k].to(w[k].dtype) for k in self._keys}
            return new, {"trace": t}
        if self.name == "adam":
            b1, b2, eps = self.beta1, self.beta2, self.eps
            count = state["count"] + 1
            c = count.to(torch.float32)
            bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                               device=c.device), c)
            bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                               device=c.device), c)
            mu, nu, new = {}, {}, {}
            for k in self._keys:
                d = delta[k].to(state["mu"][k].dtype)
                mu[k] = b1 * state["mu"][k] + (1.0 - b1) * d
                nu[k] = b2 * state["nu"][k] + (1.0 - b2) * torch.square(d)
                new[k] = w[k] - (lr * (mu[k] / bc1)
                                 / (torch.sqrt(nu[k] / bc2) + eps)
                                 ).to(w[k].dtype)
            return new, {"mu": mu, "nu": nu, "count": count}
        gamma = self.coupling["gamma"]
        alpha, beta = self.coupling["alpha"], self.coupling["beta"]
        x = state["x"]
        new_ag, new_x = {}, {}
        for k in self._keys:
            d = delta[k]
            x_md = x[k] / beta + (1.0 - 1.0 / beta) * w[k]
            new_ag[k] = x_md - lr * d.to(x_md.dtype)
            new_x[k] = ((1.0 - 1.0 / alpha) * x[k] + x_md / alpha
                        - gamma * d.to(x[k].dtype))
        return new_ag, {"x": new_x}

    # -- the seam -------------------------------------------------------------
    def apply(self, params: Tree, finalized: Tree,
              round_idx: int = 0) -> Tree:
        """The sync finalize seam.  ``plain`` returns the finalized tree
        itself (bit-identity: no delta round trip)."""
        self.step_count += 1
        self._m_steps.inc()
        if self.name == "plain":
            return finalized
        t0 = time.perf_counter()
        delta = {k: params[k] - finalized[k].to(params[k].dtype)
                 for k in self._keys}
        new, self.state = self._step_fn(params, delta, self.state)
        self._note_norms(params, delta, new)
        self._m_secs.observe(time.perf_counter() - t0)
        return new

    def apply_delta(self, params: Tree, delta: Tree,
                    round_idx: int = 0) -> Tree:
        """The async seam: Δ supplied by the caller (already
        staleness-discounted).  ``plain`` is the exact SGD step
        ``w − lr·Δ``."""
        self.step_count += 1
        self._m_steps.inc()
        t0 = time.perf_counter()
        delta = {k: delta[k] for k in self._keys}
        if self.name == "plain":
            new = {k: params[k] - self.lr * delta[k].to(params[k].dtype)
                   for k in self._keys}
        else:
            new, self.state = self._delta_step_fn(params, delta,
                                                  self.state)
        self._note_norms(params, delta, new)
        self._m_secs.observe(time.perf_counter() - t0)
        return new

    def _note_norms(self, params: Tree, delta: Tree, new: Tree) -> None:
        """The pseudo-gradient's and the step's global f32 norms, as the
        JAX package's gauges; read from the device only with telemetry
        on (each is a device sync)."""
        if not self._norms_on:
            return
        self._m_delta.set(float(tree_global_norm(delta)))
        self._m_update.set(float(tree_global_norm(
            {k: new[k] - params[k] for k in self._keys})))

    # -- checkpoint / journal -------------------------------------------------
    def _tree_slots(self) -> List[str]:
        return [k for k in ("trace", "mu", "nu", "x") if k in self.state]

    @staticmethod
    def _as_slot(leaves: list) -> Dict[str, np.ndarray]:
        """A slot's leaf list as a dict keyed by zero-padded position (the
        round checkpoint stores nested dicts, not lists)."""
        return {f"{i:05d}": leaf for i, leaf in enumerate(leaves)}

    @staticmethod
    def _slot_leaves(slot) -> list:
        if isinstance(slot, dict):
            return [slot[k] for k in sorted(slot)]
        return list(slot)

    def _split_flat(self, leaves) -> list:
        """Ordered leaf list → one flat host list, shard-major in
        sorted-slice-key order along the plan."""
        flat = []
        for body in self.plan.split_leaves(leaves):
            (_, d), = body.items()
            for k in sorted(d):
                flat.append(np.asarray(d[k]))
        return flat

    def _join_flat(self, flat) -> list:
        proto = self.plan.split_leaves(self._template_leaves)
        it = iter(flat)
        for body in proto:
            (_, d), = body.items()
            for k in sorted(d):
                d[k] = np.asarray(next(it))
        return self.plan.join_slices(proto)

    def _header(self, step: int) -> Dict[str, np.ndarray]:
        out = {"opt_id": np.asarray(SERVER_OPT_NAMES.index(self.name),
                                    np.int32),
               "fp": np.asarray(self.fp, np.int64),
               "step": np.asarray(step, np.int64)}
        if self.plan is not None:
            out["shard_fp"] = np.asarray(self.plan.fingerprint(), np.int64)
        return out

    def state_dict(self) -> dict:
        """Host snapshot: every slot's leaves as numpy in their own dtype
        (bit-exact), stamped with the optimizer's identity and
        fingerprint (and the shard plan's when sharded).  A slot is a dict
        of its flat leaf list keyed by position."""
        out = self._header(self.step_count)
        for slot in self._tree_slots():
            leaves = [self.state[slot][k].detach().cpu().numpy()
                      for k in self._keys]
            out[slot] = self._as_slot(self._split_flat(leaves)
                                      if self.plan is not None else leaves)
        if "count" in self.state:
            out["count"] = np.asarray(int(self.state["count"]), np.int32)
        return out

    def load_state_dict(self, state: dict) -> None:
        opt_id = int(np.asarray(state.get("opt_id", -1)))
        got = (SERVER_OPT_NAMES[opt_id]
               if 0 <= opt_id < len(SERVER_OPT_NAMES) else f"#{opt_id}")
        if got != self.name:
            raise ServerOptMismatchError(
                f"checkpoint was written under --server_opt {got!r} but "
                f"this run is --server_opt {self.name!r}; restoring its "
                f"optimizer state would continue a foreign trajectory — "
                f"restart from scratch or rerun with --server_opt {got}")
        if int(np.asarray(state.get("fp", -1))) != int(self.fp):
            raise ServerOptMismatchError(
                f"server_opt[{self.name}] checkpoint hyperparameters "
                f"differ from this run's (fingerprint "
                f"{state.get('fp')!r} != {self.fp}) — the restored "
                f"moments would step under a different rule")
        snap_fp = state.get("shard_fp")
        if self.plan is not None:
            if snap_fp is None:
                raise ServerOptMismatchError(
                    "server_opt snapshot carries no shard-plan fingerprint "
                    "(it was written by the replicated path); the sharded "
                    "spine refuses to restore it")
            if int(np.asarray(snap_fp)) != int(self.plan.fingerprint()):
                raise ServerOptMismatchError(
                    "server_opt snapshot was written under a DIFFERENT "
                    "shard plan (fingerprint mismatch — --model_shards or "
                    "the model changed); restoring it would place "
                    "optimizer state into the wrong slots")
        elif snap_fp is not None:
            raise ServerOptMismatchError(
                "server_opt snapshot is laid out along a shard plan but "
                "this run is replicated; refusing the restore")
        for slot in self._tree_slots():
            leaves = self._slot_leaves(state[slot])
            if self.plan is not None:
                leaves = self._join_flat(leaves)
            cur = self.state[slot]
            self.state[slot] = {
                k: torch.as_tensor(np.array(leaf)).to(
                    device=cur[k].device, dtype=cur[k].dtype)
                for k, leaf in zip(self._keys, leaves)}
        if "count" in self.state:
            self.state["count"] = torch.tensor(
                int(np.asarray(state["count"])), dtype=torch.int32,
                device=self.state["count"].device)
        self.step_count = int(np.asarray(state.get("step", 0)))

    def state_template(self) -> dict:
        """The restore template of ``state_dict``: fixed shapes,
        zero-filled, the same layout."""
        out = self._header(0)
        zeros = [np.zeros(leaf.shape, leaf.dtype)
                 for leaf in self._template_leaves]
        for slot in self._tree_slots():
            out[slot] = self._as_slot(self._split_flat(zeros)
                                      if self.plan is not None
                                      else list(zeros))
        if "count" in self.state:
            out["count"] = np.asarray(0, np.int32)
        return out
