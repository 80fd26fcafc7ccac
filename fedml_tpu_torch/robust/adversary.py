"""Adversary injection: seeded malicious silos over the real message path.

The port of ``fedml_tpu/robust/adversary.py`` (:1-313).  A malicious silo
is an unmodified `FedAvgClientActor` whose ``train_fn`` is wrapped by
`make_malicious_train_fn`: the silo really trains, really uploads over the
real transport, and the server sees what a compromised trust domain would
send.  Attacks are selected per silo with ``--adversary``::

    --adversary "2:scale:20,3:sign_flip"       # silo 2 scales x20, 3 flips
    --adversary "4:nan_bomb"                   # silo 4 NaNs a leaf
    --adversary "1:inflate:1e9,2:backdoor"     # weight inflation + backdoor

Kinds: ``sign_flip`` (``global - param * update``), ``scale`` (``global +
param * update``), ``gauss`` (N(0, param) noise on the update),
``nan_bomb`` (the first float leaf all-NaN), ``inflate`` (``num_samples``
claimed as ``param``) and ``backdoor`` (trains on trigger-stamped,
target-relabeled data through the shard transform below).  The wave
attacks (`WaveAttack`, ``--wave_adversary``) poison the cross-device
engine's wave summaries.

The attacks run on host numpy trees in the wire layout (the nested dicts,
leaves in JAX's sorted-key order), as the JAX package's do, so every
attacked upload is bit-equal to the JAX package's.  The port's silo train
fns take and return flat dicts; `make_malicious_train_fn` nests them
(`core.pytree.nest`/`to_host`) at this boundary and flattens the result
back.  All randomness is seeded per ``(seed, silo, round)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from fedml_tpu_torch.core.pytree import flatten_nested, nest, to_host

ATTACK_KINDS = ("sign_flip", "scale", "gauss", "nan_bomb", "inflate",
                "backdoor")

# backdoor's -1 sentinel means "use the run's --target_label"
_DEFAULT_PARAM = {"sign_flip": 1.0, "scale": 10.0, "gauss": 1.0,
                  "nan_bomb": 0.0, "inflate": 1e9, "backdoor": -1.0}


@dataclasses.dataclass(frozen=True)
class Attack:
    kind: str
    param: float

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind {self.kind!r}; "
                             f"available: {ATTACK_KINDS}")


def parse_adversary_spec(spec: str) -> Dict[int, Attack]:
    """``"silo:kind[:param],..."`` → {silo_id: Attack}.  Silo ids are the
    1-based actor ids of the cross-silo/async deployments."""
    out: Dict[int, Attack] = {}
    if not spec:
        return out
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad --adversary entry {entry!r}; expected "
                f"silo:kind[:param] (e.g. '2:scale:20')")
        try:
            silo = int(parts[0])
        except ValueError:
            raise ValueError(f"bad --adversary silo id {parts[0]!r} "
                             f"in {entry!r}") from None
        if silo < 1:
            raise ValueError(f"--adversary silo ids are 1-based actor ids; "
                             f"got {silo}")
        kind = parts[1].strip()
        param = float(parts[2]) if len(parts) == 3 else _DEFAULT_PARAM.get(
            kind, 0.0)
        if silo in out:
            raise ValueError(f"--adversary lists silo {silo} twice")
        out[silo] = Attack(kind, param)
    return out


def _tree_map2(fn, a, b):
    """Structure-preserving two-tree map over the plain dict/list nests
    the wire codec produces (numpy host math — no device bounce)."""
    if hasattr(a, "items"):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        t = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
        return tuple(t) if isinstance(a, tuple) else t
    return fn(np.asarray(a), np.asarray(b))


def _tree_map1(fn, t):
    """One-tree map (numpy host leaves)."""
    if hasattr(t, "items"):
        return {k: _tree_map1(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [_tree_map1(fn, v) for v in t]
        return tuple(out) if isinstance(t, tuple) else out
    return fn(np.asarray(t))


def _first_float_leaf_to_nan(tree):
    """Copy the tree with its first float leaf replaced by all-NaN."""
    done = [False]

    def _walk(t):
        if hasattr(t, "items"):
            return {k: _walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [_walk(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        arr = np.asarray(t)
        if not done[0] and np.issubdtype(arr.dtype, np.floating):
            done[0] = True
            return np.full_like(arr, np.nan)
        return arr

    return _walk(tree)


def make_malicious_train_fn(attack: Attack, train_fn: Callable,
                            silo: int, seed: int = 0) -> Callable:
    """Wrap a silo's honest ``train_fn(params, client_idx, round_idx)``
    (flat dicts in and out) with the attack.  The wrapped function keeps
    the SiloTrainFn contract, so the standard client actor (and with it
    the real transport, codec and compression) carries the attack."""

    def malicious(params, client_idx, round_idx):
        new_params, num_samples = train_fn(params, client_idx, round_idx)
        out = _attack(attack, params, new_params, silo, round_idx, seed)
        if out is None:
            return new_params, (float(attack.param)
                                if attack.kind == "inflate" else num_samples)
        return flatten_nested(out), num_samples

    return malicious


def _attack(attack: Attack, params, new_params, silo: int, round_idx,
            seed: int):
    """The attacked upload as a nested host tree, or None when the upload
    stays honest (``backdoor`` poisoned the data, ``inflate`` the
    weight).  ``params``/``new_params`` are flat dicts."""
    if attack.kind in ("backdoor", "inflate"):
        return None
    return _attack_host(attack, to_host(nest(params)),
                        to_host(nest(new_params)), silo, round_idx, seed)


def _attack_host(attack: Attack, host_old, host_new, silo: int, round_idx,
                 seed: int):
    """The JAX wrapper's attack arithmetic on host numpy trees."""
    if attack.kind == "sign_flip":
        return _tree_map2(lambda g, n: (g - attack.param * (n - g))
                          .astype(n.dtype), host_old, host_new)
    if attack.kind == "scale":
        return _tree_map2(lambda g, n: (g + attack.param * (n - g))
                          .astype(n.dtype), host_old, host_new)
    if attack.kind == "gauss":
        rng = np.random.RandomState(
            (seed * 1_000_003 + silo * 7919 + int(round_idx) * 101)
            % (2 ** 32))
        return _tree_map1(
            lambda n: (n + rng.normal(0.0, attack.param, n.shape))
            .astype(n.dtype) if np.issubdtype(n.dtype, np.floating)
            else n, host_new)
    if attack.kind == "nan_bomb":
        return _first_float_leaf_to_nan(host_new)
    raise ValueError(  # pragma: no cover — Attack.__post_init__ validated
        f"unhandled attack kind {attack.kind!r}")


def make_backdoor_shard_transform(target_label: int, trigger_size: int = 3,
                                  poison_frac: float = 1.0,
                                  seed: int = 0) -> Callable:
    """A ``shard_transform(shard, client_idx, round_idx)`` hook for the
    silo training setup: stamps the pixel trigger + target relabel onto
    ``poison_frac`` of the shard's real (masked) samples, exactly the
    `algorithms/backdoor.poison_stacked_clients` semantics but applied
    silo-side per round — the attacker poisons whatever client shard it
    is assigned, as a real compromised silo would."""
    from fedml_tpu_torch.data.edge_case import apply_pixel_trigger

    def transform(shard, client_idx, round_idx):
        x = np.array(shard["x"], copy=True)
        y = np.array(shard["y"], copy=True)
        mask = np.asarray(shard["mask"])
        sample_shape = x.shape[2:]  # shard is [S, B, ...]
        flat_x = x.reshape((-1,) + tuple(sample_shape))
        flat_y = y.reshape(-1)
        real = np.where(mask.reshape(-1) > 0)[0]
        k = int(round(poison_frac * len(real)))
        if k:
            rng = np.random.RandomState(
                (seed * 1_000_003 + int(client_idx) * 7919
                 + int(round_idx) * 101) % (2 ** 32))
            sel = rng.choice(real, k, replace=False)
            px, py = apply_pixel_trigger(flat_x[sel], target_label,
                                         trigger_size=trigger_size)
            flat_x[sel] = px
            flat_y[sel] = py
        return {**shard, "x": flat_x.reshape(x.shape),
                "y": flat_y.reshape(y.shape)}

    return transform


def attacked_silos(adversaries: Dict[int, Attack],
                   kinds: Optional[List[str]] = None) -> List[int]:
    """Silo ids running one of ``kinds`` (all kinds when None)."""
    return sorted(s for s, a in adversaries.items()
                  if kinds is None or a.kind in kinds)


# ---------------------------------------------------------------------------
# wave-level poisoning (--cross_device)
# ---------------------------------------------------------------------------

# the cross-device engine has no per-silo message seam (clients train
# INSIDE one compiled wave program), so per-silo kinds like inflate/
# backdoor don't apply; these perturb the WAVE SUMMARY — the weighted
# partial mean the admission screen and the streaming fold both see
WAVE_ATTACK_KINDS = ("sign_flip", "scale", "gauss", "nan_bomb")


@dataclasses.dataclass(frozen=True)
class WaveAttack:
    """One poisoned wave: at ``(round_idx, wave)`` (both 0-based), the
    wave's summary is replaced per ``kind`` before admission — the
    mega-cohort path's first-class attacker."""
    round_idx: int
    wave: int
    kind: str
    param: float

    def __post_init__(self):
        if self.kind not in WAVE_ATTACK_KINDS:
            raise ValueError(f"unknown wave attack kind {self.kind!r}; "
                             f"available: {WAVE_ATTACK_KINDS}")
        if self.round_idx < 0 or self.wave < 0:
            raise ValueError(f"--wave_adversary round/wave indices are "
                             f"0-based and non-negative; got round="
                             f"{self.round_idx} wave={self.wave}")


def parse_wave_adversary_spec(spec: str) -> Dict[tuple, WaveAttack]:
    """``"round:wave:kind[:param],..."`` → {(round, wave): WaveAttack}.

        --wave_adversary "3:0:scale:50"        # round 3, wave 0, x50
        --wave_adversary "1:0:sign_flip,2:1:gauss:5"
    """
    out: Dict[tuple, WaveAttack] = {}
    if not spec:
        return out
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad --wave_adversary entry {entry!r}; expected "
                f"round:wave:kind[:param] (e.g. '3:0:scale:50')")
        try:
            round_idx, wave = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(f"bad --wave_adversary round/wave in "
                             f"{entry!r}") from None
        kind = parts[2].strip()
        param = float(parts[3]) if len(parts) == 4 \
            else _DEFAULT_PARAM.get(kind, 0.0)
        key = (round_idx, wave)
        if key in out:
            raise ValueError(f"--wave_adversary lists round {round_idx} "
                             f"wave {wave} twice")
        out[key] = WaveAttack(round_idx, wave, kind, param)
    return out


def poison_wave_summary(attack: WaveAttack, mean_host, global_host,
                        seed: int = 0):
    """Apply ``attack`` to a wave's summary (the weighted partial MEAN,
    params-like) relative to the round's global — the same update
    semantics as the per-silo kinds, at wave granularity.  Host numpy
    math, seeded per ``(seed, round, wave)`` so attacked runs replay
    bit-identically."""
    if attack.kind == "sign_flip":
        return _tree_map2(
            lambda g, m: (g - attack.param * (m - g)).astype(m.dtype),
            global_host, mean_host)
    if attack.kind == "scale":
        return _tree_map2(
            lambda g, m: (g + attack.param * (m - g)).astype(m.dtype),
            global_host, mean_host)
    if attack.kind == "gauss":
        rng = np.random.RandomState(
            (seed * 1_000_003 + attack.round_idx * 7919
             + attack.wave * 101) % (2 ** 32))
        return _tree_map1(
            lambda m: (m + rng.normal(0.0, attack.param, m.shape))
            .astype(m.dtype) if np.issubdtype(m.dtype, np.floating)
            else m, mean_host)
    if attack.kind == "nan_bomb":
        return _first_float_leaf_to_nan(mean_host)
    raise ValueError(  # pragma: no cover — __post_init__ validated
        f"unhandled wave attack kind {attack.kind!r}")
