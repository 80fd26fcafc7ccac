"""Live secure aggregation over the wire (port of
``fedml_tpu/secure/protocol.py``): the practical-SecAgg construction
(Bonawitz et al. 2017) spoken over `Message` frames between the live
cross-silo actors.

* **mask agreement** — each silo of the round's masking group advertises
  a DH public key ``pk_i = g^sk_i mod p`` plus t-of-N Shamir shares of its
  pairwise secret ``sk_i`` and its self-mask seed ``b_i``
  (`field.bgw_encode`), addressed per peer.  The server relays one ROSTER
  frame per silo (the cohort's public keys and the shares addressed to
  it); pair seeds ``s_ij = pk_j^sk_i = pk_i^sk_j`` derive without any
  pair talking directly.
* **masked upload** — the silo quantizes its weighted update into the
  uint32 ring (clip, then fixed point at a scale derived from the group
  size so the cohort sum cannot wrap, `secagg.ring_budget_scale`), adds
  the pairwise masks (``+PRG(s_ij)`` for ``j > i``, ``−`` for ``j < i``)
  and its self-mask ``PRG(b_i)``.  The payload carries the masked update
  tree and a masked quantized weight, so the server recovers the exact
  weighted mean as ``Σ q(x_i·u_i) / Σ q(u_i)``.
* **ring fold** — the server adds each admitted masked upload into one
  O(model) ring accumulator at arrival.
* **unmask** — at barrier close the server asks the survivors for the
  self-mask-seed shares of every uploader and the pairwise-secret shares
  of every dead roster member, reconstructs them (`field.bgw_decode`,
  any t of N, each checked against its advert's commitment) and removes
  those masks.  A round survives ``len(roster) − t`` dropouts and fails
  loudly beyond that.  A silo never reveals both share kinds for one peer.

The PRG is threefry: leaf i of a payload gets ``bits(fold_in(fold_in(
key(seed), round), i))``, bit-equal to the JAX package's
``jax.random.bits`` stream, so a JAX silo's masks and a port silo's
masks cancel.  ``key(seed)`` keeps the seed's low 32 bits, as JAX does
with x64 off (the DH seeds are below ``p = 2^31 − 1`` in any case).

Where the masks are made: a silo quantizes and masks its update on its
``device`` (one threefry stream per pair over the whole payload, the ring
adds in int64 on the device, one device-to-host copy of the masked words
into the frame); the server's accumulator and the unmask's regenerated
masks live on the server's ``device`` too.  On the CPU the same code runs
on CPU tensors.  Everything else (keys, shares, commitments, the sum
screen) is host arithmetic at message rate.

Threat model, as in the JAX package: the server learns only the cohort
sum; share envelopes ride the server's relay unencrypted (an honest but
curious server), and 31-bit DH is a protocol-shape demonstrator.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import math
import secrets as _secrets
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.murmur import M32
from fedml_tpu_torch.obs import telemetry
from fedml_tpu_torch.robust.admission import _canon_key
from fedml_tpu_torch.secure.field import P_DEFAULT, bgw_decode, bgw_encode
from fedml_tpu_torch.secure.secagg import ring_budget_scale

log = logging.getLogger(__name__)

SECAGG_MODES = ("off", "pairwise", "grouped")

# message types, continuing the shared numbering (cross_silo 1-6, the
# async re-task tick 7, the edge timeout 8)
MSG_SECAGG_ADVERT = 9   # silo -> server: pk + per-peer Shamir shares
MSG_SECAGG_ROSTER = 10  # server -> silo: cohort pks + shares addressed to it
MSG_SECAGG_UNMASK = 11  # server -> silo: survivors/dead share request
MSG_SECAGG_SHARES = 12  # silo -> server: the revealed shares

GENERATOR = 7
_P = int(P_DEFAULT)


class SecAggError(RuntimeError):
    """Loud protocol failure: too few shares to unmask, a commitment
    mismatch, or a wrapped sum — the round is lost, never silently
    mis-aggregated."""


# ---------------------------------------------------------------------------
# ring arithmetic
# ---------------------------------------------------------------------------

def quantize_np(x: np.ndarray, scale: float, clip: float) -> np.ndarray:
    """Clip to ±clip, fixed-point encode into the uint32 ring (two's
    complement for negatives)."""
    q = np.round(np.clip(np.asarray(x, np.float64), -clip, clip)
                 * scale).astype(np.int64).astype(np.int32)
    return q.view(np.uint32)


def dequantize_np(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.uint32).view(np.int32).astype(np.float64) / scale


def quantize_tensor(x: torch.Tensor, scale: float,
                    clip: float) -> torch.Tensor:
    """`quantize_np` on an f64 tensor: round half to even (as ``np.round``)
    and the uint32 word as an int64 in ``[0, 2^32)``."""
    q = torch.round(torch.clamp(x, -clip, clip) * scale).to(torch.int64)
    return q & M32


def dequantize_tensor(q: torch.Tensor, scale: float) -> torch.Tensor:
    """`dequantize_np` of int64-held uint32 words, in f64."""
    signed = torch.where(q >= 1 << 31, q - (1 << 32), q)
    return signed.to(torch.float64) / scale


def _canon_leaves(tree) -> List:
    """Leaves in the admission's canonical order (sorted Mapping keys by
    `_canon_key`, over the nested wire tree), without converting them."""
    if hasattr(tree, "items"):
        out: List = []
        for _, v in sorted(tree.items(), key=lambda kv: _canon_key(kv[0])):
            out.extend(_canon_leaves(v))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(_canon_leaves(v))
        return out
    return [tree]


def _tree_map_np(fn, tree):
    """Structure-preserving map over dict/list/tuple nests."""
    if hasattr(tree, "items"):
        return {k: _tree_map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map_np(fn, v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(np.asarray(tree))


def _rebuild_like(tree, new_leaves: Sequence):
    """Re-nest leaves given in canonical order into ``tree``'s structure
    (mappings rebuilt in canonical key order)."""
    it = iter(new_leaves)

    def walk(t):
        if hasattr(t, "items"):
            return {k: walk(v) for k, v in
                    sorted(t.items(), key=lambda kv: _canon_key(kv[0]))}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        return next(it)

    return walk(tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") \
        else np.shape(leaf)


class _Layout:
    """The flat layout of a payload's leaves (canonical order) on a
    device: each element's leaf and its index within the leaf, so one
    threefry pass over the whole payload gives every leaf's stream."""

    def __init__(self, shapes: Sequence[tuple], device):
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)
        self.device = torch.device(device)
        sizes = torch.tensor(self.sizes, dtype=torch.int64)
        starts = torch.cumsum(sizes, 0) - sizes
        self._leaf_of = torch.repeat_interleave(
            torch.arange(len(self.sizes)), sizes).to(self.device)
        idx = torch.arange(self.total, dtype=torch.int64) \
            - torch.repeat_interleave(starts, sizes)
        self._hi = (idx >> 32).to(self.device)
        self._lo = (idx & M32).to(self.device)

    def stream(self, seed: int, round_idx: int) -> torch.Tensor:
        """``prg_mask(seed, round_idx, shapes)`` flattened: int64 words in
        ``[0, 2^32)`` on the layout's device."""
        base = prng.fold_in(prng.key(int(seed) & 0x7FFFFFFFFFFFFFFF),
                            int(round_idx) & 0xFFFFFFFF)
        keys = [prng.fold_in(base, i) for i in range(len(self.sizes))]
        k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                          device=self.device)[self._leaf_of]
        k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                          device=self.device)[self._leaf_of]
        y0, y1 = prng.threefry2x32((k0, k1), self._hi, self._lo)
        return y0 ^ y1

    def split(self, flat: np.ndarray) -> List[np.ndarray]:
        out, lo = [], 0
        for size, shape in zip(self.sizes, self.shapes):
            out.append(flat[lo:lo + size].reshape(shape))
            lo += size
        return out


def prg_mask(seed: int, round_idx: int, shapes: List[tuple],
             device="cpu") -> List[np.ndarray]:
    """The uint32 mask stream of one (seed, round): leaf i gets
    ``bits(fold_in(fold_in(key(seed), round), i))``, as host arrays."""
    layout = _Layout(shapes, device)
    words = layout.stream(seed, round_idx).cpu().numpy().astype(np.uint32)
    return layout.split(words)


def payload_scale(group_size: int, clip: float) -> float:
    """The round's fixed-point scale, derived identically by every client
    and server from (group size, clip); the bound is max(clip, 1) so the
    weight channel (entries <= 1) also stays inside the ring budget."""
    return ring_budget_scale(group_size, max(float(clip), 1.0))


def masked_template(params) -> Dict[str, object]:
    """The structure of a masked upload: the params tree with every leaf a
    uint32 word, plus the masked weight scalar (the admission's
    ``kind="masked"`` template)."""
    q = _tree_map_np(lambda l: np.zeros(np.shape(l), np.uint32), params)
    return {"q": q, "w": np.zeros((1,), np.uint32)}


def _commit(value: int, round_idx: int, owner: int, kind: str) -> str:
    """Binding commitment to a secret seed, published in the advert."""
    return hashlib.sha256(
        f"secagg:{kind}:{owner}:{round_idx}:{value}".encode()).hexdigest()


def _as_int_shares(shares: np.ndarray) -> List[int]:
    return [int(s) for s in np.asarray(shares).reshape(-1)]


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ClientRound:
    round_idx: int
    group: List[int]
    threshold: int
    clip: float
    scale: float
    weight_cap: float
    sk: int
    b: int
    pks: Optional[Dict[int, int]] = None
    roster: Optional[List[int]] = None
    inbound: Optional[Dict[int, Tuple[int, int]]] = None
    # the share kind already revealed per peer this round (a request that
    # flips a peer between survivor and dead is refused)
    revealed: Dict[int, str] = dataclasses.field(default_factory=dict)


class SecAggClient:
    """Silo-side protocol endpoint.  ``sk_i``, ``b_i`` and the Shamir
    coefficients come from ``secrets`` unless a test injects ``rng`` (a
    ``np.random.RandomState`` drawn in the JAX client's call order, so the
    frames are byte-equal).  ``device``: where the update is quantized and
    masked.  ``mask_s`` is the last masking's wall time."""

    def __init__(self, node_id: int,
                 rng: Optional[np.random.RandomState] = None,
                 device="cpu"):
        self.node_id = int(node_id)
        self._rng = rng
        self.device = torch.device(device)
        self._round: Optional[_ClientRound] = None
        self._advert: Optional[Dict] = None
        self._layout: Optional[_Layout] = None
        self.mask_s = 0.0

    def _rand_field(self) -> int:
        if self._rng is not None:
            return int(self._rng.randint(1, _P))
        return _secrets.randbelow(_P - 1) + 1

    def begin_round(self, round_idx: int, info: Dict) -> Dict:
        """Open a round from the sync frame's ``ARG_SECAGG`` info and
        return the ADVERT payload.  Idempotent per round: a duplicated
        sync returns the same advert instead of re-keying."""
        r = self._round
        if r is not None and r.round_idx == int(round_idx) \
                and self._advert is not None:
            return self._advert
        group = sorted(int(s) for s in info["group"])
        if self.node_id not in group:
            raise SecAggError(f"silo {self.node_id} tasked with a masking "
                              f"group it is not a member of: {group}")
        threshold = int(info["threshold"])
        clip = float(info["clip"])
        scale = payload_scale(len(group), clip)
        sk = self._rand_field()
        b = self._rand_field()
        n = len(group)
        share_rng = (self._rng if self._rng is not None
                     else np.random.RandomState(np.random.MT19937(
                         np.random.SeedSequence(_secrets.randbits(128)))))
        sk_shares = _as_int_shares(bgw_encode(
            np.asarray([[sk]], np.int64), n, threshold - 1, rng=share_rng))
        b_shares = _as_int_shares(bgw_encode(
            np.asarray([[b]], np.int64), n, threshold - 1, rng=share_rng))
        self._round = _ClientRound(
            round_idx=int(round_idx), group=group, threshold=threshold,
            clip=clip, scale=scale, weight_cap=float(info["weight_cap"]),
            sk=sk, b=b)
        self._advert = {
            # pk doubles as the commitment to sk
            "pk": pow(GENERATOR, sk, _P),
            "b_commit": _commit(b, round_idx, self.node_id, "b"),
            # share index = the peer's position in the sorted group
            "shares": {str(peer): [sk_shares[i], b_shares[i]]
                       for i, peer in enumerate(group)},
        }
        return self._advert

    def has_roster(self, round_idx: int) -> bool:
        r = self._round
        return (r is not None and r.round_idx == int(round_idx)
                and r.roster is not None)

    def on_roster(self, round_idx: int, payload: Dict) -> bool:
        """Bank the cohort's public keys and the shares addressed to this
        silo; False (frame ignored) on a stale round."""
        r = self._round
        if r is None or r.round_idx != int(round_idx):
            return False
        r.roster = sorted(int(s) for s in payload["roster"])
        r.pks = {int(k): int(v) for k, v in payload["pks"].items()}
        r.inbound = {int(k): (int(v[0]), int(v[1]))
                     for k, v in payload.get("shares", {}).items()}
        return True

    def _layout_for(self, shapes: List[tuple]) -> _Layout:
        if self._layout is None or self._layout.shapes != shapes:
            self._layout = _Layout(shapes, self.device)
        return self._layout

    def quantize(self, round_idx: int, update, num_samples: float
                 ) -> torch.Tensor:
        """The unmasked ring words of ``update`` (the masked frame before
        its masks): the quantized weighted leaves in canonical order, then
        the weight channel, int64 words on ``device``."""
        return self._quantize(round_idx, update, num_samples)[0]

    def _quantize(self, round_idx: int, update, num_samples: float):
        r = self._round
        if r is None or r.round_idx != int(round_idx) or r.roster is None:
            raise SecAggError(f"mask() before a round-{round_idx} roster")
        u = min(float(num_samples) / r.weight_cap, 1.0)
        if u <= 0:
            raise SecAggError(f"non-positive masked weight {u}")
        leaves = _canon_leaves(update)
        layout = self._layout_for([_shape(l) for l in leaves] + [(1,)])
        dev = self.device
        values = torch.cat(
            [torch.as_tensor(np.asarray(l) if not isinstance(l, torch.Tensor)
                             else l).to(device=dev, dtype=torch.float64
                                        ).reshape(-1) * u
             for l in leaves])
        words = torch.cat([
            quantize_tensor(values, r.scale, r.clip),
            quantize_tensor(torch.tensor([u], dtype=torch.float64,
                                         device=dev), r.scale, 1.0)])
        return words, layout

    def mask(self, round_idx: int, update, num_samples: float) -> Dict:
        """Quantize the weighted update and add every mask, on
        ``device``.  ``update``: the nested tree, leaves host arrays or
        tensors.  The weight rides the ring too (``u = min(n /
        weight_cap, 1)``), so the server's ratio is the exact weighted
        mean."""
        t0 = time.perf_counter()
        acc, layout = self._quantize(round_idx, update, num_samples)
        r = self._round
        for peer in r.roster:
            if peer == self.node_id:
                continue
            seed = pow(r.pks[peer], r.sk, _P)
            if peer > self.node_id:
                acc += layout.stream(seed, r.round_idx)
            else:
                acc -= layout.stream(seed, r.round_idx)
        acc += layout.stream(r.b, r.round_idx)
        words = (acc & M32).cpu().numpy().astype(np.uint32)
        self.mask_s = time.perf_counter() - t0
        parts = layout.split(words)
        return {"q": _rebuild_like(update, parts[:-1]), "w": parts[-1]}

    def reveal(self, round_idx: int, survivors, dead) -> Dict:
        """Answer an UNMASK request: the self-mask-seed shares held for
        survivors and the pairwise-secret shares for dead members.
        Refuses to reveal both kinds for one silo, within a request or
        across requests."""
        r = self._round
        if r is None or r.round_idx != int(round_idx) or r.inbound is None:
            raise SecAggError(f"reveal() without round-{round_idx} shares")
        survivors = {int(s) for s in survivors}
        dead = {int(s) for s in dead}
        both = survivors & dead
        if both:
            raise SecAggError(
                f"refusing unmask request naming silos {sorted(both)} as "
                f"BOTH survivor and dead: revealing sk and b together "
                f"would expose a live upload")
        want = {**{p: "b" for p in survivors}, **{p: "sk" for p in dead}}
        flipped = sorted(p for p, kind in want.items()
                         if r.revealed.get(p, kind) != kind)
        if flipped:
            raise SecAggError(
                f"refusing unmask request that flips silos {flipped} "
                f"between survivor and dead across requests: the share "
                f"pair would expose a live upload")
        out = {"b": {}, "sk": {}}
        for peer, (sk_share, b_share) in r.inbound.items():
            kind = want.get(peer)
            if kind is None:
                continue
            r.revealed[peer] = kind
            if kind == "b":
                out["b"][str(peer)] = b_share
            else:
                out["sk"][str(peer)] = sk_share
        return out


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ServerRound:
    round_idx: int
    group: List[int]
    threshold: int
    scale: float
    adverts: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    roster: Optional[List[int]] = None
    acc: Optional[torch.Tensor] = None    # running ring sum (int64 words)
    template: Optional[Dict] = None       # the masked payload's structure
    folded: Dict[int, float] = dataclasses.field(default_factory=dict)
    reveals: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    unmask_sent: bool = False


class SecAggServer:
    """Server-side endpoint: relay, ring fold, unmask.

    One round's state is O(model + group): the fold adds each masked
    upload into one int64 ring accumulator on ``device`` at arrival.
    ``norm_screen_*``: the post-unmask screen, a rolling median + MAD
    over the recovered sum's update norm (per-silo norms do not exist
    under masking), then the sum-level clip (``norm_clip``) and noise
    (``noise_std``) of `finalize`.  ``timings``: the last round's host
    seconds by phase (``agreement``, ``fold``, ``unmask``, ``finalize``).
    """

    def __init__(self, *, threshold: int = 0, clip: float = 2.0**14,
                 weight_cap: float = 1.0, norm_clip: float = 0.0,
                 noise_std: float = 0.0, seed: int = 0,
                 norm_screen_k: float = 6.0, norm_screen_window: int = 64,
                 norm_screen_min_history: int = 8, node: str = "server",
                 device="cpu"):
        if clip <= 0:
            raise ValueError(f"clip must be > 0, got {clip}")
        if weight_cap <= 0:
            raise ValueError(f"weight_cap must be > 0, got {weight_cap}")
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0 (0 = majority), "
                             f"got {threshold}")
        self.threshold_cfg = int(threshold)
        self.clip = float(clip)
        self.weight_cap = float(weight_cap)
        self.norm_clip = float(norm_clip)
        self.noise_std = float(noise_std)
        self.seed = int(seed)
        self.node = node
        self.device = torch.device(device)
        self.norm_screen_k = norm_screen_k
        self.norm_screen_min_history = norm_screen_min_history
        self._sum_norms = collections.deque(maxlen=norm_screen_window)
        self._round: Optional[_ServerRound] = None
        self._layout: Optional[_Layout] = None
        self._lock = threading.Lock()
        self.timings: Dict[str, float] = {}
        reg = telemetry.get_registry()
        self._c_masked = reg.counter("fedml_secagg_masked_uploads_total")
        self._c_share_frames = reg.counter("fedml_secagg_share_frames_total")
        self._c_share_env = reg.counter("fedml_secagg_share_envelopes_total")
        self._c_reconstruct = {
            kind: reg.counter("fedml_secagg_unmask_reconstructions_total",
                              kind=kind)
            for kind in ("self_mask", "pair_key")}
        self._c_rounds = reg.counter("fedml_secagg_rounds_total")
        self._c_sum_rejected = reg.counter("fedml_secagg_sum_rejected_total")
        self._h_agreement = reg.histogram("fedml_secagg_agreement_seconds")
        self._h_unmask = reg.histogram("fedml_secagg_unmask_seconds")
        self._agreement_t0: Optional[float] = None

    # -- round lifecycle -----------------------------------------------------
    def _threshold_for(self, n: int) -> int:
        t = self.threshold_cfg or (n // 2 + 1)
        return max(2, min(t, n))

    def round_start(self, round_idx: int, group) -> None:
        group = sorted(int(s) for s in group)
        if len(group) < 2:
            raise SecAggError(
                f"secure aggregation needs a masking group of >= 2 silos "
                f"(got {group}): a single member's 'sum' IS its update")
        with self._lock:
            self._round = _ServerRound(
                round_idx=int(round_idx), group=group,
                threshold=self._threshold_for(len(group)),
                scale=payload_scale(len(group), self.clip))
        self.timings = {"agreement": 0.0, "fold": 0.0, "unmask": 0.0,
                        "finalize": 0.0}
        self._agreement_t0 = time.perf_counter()

    def sync_info(self) -> Dict:
        """The ``ARG_SECAGG`` dict the sync broadcast carries."""
        r = self._require_round()
        return {"group": list(r.group), "threshold": r.threshold,
                "clip": self.clip, "weight_cap": self.weight_cap}

    def _require_round(self) -> _ServerRound:
        if self._round is None:
            raise SecAggError("no secagg round open")
        return self._round

    # -- mask agreement ------------------------------------------------------
    def note_advert(self, silo: int, payload: Dict) -> bool:
        """Bank one silo's advert; True when the whole group advertised."""
        r = self._require_round()
        silo = int(silo)
        with self._lock:
            if silo not in r.group or r.roster is not None:
                return False
            if silo in r.adverts:
                return False  # duplicate delivery
            self._c_share_frames.inc()
            self._c_share_env.inc(len(payload.get("shares", {})))
            r.adverts[silo] = {
                "pk": int(payload["pk"]),
                "b_commit": payload.get("b_commit"),
                "shares": {int(k): (int(v[0]), int(v[1]))
                           for k, v in payload.get("shares", {}).items()},
            }
            return set(r.adverts) >= set(r.group)

    def advertised(self) -> set:
        r = self._require_round()
        with self._lock:
            return set(r.adverts)

    def folded_silos(self) -> List[int]:
        r = self._require_round()
        with self._lock:
            return sorted(r.folded)

    def roster_members(self) -> List[int]:
        r = self._require_round()
        with self._lock:
            return list(r.roster or [])

    @property
    def count(self) -> int:
        r = self._round
        return len(r.folded) if r is not None else 0

    @property
    def weight_total(self) -> float:
        """Plaintext sum of the admitted sample counts (the edge frame's
        bookkeeping; the aggregation divisor is the masked weight sum
        recovered at finalize)."""
        r = self._round
        return float(sum(r.folded.values())) if r is not None else 0.0

    def flush_roster(self, subset=None) -> Dict[int, Dict]:
        """Fix the roster (everyone who advertised, or a subset) and build
        each member's ROSTER frame.  Needs >= threshold members."""
        r = self._require_round()
        with self._lock:
            members = sorted(set(subset) if subset is not None
                             else set(r.adverts))
            members = [m for m in members if m in r.adverts]
            if len(members) < r.threshold:
                raise SecAggError(
                    f"cannot fix a roster of {len(members)} members below "
                    f"the share threshold t={r.threshold}: the round could "
                    f"never be unmasked")
            r.roster = members
            out = {}
            for m in members:
                out[m] = {
                    "roster": list(members),
                    "pks": {str(i): r.adverts[i]["pk"] for i in members},
                    "shares": {str(i): list(r.adverts[i]["shares"][m])
                               for i in members
                               if m in r.adverts[i]["shares"]},
                }
        if self._agreement_t0 is not None:
            dt = time.perf_counter() - self._agreement_t0
            self.timings["agreement"] = dt
            self._h_agreement.observe(dt)
        return out

    # -- ring fold -----------------------------------------------------------
    def _layout_for(self, shapes: List[tuple]) -> _Layout:
        if self._layout is None or self._layout.shapes != shapes:
            self._layout = _Layout(shapes, self.device)
        return self._layout

    def fold(self, silo: int, payload, num_samples: float) -> None:
        """Fold one admitted masked upload at arrival: ring addition into
        the accumulator."""
        r = self._require_round()
        silo = int(silo)
        with self._lock:
            if r.roster is None or silo not in r.roster:
                raise SecAggError(
                    f"masked upload from silo {silo} outside the round's "
                    f"roster {r.roster}")
            if silo in r.folded:
                return  # duplicate delivery already folded
            t0 = time.perf_counter()
            leaves = [np.asarray(l) for l in _canon_leaves(payload)]
            self._layout_for([l.shape for l in leaves])
            # the uint32 words cross as 4 bytes each, widened on the device
            words = torch.from_numpy(np.concatenate(
                [l.reshape(-1) for l in leaves]).astype(np.uint32)
                .view(np.int32)).to(self.device).to(torch.int64) & M32
            if r.acc is None:
                r.acc = words
                r.template = payload
            else:
                r.acc = (r.acc + words) & M32
            r.folded[silo] = float(num_samples)
            self._c_masked.inc()
            self.timings["fold"] = self.timings.get("fold", 0.0) \
                + time.perf_counter() - t0

    # -- unmask --------------------------------------------------------------
    def unmask_request(self) -> Tuple[List[int], List[int]]:
        """(survivors, dead): uploaders whose self-masks leave the sum,
        and roster members that never uploaded, whose stray pair masks
        are reconstructed away."""
        r = self._require_round()
        with self._lock:
            r.unmask_sent = True
            survivors = sorted(r.folded)
            dead = sorted(set(r.roster or []) - set(r.folded))
            return survivors, dead

    def note_reveal(self, silo: int, payload: Dict) -> bool:
        """Bank one survivor's revealed shares; True when every survivor
        has answered."""
        r = self._require_round()
        silo = int(silo)
        with self._lock:
            if silo not in r.folded or silo in r.reveals:
                return False
            self._c_share_frames.inc()
            self._c_share_env.inc(len(payload.get("b", {}))
                                  + len(payload.get("sk", {})))
            r.reveals[silo] = {
                "b": {int(k): int(v)
                      for k, v in payload.get("b", {}).items()},
                "sk": {int(k): int(v)
                       for k, v in payload.get("sk", {}).items()},
            }
            return set(r.reveals) >= set(r.folded)

    def can_finalize(self) -> bool:
        r = self._require_round()
        with self._lock:
            return len(r.reveals) >= r.threshold

    def _reconstruct(self, owner: int, kind: str, r: _ServerRound) -> int:
        """Shamir-reconstruct one silo's secret from the revealed shares
        and check it against the advert's commitment."""
        key = "b" if kind == "self_mask" else "sk"
        pairs = []  # (position in group, share)
        for responder, reveal in r.reveals.items():
            share = reveal[key].get(owner)
            if share is not None:
                pairs.append((r.group.index(responder), share))
        if len(pairs) < r.threshold:
            raise SecAggError(
                f"cannot reconstruct {kind} of silo {owner}: "
                f"{len(pairs)} shares revealed, threshold t={r.threshold} "
                f"— too many dropouts for the configured tolerance")
        pairs = pairs[:r.threshold]
        idx = [p for p, _ in pairs]
        shares = np.asarray([[[s]] for _, s in pairs], np.int64)
        value = int(bgw_decode(shares, idx)[0, 0])
        advert = r.adverts[owner]
        if kind == "self_mask":
            want = advert.get("b_commit")
            if want is not None \
                    and _commit(value, r.round_idx, owner, "b") != want:
                raise SecAggError(
                    f"self-mask seed of silo {owner} reconstructed to a "
                    f"value that does not match its advert commitment — "
                    f"corrupted or forged shares; refusing to unmask")
        elif pow(GENERATOR, value, _P) != advert["pk"]:
            raise SecAggError(
                f"pairwise secret of silo {owner} reconstructed to a "
                f"value whose public key does not match its advert — "
                f"corrupted or forged shares; refusing to unmask")
        self._c_reconstruct[kind].inc()
        return value

    def unmasked_ring_sum(self) -> np.ndarray:
        """Remove every residual mask from the ring accumulator and return
        the unmasked ring sum (uint32 words, canonical order).  Consumes
        the round's accumulator."""
        r = self._require_round()
        t0 = time.perf_counter()
        with self._lock:
            if not r.folded:
                raise SecAggError("finalize() with no folded uploads")
            survivors = sorted(r.folded)
            dead = sorted(set(r.roster) - set(r.folded))
            layout = self._layout
            acc = r.acc
            for silo in survivors:
                b = self._reconstruct(silo, "self_mask", r)
                acc = acc - layout.stream(b, r.round_idx)
            # uploader i carried sign_i(j) * PRG(s_ij) for dead j
            for j in dead:
                sk_j = self._reconstruct(j, "pair_key", r)
                for i in survivors:
                    s_ij = pow(r.adverts[i]["pk"], sk_j, _P)
                    stream = layout.stream(s_ij, r.round_idx)
                    acc = acc - stream if j > i else acc + stream
            r.acc = acc & M32
            self._c_rounds.inc()
        self.timings["unmask"] = time.perf_counter() - t0
        return r.acc

    def finalize(self, reference=None) -> Tuple[object, float]:
        """Unmask, dequantize and return ``(weighted_mean_tree,
        recovered_weight_sum)``, the mean a nested host tree of f32.

        ``reference``: the round's global (nested host tree).  When set,
        the post-unmask defenses run on the sum: the rolling norm screen
        over ``||mean − reference||`` (a breach returns ``(None, 0.0)``
        and counts ``fedml_secagg_sum_rejected_total``), then the
        sum-level clip and noise when configured."""
        t_all = time.perf_counter()
        r = self._require_round()
        acc = self.unmasked_ring_sum()
        t0 = time.perf_counter()
        layout = self._layout
        values = dequantize_tensor(acc, r.scale)
        den = float(values[-1])
        if den <= 0 or not math.isfinite(den):
            raise SecAggError(
                f"unmasked weight sum {den} is not positive — the ring "
                f"sum wrapped or the unmask removed the wrong masks; "
                f"refusing to publish a corrupted aggregate")
        mean_flat = (values / den).to(torch.float32).cpu().numpy()
        mean = _rebuild_like(r.template["q"], layout.split(mean_flat)[:-1])
        if reference is not None:
            mean = self._post_unmask_defenses(mean, reference, r.round_idx)
        self.timings["finalize"] = time.perf_counter() - t0
        self._h_unmask.observe(time.perf_counter() - t_all)
        return mean, den

    # -- post-unmask sum defenses -------------------------------------------
    def _post_unmask_defenses(self, mean, reference, round_idx: int):
        ref_leaves = [np.asarray(l, np.float64)
                      for l in _canon_leaves(reference)]
        mean_leaves = [np.asarray(l, np.float64)
                       for l in _canon_leaves(mean)]
        delta = [m - g for m, g in zip(mean_leaves, ref_leaves)]
        norm = math.sqrt(sum(float(np.sum(d * d)) for d in delta))
        thresh = self._sum_norm_threshold()
        if thresh is not None and norm > thresh:
            self._c_sum_rejected.inc()
            log.warning("secagg round %d: recovered sum norm %.4g beyond "
                        "the rolling screen threshold %.4g — round "
                        "DISCARDED, global unchanged", round_idx, norm,
                        thresh)
            return None
        self._sum_norms.append(norm)
        if self.norm_clip > 0 and norm > self.norm_clip:
            factor = self.norm_clip / norm
            delta = [d * factor for d in delta]
        if self.noise_std > 0:
            key = prng.fold_in(prng.key(self.seed),
                               int(round_idx) & 0xFFFFFFFF)
            delta = [d + self.noise_std * prng.normal(
                         prng.fold_in(key, i), d.shape).numpy().astype(
                             np.float64)
                     for i, d in enumerate(delta)]
        if self.norm_clip > 0 or self.noise_std > 0:
            out = [(g + d).astype(np.float32)
                   for g, d in zip(ref_leaves, delta)]
            return _rebuild_like(mean, out)
        return mean

    def _sum_norm_threshold(self) -> Optional[float]:
        if len(self._sum_norms) < self.norm_screen_min_history:
            return None
        arr = np.asarray(self._sum_norms, np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        return med + self.norm_screen_k * max(mad, 0.05 * med, 1e-12)
