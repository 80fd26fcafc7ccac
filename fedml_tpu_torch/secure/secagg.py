"""Secure aggregation by pairwise masking in the uint32 ring.

Port of ``fedml_tpu/secure/secagg.py``.  Each client quantizes its weighted
update to fixed point and adds, for every other client of its group, a
mask it shares with that client: +mask towards higher indices, -mask
towards lower ones.  The group's ring sum cancels every mask exactly and
leaves the sum of the quantized updates; the server never sees one update
unmasked.

Ring values are int32 tensors carrying the uint32 bits (two's complement);
sums run in int64 and wrap to 32 bits, since PyTorch has no uint32
arithmetic on the CPU.  Two backends, named as the port names the robust
aggregation's:

* ``"torch"`` (twin of the JAX package's ``"xla"``): quantize, then each
  pair's mask is ``jax.random.bits`` of the pair key, made by the port's
  threefry (``core/prng.py``) on the tensors' device;
* ``"cuda"`` (twin of ``"pallas"``): the fused quantize + mask kernel of
  ``secure/fused_mask.py``, one launch over every leaf and client row of a
  group, the pair keys derived in the launch; the group's ring sum then
  runs once over the launch's one buffer.

The two backends draw different mask streams; all clients of a group must
use the same one.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from fedml_tpu_torch.core import prng
from fedml_tpu_torch.core.murmur import M32
from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.secure import fused_mask
from fedml_tpu_torch.secure.fused_mask import to_ring

log = logging.getLogger(__name__)

# the uint32 ring holds signed fixed-point values in +-2^31; the COHORT SUM
# must stay inside that, not just each update
RING_CAPACITY = 2.0**31
BACKENDS = ("torch", "cuda")
_JAX_TWINS = {"xla": "torch", "pallas": "cuda"}


def ring_budget_scale(num_clients: int, clip: float) -> float:
    """Largest power-of-two fixed-point scale whose worst-case cohort sum
    cannot wrap the uint32 ring: ``num_clients * clip * scale < 2^31``."""
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    if clip <= 0:
        raise ValueError(f"clip must be > 0, got {clip}")
    scale = 2.0 ** math.floor(math.log2(RING_CAPACITY / (num_clients * clip)))
    while num_clients * clip * scale >= RING_CAPACITY:  # boundary guard
        scale /= 2.0
    if scale < 1.0:
        raise ValueError(
            f"no usable fixed-point scale: {num_clients} clients at "
            f"clip={clip} already exceed the uint32 ring capacity")
    return scale


def validate_ring_budget(num_clients: int, clip: float,
                         scale: float) -> None:
    """Refuse a scale at which a cohort sum of clipped updates can wrap
    the ring and decode sign-flipped."""
    if num_clients * clip * scale >= RING_CAPACITY:
        raise ValueError(
            f"uint32 ring budget exceeded: num_clients={num_clients} * "
            f"clip={clip} * scale={scale} = "
            f"{num_clients * clip * scale:.3g} >= 2^31 — the cohort sum "
            f"can wrap and corrupt the aggregate.  Lower scale/clip or "
            f"pass scale=None to auto-derive it from the cohort size "
            f"(ring_budget_scale gives {ring_budget_scale(num_clients, clip)})")


def quantize(tree: Tree, scale: float = 2.0**16,
             clip: float = 2.0**14) -> Tree:
    """Fixed-point encode: clip to +-clip, scale, round half to even; the
    int32 is the uint32 ring element's two's complement."""
    return {k: torch.round(torch.clamp(tree[k], -clip, clip) * scale)
            .to(torch.int32) for k in tree_keys(tree)}


def dequantize(tree: Tree, scale: float = 2.0**16) -> Tree:
    """Ring values (uint32 read as int32) -> f32 / scale."""
    return {k: tree[k].to(torch.float32) / scale for k in tree_keys(tree)}


def ring_sum(tree: Tree) -> Tree:
    """The wrapping uint32 sum over each leaf's leading (client) axis."""
    return {k: to_ring(tree[k].to(torch.int64).sum(0))
            for k in tree_keys(tree)}


def _pair_key(base_key: prng.Key, i: int, j: int) -> prng.Key:
    """Shared key of the pair (min, max): both ends derive the same."""
    return prng.fold_in(prng.fold_in(base_key, min(i, j)), max(i, j))


def pairwise_masks(base_key: prng.Key, client_idx: int, num_clients: int,
                   tree: Tree) -> Tree:
    """Net mask of one client: +bits(s_ij) for j > i, -bits(s_ij) for
    j < i, with ``bits`` = ``jax.random.bits`` of the pair key over the
    leaf's shape (so same-shape leaves share a pair's bits, as in JAX).
    Masks of all clients sum to 0 in the ring."""
    out = {}
    for k in tree_keys(tree):
        x = tree[k]
        acc = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
        for j in range(num_clients):
            if j == client_idx:
                continue
            bits = prng.random_bits_tensor(
                _pair_key(base_key, client_idx, j), x.numel(),
                x.device).reshape(x.shape)
            acc = (acc + bits if j > client_idx else acc - bits) & M32
        out[k] = to_ring(acc)
    return out


class SecureCohortAggregator:
    """Secure replacement for the plain weighted cohort aggregate.

    ``mask_update`` runs for each client (quantize(weight * update) + its
    pairwise masks); the ring sum of the group's masked updates, then
    ``unmask_sum``, gives the weighted sum.  ``aggregate_stacked`` runs
    both sides over a stacked group."""

    def __init__(self, num_clients: int, scale: Optional[float] = None,
                 clip: float = 2.0**14, backend: str = "torch"):
        """``scale=None`` derives the largest scale whose worst-case cohort
        sum cannot wrap the ring; an explicit scale that can wrap is
        refused here."""
        if backend in _JAX_TWINS:
            raise ValueError(
                f"secagg backend {backend!r} is the JAX package's name; the "
                f"port's twin of it is {_JAX_TWINS[backend]!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown secagg backend {backend!r}; "
                             f"available: {BACKENDS}")
        if scale is None:
            scale = ring_budget_scale(num_clients, clip)
            log.debug("secagg: auto-derived scale %g for %d clients at "
                      "clip %g", scale, num_clients, clip)
        else:
            validate_ring_budget(num_clients, clip, scale)
        self.num_clients = num_clients
        self.scale = scale
        self.clip = clip
        self.backend = backend
        self._layouts = {}

    def mask_flat(self, rows: Tree, w: torch.Tensor, first_client: int,
                   round_key: prng.Key):
        """The cuda backend's masked ring values of clients
        ``first_client + r`` for the stacked rows r of ``rows``: one
        ``quantize_mask_table`` call over every leaf.  Returns the [R, C]
        ring buffer and its layout (``layout.views`` gives the leaves)."""
        if self.backend != "cuda":
            raise ValueError(f"mask_flat is the cuda backend's masking, not "
                             f"the {self.backend!r} backend's")
        keys = tree_keys(rows)
        sig = tuple((k, tuple(rows[k].shape[1:])) for k in keys)
        layout = self._layouts.get(sig)
        if layout is None:
            layout = self._layouts[sig] = fused_mask.mask_layout(
                keys, [rows[k][0].numel() for k in keys])
        n_rows = int(w.shape[0])
        xs = [rows[k].reshape(n_rows, -1).to(torch.float32).contiguous()
              for k in keys]
        buf = fused_mask.quantize_mask_table(
            layout, xs, w.contiguous(), round_key, first_client,
            self.num_clients, self.scale, self.clip)
        return buf, layout

    def mask_rows(self, rows: Tree, weights: torch.Tensor, first_client: int,
                  round_key: prng.Key) -> Tree:
        """Masked ring values of clients ``first_client + r`` for the
        stacked rows r of ``rows`` (leaves [R, ...]), each weighted by
        ``weights[r]``.  The weights should be normalised (sum 1 over the
        group), so that the ring sum is the weighted mean and stays within
        +-clip."""
        keys = tree_keys(rows)
        n_rows = int(weights.shape[0])
        if not 0 <= first_client <= self.num_clients - n_rows:
            raise ValueError(
                f"rows {first_client}..{first_client + n_rows - 1} are not "
                f"clients of a {self.num_clients}-client group")
        w = weights.to(torch.float32)
        if self.backend == "torch":
            out = {k: [] for k in keys}
            for r in range(n_rows):
                row = {k: rows[k][r] * w[r] for k in keys}
                q = quantize(row, self.scale, self.clip)
                masks = pairwise_masks(round_key, first_client + r,
                                       self.num_clients, q)
                for k in keys:
                    out[k].append(to_ring(q[k].to(torch.int64) + masks[k]))
            return {k: torch.stack(v) for k, v in out.items()}
        buf, layout = self.mask_flat(rows, w, first_client, round_key)
        return dict(zip(keys, layout.views(
            buf, [rows[k].shape[1:] for k in keys])))

    def mask_update(self, update: Tree, weight, client_idx: int,
                    round_key: prng.Key) -> Tree:
        """Quantize(update * weight) + the client's pairwise masks."""
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=next(iter(update.values())).device)
        masked = self.mask_rows({k: v[None] for k, v in update.items()},
                                w.reshape(1), client_idx, round_key)
        return {k: v[0] for k, v in masked.items()}

    def unmask_sum(self, masked_sum: Tree, total_weight=1.0) -> Tree:
        deq = dequantize(masked_sum, self.scale)
        return {k: v / max(float(total_weight), 1e-12)
                for k, v in deq.items()}

    def aggregate_stacked(self, updates: Tree, num_samples: torch.Tensor,
                          round_key: prng.Key) -> Tree:
        """The group's weighted mean through the masks: leaves [N, ...].
        Weights are normalised before masking, so the ring sum is the mean
        itself and cannot wrap; weight-0 pad slots still mask, so every
        pair's masks cancel."""
        n = torch.as_tensor(num_samples, dtype=torch.float32)
        if n.shape != (self.num_clients,):
            raise ValueError(f"aggregate_stacked: {tuple(n.shape)} sample "
                             f"counts for a {self.num_clients}-client group")
        w = n / torch.clamp(n.sum(), min=1e-12)
        if self.backend == "cuda":
            # one ring sum and one dequantize over the launch's buffer; each
            # leaf of the mean is a view of the flat result
            buf, layout = self.mask_flat(updates, w.to(torch.float32), 0,
                                          round_key)
            flat = self.unmask_sum(ring_sum({"": buf}), 1.0)[""]
            keys = tree_keys(updates)
            return dict(zip(keys, layout.views(
                flat, [updates[k].shape[1:] for k in keys])))
        masked = self.mask_rows(updates, w, 0, round_key)
        return self.unmask_sum(ring_sum(masked), 1.0)
