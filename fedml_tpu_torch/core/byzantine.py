"""Byzantine-robust aggregation rules (port of ``fedml_tpu/core/byzantine.py``).

Each rule is a cohort-engine ``aggregate(stacked, weights)`` hook over a
stacked tree (leaves ``[N, ...]``) and raw sample-count weights ``[N]``:

* ``coordinate_median`` — per-coordinate median over live clients;
* ``trimmed_mean`` — per-coordinate mean after dropping the
  ``floor(trim_frac * n_live)`` largest and smallest values;
* ``krum`` / multi-Krum — the update(s) closest to their ``n - f - 2``
  nearest neighbours;
* ``geometric_median`` — smoothed Weiszfeld iterations (RFA), which end
  in one weighted mean.

Shapes are static: a weight-0 (padded, rejected, dropped) slot is masked
with ``+inf`` before a sort or with weight 0 in a mean, never gathered
out, so its contents never reach the result.  The arithmetic is the JAX
package's, step for step; in particular Krum's squared distances are
``sq_i + sq_j - 2 x xᵀ`` in f32 (``torch.cdist`` switches formulas by
size, and a near-tie could then pick another client), its ties are broken
by a stable argsort, and nothing here changes the TF32 setting: a caller
that has enabled TF32 matmuls gets TF32 distances.  One departure: Krum
centres the live clients on their mean before that formula.  Distances do
not change in exact arithmetic, but at a CNN's width ``|x|^2`` is far
above the distances, and uncentred f32 picked different clients on a GPU
and on the CPU from the same round.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.pytree import Tree, tree_keys, tree_weighted_mean

METHODS = ("coordinate_median", "trimmed_mean", "krum", "multi_krum",
           "geometric_median")


def _device_of(stacked: Tree) -> torch.device:
    return next(iter(stacked.values())).device


def _weights(weights, device) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=torch.float32).to(device)


def _live_mask(weights: torch.Tensor) -> torch.Tensor:
    return (weights > 0).to(torch.float32)


def _flatten_clients(stacked: Tree) -> torch.Tensor:
    """``[N, ...]`` leaves, in JAX's leaf order -> one ``[N, D]`` f32
    matrix (the distance space)."""
    keys = tree_keys(stacked)
    n = stacked[keys[0]].shape[0]
    return torch.cat([stacked[k].reshape(n, -1).to(torch.float32)
                      for k in keys], dim=1)


def _sorted_live(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The client axis of ``x`` (as f32) sorted, dead slots as ``+inf``
    at the end."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    xf = x.to(torch.float32)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    return torch.sort(torch.where(live.reshape(shape) > 0, xf, inf),
                      dim=0).values


def coordinate_median(stacked: Tree, weights) -> Tree:
    """Per-coordinate median over live clients (padded slots excluded)."""
    live = _live_mask(_weights(weights, _device_of(stacked)))
    n_live = torch.clamp(live.sum(), min=1.0).to(torch.int64)
    lo_i = ((n_live - 1) // 2).reshape(1)
    hi_i = (n_live // 2).reshape(1)

    def _leaf(x):
        s = _sorted_live(x, live)
        med = 0.5 * (s.index_select(0, lo_i)[0] + s.index_select(0, hi_i)[0])
        return med.to(x.dtype)

    return {k: _leaf(stacked[k]) for k in tree_keys(stacked)}


def trimmed_mean(stacked: Tree, weights, trim_frac: float = 0.1) -> Tree:
    """Per-coordinate mean of the values left after trimming the
    ``floor(trim_frac * n_live)`` largest and smallest."""
    device = _device_of(stacked)
    live = _live_mask(_weights(weights, device))
    n = live.shape[0]
    n_live = torch.clamp(live.sum(), min=1.0)
    k = torch.floor(trim_frac * n_live)
    idx = torch.arange(n, dtype=torch.float32, device=device)
    keep = ((idx >= k) & (idx < n_live - k)).to(torch.float32)
    denom = torch.clamp(keep.sum(), min=1.0)

    def _leaf(x):
        shape = (-1,) + (1,) * (x.dim() - 1)
        s = _sorted_live(x, live)
        out = torch.where(keep.reshape(shape) > 0, s,
                          torch.zeros((), device=device)).sum(dim=0)
        return (out / denom).to(x.dtype)

    return {k: _leaf(stacked[k]) for k in tree_keys(stacked)}


def krum_weights(stacked: Tree, weights, f: int = 0,
                 m: int = 1) -> torch.Tensor:
    """Per-client selection weights for (multi-)Krum.

    ``score_i`` is the sum of the ``n_live - f - 2`` smallest squared
    distances from client i to the other live clients; the ``m`` lowest
    scores get weight ``1/m`` (``m=1`` is classic Krum), ties broken by
    slot index.  ``f`` is the assumed number of Byzantine clients."""
    device = _device_of(stacked)
    live = _live_mask(_weights(weights, device))
    n = live.shape[0]
    flat = _flatten_clients(stacked)
    # distances are translation-invariant: centre on the live clients'
    # mean first, or |x|^2 >> d^2 and the f32 cancellation in the formula
    # below swamps the distances (a model's clients differ by small
    # updates), making the selection depend on the summation order
    keep = live[:, None] > 0
    zero = torch.zeros((), device=device)
    centre = torch.where(keep, flat, zero).sum(dim=0) \
        / torch.clamp(live.sum(), min=1.0)
    flat = torch.where(keep, flat - centre, zero)
    sq = torch.sum(flat * flat, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)
    pair_ok = (live[:, None] * live[None, :]) \
        * (1.0 - torch.eye(n, dtype=torch.float32, device=device))
    inf = torch.full((), float("inf"), device=device)
    d2 = torch.where(pair_ok > 0, d2, inf)

    n_live = live.sum()
    k_neighbors = torch.clamp(n_live - f - 2, min=1.0)
    s = torch.sort(d2, dim=1).values
    neigh = (torch.arange(n, dtype=torch.float32, device=device)[None, :]
             < k_neighbors)
    scores = torch.where(neigh & torch.isfinite(s), s,
                         torch.zeros((), device=device)).sum(dim=1)
    scores = torch.where(live > 0, scores, inf)
    order = torch.argsort(scores, stable=True)
    sel = torch.zeros(n, dtype=torch.float32, device=device)
    sel = sel.index_fill(0, order[:m], 1.0) * live
    return sel / torch.clamp(sel.sum(), min=1.0)


def krum(stacked: Tree, weights, f: int = 0, m: int = 1) -> Tree:
    return tree_weighted_mean(stacked, krum_weights(stacked, weights, f, m))


def geometric_median(stacked: Tree, weights, iters: int = 8,
                     eps: float = 1e-6) -> Tree:
    """Smoothed Weiszfeld (RFA): ``z <- Σ β_i x_i / Σ β_i`` with
    ``β_i = w_i / max(‖x_i - z‖, eps)``, from the plain weighted mean.
    The iterations run in the flat ``[N, D]`` space; only the final
    weights touch the tree.  A cohort whose weights are all 0 falls back
    to uniform weights (finite and deterministic)."""
    w = _weights(weights, _device_of(stacked))
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    flat = _flatten_clients(stacked)
    beta = w
    for _ in range(iters):
        z_flat = (beta @ flat) / torch.clamp(beta.sum(), min=eps)
        norms = torch.sqrt(torch.clamp(
            torch.sum((flat - z_flat[None, :]) ** 2, dim=1), min=eps * eps))
        beta = w / norms
    return tree_weighted_mean(stacked, beta)


def make_byzantine_aggregate(method: str, trim_frac: float = 0.1,
                             byz_f: int = 0, krum_m: int = 1,
                             gm_iters: int = 8, gm_eps: float = 1e-6):
    """Build the cohort engine's ``aggregate(stacked, weights)`` hook,
    with the JAX package's checks and messages."""
    if method not in METHODS:
        raise ValueError(f"unknown byzantine method {method!r}; "
                         f"available: {METHODS}")
    if not 0.0 <= trim_frac < 0.5:
        # per side: >= 0.5 would empty the keep window and return zeros
        raise ValueError(f"trim_frac must be in [0, 0.5) (per side), "
                         f"got {trim_frac}")
    if byz_f < 0:
        raise ValueError(f"byz_f must be >= 0, got {byz_f}")
    if krum_m < 1:
        # m=0 would select nothing and NaN the weighted mean
        raise ValueError(f"krum_m must be >= 1, got {krum_m}")
    if gm_iters < 1:
        raise ValueError(f"gm_iters must be >= 1, got {gm_iters}")
    if gm_eps <= 0.0:
        raise ValueError(f"gm_eps must be > 0, got {gm_eps}")
    if method == "coordinate_median":
        return coordinate_median
    if method == "trimmed_mean":
        return lambda s, w: trimmed_mean(s, w, trim_frac)
    if method == "krum":
        return lambda s, w: krum(s, w, byz_f, 1)
    if method == "multi_krum":
        return lambda s, w: krum(s, w, byz_f, krum_m)
    return lambda s, w: geometric_median(s, w, gm_iters, gm_eps)
