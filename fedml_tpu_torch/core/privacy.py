"""Differential-privacy accounting: the Rényi-DP (RDP) moments accountant
(port of ``fedml_tpu/core/privacy.py``, host numpy in both packages, so
the port keeps the same arithmetic line for line and reports the same ε
bit for bit).

The reference ships "weak DP" — per-update Gaussian noise with NO privacy
accounting (``fedml_core/robustness/robust_aggregation.py:51-55``; the
stddev is a bare config knob and no (ε, δ) is ever computed or reported).
This module provides the real thing for ``--algo dp_fedavg``
(algorithms/dp_fedavg.py): the subsampled-Gaussian RDP bound composed
over rounds and converted to (ε, δ), so every run reports the privacy it
actually spent.

Math (host-side numpy — accounting is not a device workload):

* Gaussian mechanism with L2 sensitivity 1 and noise multiplier z has
  RDP ``ε(α) = α / (2 z²)`` (Mironov 2017, arXiv:1702.07476).
* Under Poisson subsampling with rate q, the integer-order bound
  (Mironov, Talwar & Zhang 2019, arXiv:1908.10530 — the tf-privacy
  accountant formula) is

      ε(α) = 1/(α−1) · log Σ_{j=0..α} C(α,j)(1−q)^{α−j} q^j e^{j(j−1)/(2z²)}

  computed in log space (lgamma binomials + logaddexp) so large orders
  don't overflow.
* RDP composes additively over rounds; conversion to (ε, δ) takes
  ``min_α [ ε(α) + log(1/δ)/(α−1) ]``.

Two sampling analyses are provided (``RdpAccountant(sampling=)``):

* ``"poisson"`` — the subsampled-Gaussian bound above.  EXACT only if
  each client joins each round independently with probability q; when
  the sampler is fixed-size, this is the approximation every production
  DP-FL accountant makes (documented, comparable with the literature).
* ``"fixed_size_wor"`` — the subsampling-WITHOUT-replacement bound
  (Wang, Balle & Kasiviswanathan 2019, arXiv:1808.00087, Thm 27), which
  matches the fixed-size cohort sampler dp_fedavg actually uses
  (``prng.choice_without_replacement``, JAX's ``choice(replace=False)``), under the replace-one
  adjacency that analysis is stated in.  A rigorous UPPER BOUND that
  applies to the real sampler (the Poisson analysis does not),
  conservative relative to Poisson (replace-one doubles the
  sensitivity) — the honest default for ``--algo dp_fedavg``.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

import numpy as np

# α=2..63 densely (small ε regimes resolve there) plus sparse large
# orders for tiny q / large z
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 64)) + (
    80, 96, 128, 192, 256, 512)


def _subsample_prologue(q, noise_multiplier, orders):
    """Shared input contract of both subsampled-Gaussian bounds:
    validates (q, orders) and returns ``(orders_array, early_out)`` —
    ``early_out`` is the answer for the z<=0 (non-private: inf) and q=0
    (spends nothing: 0) edges, else None and the caller computes."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
    orders = np.asarray(list(orders))
    if orders.ndim != 1 or np.any(orders < 2) or \
            np.any(orders != orders.astype(int)):
        raise ValueError("orders must be integers >= 2")
    if noise_multiplier <= 0.0:
        return orders, np.full(orders.shape, np.inf)
    if q == 0.0:
        return orders, np.zeros(orders.shape)
    return orders, None


def rdp_subsampled_gaussian(q: float, noise_multiplier: float,
                            orders: Sequence[int] = DEFAULT_ORDERS
                            ) -> np.ndarray:
    """Per-step RDP ε(α) of the Poisson-subsampled Gaussian mechanism.

    ``q=1`` reduces exactly to the unsubsampled Gaussian ``α/(2z²)``
    (unit-tested); ``q=0`` spends nothing; ``z=0`` is non-private (inf).
    Orders must be integers ≥ 2 (the integer-order bound).
    """
    orders, early = _subsample_prologue(q, noise_multiplier, orders)
    if early is not None:
        return early
    z2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return orders / (2.0 * z2)
    out = np.empty(len(orders))
    log_q, log_1q = math.log(q), math.log1p(-q)
    for i, a in enumerate(int(o) for o in orders):
        # log-space sum of C(a,j)(1-q)^(a-j) q^j exp(j(j-1)/(2 z²))
        terms = [math.lgamma(a + 1) - math.lgamma(j + 1)
                 - math.lgamma(a - j + 1)
                 + (a - j) * log_1q + j * log_q
                 + j * (j - 1) / (2.0 * z2)
                 for j in range(a + 1)]
        out[i] = float(np.logaddexp.reduce(terms)) / (a - 1)
    return out


def rdp_fixed_size_wor(q: float, noise_multiplier: float,
                       orders: Sequence[int] = DEFAULT_ORDERS
                       ) -> np.ndarray:
    """Per-step RDP ε'(α) of the FIXED-SIZE without-replacement
    subsampled Gaussian — the sampler dp_fedavg actually uses.

    Wang, Balle & Kasiviswanathan 2019 (arXiv:1808.00087) Theorem 27,
    integer orders, specialized to the Gaussian mechanism (ε(∞) = ∞, so
    the ``min[2, (e^{ε(∞)}−1)^j]`` factors are 2):

        ε'(α) = 1/(α−1) · log(1
                  + C(α,2) γ² · min{4(e^{ε(2)}−1), 2e^{ε(2)}}
                  + Σ_{j=3..α} 2 C(α,j) γ^j e^{(j−1)·ε(j)})

    with γ = m/N the sampling fraction and ε(j) = j/(2·z_ro²) the base
    Gaussian RDP under the REPLACE-ONE adjacency this analysis is stated
    in: swapping one user moves the clipped cohort sum by up to 2S (one
    update out, another in), not S — so the effective noise multiplier
    is z_ro = z/2.  That doubling is why this bound reads higher ε than
    the Poisson approximation at the same z: it is a valid (possibly
    loose) upper bound for the real sampler, where the Poisson analysis
    simply does not apply (pinned in tests/test_privacy.py).

    Subsampling never hurts (WBK19 §3), so the result is clamped to the
    unsubsampled replace-one Gaussian ``α/(2 z_ro²)`` — which is also
    the exact γ=1 (full participation) value.
    """
    orders, early = _subsample_prologue(q, noise_multiplier, orders)
    if early is not None:
        return early
    z_ro = float(noise_multiplier) / 2.0   # replace-one sensitivity 2S
    z2 = z_ro ** 2
    base = orders / (2.0 * z2)             # unsubsampled replace-one RDP
    if q == 1.0:
        return base.astype(np.float64)
    log_q = math.log(q)
    eps2 = 2.0 / (2.0 * z2)                # ε(2) of the base Gaussian
    out = np.empty(len(orders))
    for i, a in enumerate(int(o) for o in orders):
        # j=2 term: C(a,2) γ² min{4(e^{ε(2)}−1), 2e^{ε(2)}}, in log space
        log_min2 = min(math.log(4.0) + _log_expm1(eps2),
                       math.log(2.0) + eps2)
        terms = [0.0,                                   # the leading 1
                 math.lgamma(a + 1) - math.lgamma(3) - math.lgamma(a - 1)
                 + 2 * log_q + log_min2]
        for j in range(3, a + 1):
            terms.append(math.log(2.0)
                         + math.lgamma(a + 1) - math.lgamma(j + 1)
                         - math.lgamma(a - j + 1)
                         + j * log_q
                         + (j - 1) * j / (2.0 * z2))
        out[i] = float(np.logaddexp.reduce(terms)) / (a - 1)
    return np.minimum(out, base)


def _log_expm1(x: float) -> float:
    """log(e^x − 1), stable for large x (≈ x) and small x (≈ log x)."""
    if x > 30.0:
        return x
    return math.log(math.expm1(x))


def eps_from_rdp(rdp: np.ndarray, orders: Sequence[int],
                 delta: float) -> float:
    """(ε, δ) from composed RDP: ``min_α [ε(α) + log(1/δ)/(α−1)]``
    (Mironov 2017 Prop. 3)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    orders = np.asarray(list(orders), dtype=np.float64)
    eps = np.asarray(rdp) + math.log(1.0 / delta) / (orders - 1.0)
    return float(np.min(eps))


class RdpAccountant:
    """Tracks privacy spent by repeated subsampled-Gaussian rounds.

    One instance per training run: ``step(n)`` after n rounds,
    ``epsilon()`` any time (cheap — the per-step RDP vector is computed
    once and composition is a scalar multiply)."""

    def __init__(self, q: float, noise_multiplier: float, delta: float,
                 orders: Iterable[int] = DEFAULT_ORDERS,
                 sampling: str = "poisson"):
        self.q = float(q)
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.orders = tuple(int(o) for o in orders)
        self.sampling = sampling
        if sampling == "poisson":
            self._per_step = rdp_subsampled_gaussian(
                self.q, self.noise_multiplier, self.orders)
        elif sampling == "fixed_size_wor":
            self._per_step = rdp_fixed_size_wor(
                self.q, self.noise_multiplier, self.orders)
        else:
            raise ValueError(
                f"unknown sampling analysis {sampling!r}; use 'poisson' "
                "or 'fixed_size_wor'")
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += int(n)

    def epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        return eps_from_rdp(self._per_step * self.steps, self.orders,
                            self.delta)
