"""Finite-field MPC toolbox (host-side, vectorized numpy).

The port's own copy of ``fedml_tpu/secure/field.py`` (the port imports
nothing of the JAX package, even its pure-numpy modules); the functions,
their outputs for a given ``RandomState`` and the two deliberate
divergences from FedML's ``mpc_function.py`` are the same:

* the LCC evaluation grid (alpha) starts right after the interpolation
  grid (beta), so no worker's share is a secret chunk in plaintext
  (``_centered_points``);
* ``lcc_decode`` evaluates at the first K betas of the encoding grid, so
  encode -> decode round-trips for every T.

Capability parity with the reference's TurboAggregate kernel
(``fedml_api/distributed/turboaggregate/mpc_function.py``): modular inverse
(:4), modular division (:21), products mod p (:29), Lagrange coefficients
(:38), BGW/Shamir encoding & decoding (:61,:91), LCC encoding/decoding with
both centered-range and explicit evaluation points (:110,:195,:228,:249),
additive secret shares (:215), and the DH-style key helpers (:264,:271).

Polynomial evaluation and share reconstruction are vectorized contractions
with a reduction-mod after every rank-1 term (terms are < p^2 < 2^62, so
int64 accumulate-then-mod per term is exact).  Inverses use Fermat's little
theorem (p is prime) with square-and-multiply, vectorized over arrays.

Default prime: 2^31 - 1 (Mersenne), the largest prime whose products fit
int64.  Secrets are [m, d] matrices shared into [N, m, d] share tensors.
"""

from __future__ import annotations

import numpy as np

P_DEFAULT = np.int64(2**31 - 1)


def _as_field(x, p) -> np.ndarray:
    return np.mod(np.asarray(x, dtype=np.int64), p)


def pow_mod(base, exp: int, p) -> np.ndarray:
    """Vectorized base**exp mod p by square-and-multiply (exp a python int)."""
    base = _as_field(base, p)
    result = np.ones_like(base)
    e = int(exp)
    while e > 0:
        if e & 1:
            result = np.mod(result * base, p)
        base = np.mod(base * base, p)
        e >>= 1
    return result


def mod_inv(a, p=P_DEFAULT) -> np.ndarray:
    """a^{-1} mod p for prime p (Fermat), vectorized.

    Parity: ``modular_inv`` (mpc_function.py:4-18), which is the scalar
    extended-Euclid; same output for all units of Z_p."""
    a = _as_field(a, p)
    if np.any(a == 0):
        raise ZeroDivisionError("0 has no inverse mod p")
    return pow_mod(a, int(p) - 2, p)


def mod_div(num, den, p=P_DEFAULT) -> np.ndarray:
    """num / den mod p (parity: ``divmod``, mpc_function.py:21-27)."""
    return np.mod(_as_field(num, p) * mod_inv(den, p), p)


def prod_mod(vals, p=P_DEFAULT) -> np.ndarray:
    """Product of values mod p (parity: ``PI``, mpc_function.py:29-35)."""
    acc = np.int64(1)
    for v in np.asarray(vals, dtype=np.int64).ravel():
        acc = np.mod(acc * np.mod(v, p), p)
    return acc


def lagrange_coeffs(alpha_s, beta_s, p=P_DEFAULT) -> np.ndarray:
    """U[i, j] = prod_{k≠j} (alpha_i - beta_k) / (beta_j - beta_k) mod p.

    Evaluating at ``alpha_s`` the interpolation polynomial through points
    ``beta_s``.  Parity: ``gen_Lagrange_coeffs`` (mpc_function.py:38-57);
    vectorized over i with one inverse batch instead of O(n²) scalar
    inversions."""
    alpha_s = _as_field(alpha_s, p).ravel()
    beta_s = _as_field(beta_s, p).ravel()
    n_a, n_b = len(alpha_s), len(beta_s)
    # dens[j] = prod_{k != j} (beta_j - beta_k)
    diff_b = np.mod(beta_s[:, None] - beta_s[None, :], p)  # [n_b, n_b]
    np.fill_diagonal(diff_b, 1)
    dens = np.ones(n_b, dtype=np.int64)
    for k in range(n_b):
        dens = np.mod(dens * diff_b[:, k], p)
    inv_dens = mod_inv(dens, p)
    # nums[i, j] = prod_{k != j} (alpha_i - beta_k)
    diff_ab = np.mod(alpha_s[:, None] - beta_s[None, :], p)  # [n_a, n_b]
    U = np.empty((n_a, n_b), dtype=np.int64)
    for j in range(n_b):
        num = np.ones(n_a, dtype=np.int64)
        for k in range(n_b):
            if k != j:
                num = np.mod(num * diff_ab[:, k], p)
        U[:, j] = np.mod(num * inv_dens[j], p)
    return U


def _coded_combine(U: np.ndarray, X_sub: np.ndarray, p) -> np.ndarray:
    """out[i] = sum_j U[i,j] * X_sub[j] mod p, with mod after every rank-1
    term so int64 never overflows (each term < p²)."""
    out = np.zeros((U.shape[0],) + X_sub.shape[1:], dtype=np.int64)
    for j in range(U.shape[1]):
        out = np.mod(out + np.mod(U[:, j].reshape((-1,) + (1,) * (X_sub.ndim - 1))
                                  * X_sub[j], p), p)
    return out


# -- BGW / Shamir ------------------------------------------------------------

def bgw_encode(X, N: int, T: int, p=P_DEFAULT,
               rng: np.random.RandomState | None = None) -> np.ndarray:
    """Shamir-share secret [m, d] into N shares with threshold T.

    Share i is the degree-T polynomial f(alpha_i) with f(0)=X and random
    higher coefficients.  Parity: ``BGW_encoding`` (mpc_function.py:61-75),
    vectorized: evaluation is a Vandermonde contraction."""
    X = _as_field(X, p)
    rng = rng or np.random.RandomState()
    coeffs = np.concatenate([
        X[None], rng.randint(0, int(p), size=(T,) + X.shape).astype(np.int64)])
    alpha_s = _as_field(np.arange(1, N + 1), p)
    # vandermonde[i, t] = alpha_i^t
    vander = np.stack([pow_mod(alpha_s, t, p) for t in range(T + 1)], axis=1)
    return _coded_combine(vander, coeffs, p)


def bgw_decode(shares: np.ndarray, worker_idx, p=P_DEFAULT) -> np.ndarray:
    """Reconstruct the secret from ≥ T+1 shares by Lagrange interpolation at
    0.  ``worker_idx`` are 0-based share owners (alpha_i = idx+1).  Parity:
    ``BGW_decoding`` + ``gen_BGW_lambda_s`` (mpc_function.py:78-107)."""
    worker_idx = np.asarray(worker_idx)
    alpha_eval = _as_field(worker_idx + 1, p)
    lam = lagrange_coeffs(np.zeros(1), alpha_eval, p)  # evaluate at 0
    return _coded_combine(lam, _as_field(shares, p), p)[0]


# -- Lagrange-coded computing ------------------------------------------------

def _centered_points(N: int, K: int, T: int, p):
    """Interpolation grid (beta, K+T points, centered) and evaluation grid
    (alpha, N points).

    The reference centers BOTH grids at 0 (mpc_function.py:119-124), which
    makes them overlap: a worker whose alpha equals a secret chunk's beta
    receives that chunk in PLAINTEXT (Lagrange evaluation at a node is the
    identity), voiding T-privacy.  Here the alpha grid starts right after
    the beta grid so the two are disjoint and every share is a proper
    polynomial mixture."""
    n_beta = K + T
    stt_b = -int(np.floor(n_beta / 2))
    beta_s = _as_field(np.arange(stt_b, stt_b + n_beta), p)
    stt_a = stt_b + n_beta  # first point past the beta grid
    alpha_s = _as_field(np.arange(stt_a, stt_a + N), p)
    return alpha_s, beta_s


def lcc_encode(X, N: int, K: int, T: int, p=P_DEFAULT,
               rng: np.random.RandomState | None = None,
               R: np.ndarray | None = None,
               worker_idx=None) -> np.ndarray:
    """LCC-encode secret [m, d] (m divisible by K) into N coded shares.

    The secret splits into K chunks + T random chunks, interpolated through
    the beta grid and evaluated on the alpha grid.  Covers the reference's
    three variants in one function: ``LCC_encoding`` (mpc_function.py:110-133,
    R drawn internally), ``LCC_encoding_w_Random`` (:136-163, caller-supplied
    R), and ``_partial`` (:166-192, only ``worker_idx`` rows)."""
    X = _as_field(X, p)
    m = X.shape[0]
    assert m % K == 0, f"number of secret rows ({m}) must be a multiple of K ({K})"
    chunk = m // K
    X_sub = X.reshape(K, chunk, *X.shape[1:])
    if T > 0:
        if R is None:
            rng = rng or np.random.RandomState()
            R = rng.randint(0, int(p), size=(T, chunk) + X.shape[1:])
        X_sub = np.concatenate([X_sub, _as_field(R, p)])
    alpha_s, beta_s = _centered_points(N, K, T, p)
    if worker_idx is not None:
        alpha_s = alpha_s[np.asarray(worker_idx)]
    U = lagrange_coeffs(alpha_s, beta_s, p)
    return _coded_combine(U, X_sub, p)


def lcc_decode(f_eval, N: int, K: int, T: int, worker_idx,
               p=P_DEFAULT) -> np.ndarray:
    """Decode LCC evaluations back to the K secret chunks (stacked).

    Parity target: ``LCC_decoding`` (mpc_function.py:195-212) — interpolate
    through the surviving workers' alpha points, evaluate at the secret
    chunks' beta points.  NOTE a correctness divergence: the reference
    rebuilds its beta grid over only K points (``n_beta = K``, :198), which
    matches the K+T-point *encoding* grid (:119-124) only when T == 0 — with
    privacy chunks (T > 0) its decode evaluates at shifted points and returns
    garbage for part of the secret.  Here decode evaluates at the first K
    betas of the actual encoding grid, so encode→decode round-trips for all
    T."""
    worker_idx = np.asarray(worker_idx)
    if len(worker_idx) < K + T:
        raise ValueError(
            f"LCC decode needs at least K+T = {K + T} surviving shares to "
            f"interpolate a degree-{K + T - 1} polynomial; got "
            f"{len(worker_idx)}")
    alpha_s, beta_enc = _centered_points(N, K, T, p)
    beta_s = beta_enc[:K]
    alpha_eval = alpha_s[worker_idx]
    U_dec = lagrange_coeffs(beta_s, alpha_eval, p)
    out = _coded_combine(U_dec, _as_field(f_eval, p), p)
    return out.reshape((-1,) + out.shape[2:]) if out.ndim > 2 else out


def lcc_encode_with_points(X, alpha_s, beta_s, p=P_DEFAULT) -> np.ndarray:
    """Evaluate the polynomial through (alpha_s, X) at points beta_s.

    Parity: ``LCC_encoding_with_points`` (mpc_function.py:228-246).  Note the
    reference's argument naming swaps alpha/beta relative to lcc_encode."""
    U = lagrange_coeffs(beta_s, alpha_s, p)
    return _coded_combine(U, _as_field(X, p), p)


def lcc_decode_with_points(f_eval, eval_points, target_points,
                           p=P_DEFAULT) -> np.ndarray:
    """Parity: ``LCC_decoding_with_points`` (mpc_function.py:249-261)."""
    U_dec = lagrange_coeffs(target_points, eval_points, p)
    return _coded_combine(U_dec, _as_field(f_eval, p), p)


# -- additive shares & key agreement ----------------------------------------

def additive_shares(x, n_out: int, p=P_DEFAULT,
                    rng: np.random.RandomState | None = None) -> np.ndarray:
    """Split vector [d] into n_out additive shares summing to x mod p.

    Parity: ``Gen_Additive_SS`` (mpc_function.py:215-225) — but shares the
    *input* rather than returning zero-sum noise only."""
    x = _as_field(x, p)
    rng = rng or np.random.RandomState()
    shares = rng.randint(0, int(p), size=(n_out - 1,) + x.shape).astype(np.int64)
    last = np.mod(x - np.mod(shares.sum(axis=0), p), p)
    return np.concatenate([shares, last[None]])


def pk_gen(sk, p=P_DEFAULT, g: int = 0):
    """Public key g^sk mod p (g=0 ⇒ identity map, the reference's test mode).
    Parity: ``my_pk_gen`` (mpc_function.py:264-268)."""
    return sk if g == 0 else pow_mod(np.int64(g), int(sk), p)


def key_agreement(my_sk, peer_pk, p=P_DEFAULT, g: int = 0):
    """Shared secret peer_pk^sk mod p (g=0 ⇒ product map).
    Parity: ``my_key_agreement`` (mpc_function.py:271-275)."""
    if g == 0:
        return np.mod(np.int64(my_sk) * np.int64(peer_pk), p)
    return pow_mod(np.int64(peer_pk), int(my_sk), p)
