"""Exact/Monte-Carlo evaluation of the paper's theory: a numpy/scipy copy
of ``repro.core.theory``.

Implements:
  * Lemma 2.1   — Theta_delta from circular-adjacency set sizes;
  * Theorem 2.2 — Var[J_{0,pi}] for a *fixed* location vector (location-dependent);
  * Theorem 3.1 — Var[J_{sigma,pi}]: exact combinatorial \\tilde{E} (formula 19,
                  enumerated over (s, n1..n4), tractable for small D) and a
                  Monte-Carlo \\tilde{E} over random circular arrangements (any D);
  * Var[J_MH] = J(1-J)/K (Eq. 3), variance ratio (Prop. 3.5).

Location-vector encoding: 0 = 'O' (v_i = w_i = 1), 1 = 'x' (v_i + w_i = 1),
2 = '-' (v_i = w_i = 0).  All of this stays host-side numpy, not torch: it
is combinatorics, not device work, and ``etilde_mc`` must draw what the
reference draws under the same ``seed`` (numpy's generator), so that the
two agree exactly rather than statistically.
"""

from __future__ import annotations

import numpy as np
from scipy.special import comb

SENT = np.iinfo(np.int32).max

O, X, N = 0, 1, 2  # 'O', 'x', '-'


# ---------------------------------------------------------------------------
# Location vectors and adjacency set sizes
# ---------------------------------------------------------------------------

def location_vector(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Definition 2.1 for a single dense pair."""
    v = np.asarray(v) > 0
    w = np.asarray(w) > 0
    x = np.full(v.shape, N, np.int8)
    x[v & w] = O
    x[v ^ w] = X
    return x


def af_counts(x: np.ndarray) -> tuple[int, int]:
    a = int(np.sum(x == O))
    f = a + int(np.sum(x == X))
    return a, f


def structured_location_vector(d: int, f: int, a: int) -> np.ndarray:
    """The paper's Fig. 6 pattern: a 'O's, then (f-a) 'x's, then (d-f) '-'s."""
    return np.concatenate([
        np.full(a, O, np.int8), np.full(f - a, X, np.int8),
        np.full(d - f, N, np.int8)]).astype(np.int8)


def pair_set_sizes(x: np.ndarray, delta: int) -> dict[str, int]:
    """|L_i(delta)|, |G_i(delta)|, |H_i(delta)| of Definition 2.2 (circular)."""
    y = np.roll(x, -delta)  # y[i] = x[(i + delta) mod D]
    def cnt(A, B):
        return int(np.sum((x == A) & (y == B)))
    return {
        "l0": cnt(O, O), "l1": cnt(O, X), "l2": cnt(O, N),
        "g0": cnt(N, O), "g1": cnt(N, X), "g2": cnt(N, N),
        "h0": cnt(X, O), "h1": cnt(X, X), "h2": cnt(X, N),
    }


def theta_from_sizes(l0: float, l2: float, g0: float, g1: float,
                     a: int, f: int) -> float:
    """Lemma 2.1: E[1_s 1_t] = (|L0| + (|G0|+|L2|) J) / (f + |G0| + |G1|)."""
    j = a / f
    return (l0 + (g0 + l2) * j) / (f + g0 + g1)


# ---------------------------------------------------------------------------
# Variances
# ---------------------------------------------------------------------------

def var_minhash(j: float, k: int) -> float:
    """Eq. (3)."""
    return j * (1.0 - j) / k


def var_0pi(x: np.ndarray, k: int) -> float:
    """Theorem 2.2 for a fixed location vector (requires K <= D).

    Var = J/K + (2/K^2) sum_{delta=1}^{K-1} (K - delta) Theta_delta - J^2.
    """
    d = x.shape[0]
    if k > d:
        raise ValueError("K <= D required")
    a, f = af_counts(x)
    if a == 0:
        return 0.0
    j = a / f
    acc = 0.0
    for delta in range(1, k):
        s = pair_set_sizes(x, delta)
        acc += (k - delta) * theta_from_sizes(s["l0"], s["l2"], s["g0"], s["g1"], a, f)
    return j / k + 2.0 * acc / k**2 - j * j


def etilde_exact(d: int, f: int, a: int) -> float:
    """Theorem 3.1's \\tilde{E} by direct enumeration of formula (19).

    Enumerates (s, n1, n2, n3, n4) — the bin-occupation counts of the two-step
    circular placement in Appendix A.3 — and maps them to (l0, l2, g0, g1).
    Exact; intended for small D (cost grows ~ D^5, vectorized per s).
    """
    if not (0 <= a <= f <= d):
        raise ValueError("need 0 <= a <= f <= D")
    if a == 0 or a == f:
        # Var is 0 in these corners; E~ equals J^2 trivially for the variance formula.
        j = 0.0 if a == 0 else 1.0
        return j * j
    if d == f:
        # No '-' points: E~ = J * (a-1)/(f-1)  (proof of Thm 3.4).
        return (a / f) * ((a - 1) / (f - 1))

    j = a / f
    total = 0.0
    denom_balls = comb(d - 1, a)            # place a 'O's into D-a circular gaps
    denom_s = comb(d - a - 1, d - f - 1)    # stars-and-bars for the 'x' placement
    s_lo = max(0, d - 2 * f + a)
    for s in range(s_lo, d - f):
        c2 = d - f - s            # |C2| = |C3|
        c4 = f - a - c2           # |C4|
        if c4 < 0:
            continue
        p_s = comb(d - f, s) * comb(f - a - 1, c2 - 1) / denom_s
        if p_s == 0.0:
            continue
        n1 = np.arange(0, min(s, a) + 1)[:, None, None, None]
        n2 = np.arange(0, min(c2, a) + 1)[None, :, None, None]
        n3 = np.arange(0, min(c2, a) + 1)[None, None, :, None]
        n4 = np.arange(0, min(c4, a) + 1)[None, None, None, :]
        m = n1 + n2 + n3 + n4  # number of occupied bins = l1 + l2
        ways = (comb(s, n1) * comb(c2, n2) * comb(c2, n3) * comb(c4, n4)
                * comb(a - 1, a - m))
        l2 = n1 + n3
        l1 = n2 + n4
        g0 = n1 + n2
        g1 = c2 - n2
        l0 = a - l1 - l2
        expr = (l0 + (g0 + l2) * j) / (f + g0 + g1)
        valid = (m >= 1) & (m <= a) & (l0 >= 0)
        total += p_s * float(np.sum(np.where(valid, ways * expr, 0.0))) / denom_balls
    return total


def etilde_mc(d: int, f: int, a: int, n_samples: int = 200_000,
              seed: int = 0, chunk: int = 4096) -> float:
    """Monte-Carlo \\tilde{E}: average of Lemma 2.1's expression at delta=1 over
    uniformly random circular arrangements of the location multiset."""
    if a == 0 or a == f:
        j = 0.0 if a == 0 else 1.0
        return j * j
    rng = np.random.default_rng(seed)
    base = structured_location_vector(d, f, a)
    j = a / f
    acc = 0.0
    done = 0
    while done < n_samples:
        n = min(chunk, n_samples - done)
        order = np.argsort(rng.random((n, d)), axis=1)
        arr = base[order]                       # (n, D) random arrangements
        nxt = np.roll(arr, -1, axis=1)
        l0 = np.sum((arr == O) & (nxt == O), axis=1)
        l2 = np.sum((arr == O) & (nxt == N), axis=1)
        g0 = np.sum((arr == N) & (nxt == O), axis=1)
        g1 = np.sum((arr == N) & (nxt == X), axis=1)
        acc += float(np.sum((l0 + (g0 + l2) * j) / (f + g0 + g1)))
        done += n
    return acc / n_samples


def var_sigma_pi(d: int, f: int, a: int, k: int, *, method: str = "auto",
                 n_samples: int = 200_000, seed: int = 0) -> float:
    """Theorem 3.1: Var = J/K + (K-1) E~ / K - J^2."""
    if k > d:
        raise ValueError("K <= D required")
    if a == 0 or a == f:
        return 0.0
    if method == "auto":
        method = "exact" if d <= 48 else "mc"
    et = (etilde_exact(d, f, a) if method == "exact"
          else etilde_mc(d, f, a, n_samples=n_samples, seed=seed))
    j = a / f
    return j / k + (k - 1) * et / k - j * j


def variance_ratio(d: int, f: int, a: int, k: int, **kw) -> float:
    """Prop. 3.5's rho = Var_MH / Var_{sigma,pi} (constant in a for fixed D,f,K)."""
    j = a / f
    vs = var_sigma_pi(d, f, a, k, **kw)
    vm = var_minhash(j, k)
    return vm / vs if vs > 0 else np.inf
