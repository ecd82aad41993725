"""Exact and relaxed MAP inference for chain MRFs with budget factors
(counterpart of ``fgnn_tpu/data/rpgm_oracle.py``, the same answers).

This replaces the reference's external AD3 dual-decomposition solver
(upstream ``lib/data/random_pgm.py:27-68``, the `ad3` pip package):

* :func:`map_chain_budget` — EXACT MAP via dynamic programming over a
  sliding-window state (the last ``hop_order-1`` binary assignments).
  Budget factors ("at most cap of the window's variables are 1",
  AD3 ``create_factor_budget`` semantics) become hard transition
  constraints checked whenever a window completes.  Replaces
  ``solve(branch_and_bound=True)`` and is exact for the same reason
  branch-and-bound is — validated against brute force in tests.
* :func:`lp_relaxation_chain_budget` — the local-polytope LP relaxation
  (pairwise consistency + the budget factors' integral marginal polytope
  ``sum mu_i <= cap``), solved with scipy/HiGHS.  This is the same
  relaxation AD3 solves for this factor type, and provides the
  ``lp_label`` baseline (random_pgm.py:66-68).
"""

from __future__ import annotations

import functools

import numpy as np

NEG_INF = -1e18


def map_chain_budget(lops: np.ndarray, pws, caps, hop_order: int = 9):
    """Exact MAP for a binary chain with sliding-window budget factors.

    lops: (L, 2) unary log-potentials.
    pws:  (L-1, 2, 2) pairwise log-potentials (pws[i][a,b] scores
          x_i = a, x_{i+1} = b), or a single (2, 2) shared table.
    caps: per-window budgets.  Either a scalar (same budget for every
          window, reference RandomPGM/RandomPGMPw) or a sequence indexed by
          window start i giving the budget of window [i, i+hop_order-1]
          (reference RandomPGMHop passes cap[i + hop_order//2]).
    Returns (assignment (L,) int8, value float).
    """
    lops = np.asarray(lops, np.float64)
    L = lops.shape[0]
    h = hop_order
    pws = np.asarray(pws, np.float64)
    if pws.ndim == 2:
        pws = np.broadcast_to(pws, (max(L - 1, 0), 2, 2))
    n_windows = max(L - h + 1, 0)
    if np.isscalar(caps) or isinstance(caps, (int, np.integer, float)):
        caps_arr = np.full(n_windows, int(caps), np.int64)
    else:
        caps_arr = np.asarray(caps, np.int64)[:n_windows]

    S = 1 << max(h - 1, 1)  # window-history states (bits of last h-1 vars)
    half = S >> 1
    states = np.arange(S)
    low_bit = states & 1
    popc = np.array([bin(s).count("1") for s in range(S)], np.int64)

    # dp[s] = best score of assignments whose last h-1 bits equal s
    # (bit j of s = x_{i-j}, i.e. bit 0 is the most recent variable).
    dp = np.full(S, NEG_INF)
    bp = [np.full(S, -1, np.int64)]  # backpointers per position
    dp[0] = lops[0, 0]
    dp[1] = lops[0, 1]

    ns0 = np.arange(0, S, 2)  # next-states with low bit 0
    ns1 = np.arange(1, S, 2)
    for i in range(1, L):
        ndp = np.full(S, NEG_INF)
        nbp = np.full(S, -1, np.int64)
        w = i - h + 1
        for xi, ns in ((0, ns0), (1, ns1)):
            cand = dp + pws[i - 1][low_bit, xi]
            if w >= 0:  # window [i-h+1, i] completes: enforce its budget
                cand = np.where(popc + xi > caps_arr[w], NEG_INF, cand)
            pa = ns >> 1          # predecessors of ns under (s<<1|xi)&mask
            pb = pa | half
            va, vb = cand[pa], cand[pb]
            take_b = vb > va
            ndp[ns] = np.where(take_b, vb, va) + lops[i, xi]
            nbp[ns] = np.where(take_b, pb, pa)
        dp = ndp
        bp.append(nbp)

    best_s = int(np.argmax(dp))
    best_v = dp[best_s]
    # backtrack
    xs = np.zeros(L, np.int8)
    s = best_s
    for i in range(L - 1, 0, -1):
        xs[i] = s & 1
        s = int(bp[i][s])
    xs[0] = s & 1
    return xs, float(best_v)


def brute_force_chain_budget(lops, pws, caps, hop_order=9):
    """O(2^L) oracle used to validate the DP in tests."""
    lops = np.asarray(lops, np.float64)
    L = lops.shape[0]
    pws = np.asarray(pws, np.float64)
    if pws.ndim == 2:
        pws = np.broadcast_to(pws, (max(L - 1, 0), 2, 2))
    n_windows = max(L - hop_order + 1, 0)
    if np.isscalar(caps) or isinstance(caps, (int, np.integer, float)):
        caps_arr = np.full(n_windows, int(caps), np.int64)
    else:
        caps_arr = np.asarray(caps, np.int64)[:n_windows]
    best, best_x = NEG_INF, None
    for bits in range(1 << L):
        x = [(bits >> i) & 1 for i in range(L)]
        ok = all(
            sum(x[w: w + hop_order]) <= caps_arr[w] for w in range(n_windows)
        )
        if not ok:
            continue
        v = sum(lops[i, x[i]] for i in range(L)) + sum(
            pws[i][x[i], x[i + 1]] for i in range(L - 1)
        )
        if v > best:
            best, best_x = v, x
    return np.asarray(best_x, np.int8), float(best)


@functools.lru_cache(maxsize=16)
def _lp_matrices(L: int, hop_order: int):
    """Fixed constraint structure for chain length L, window hop_order:
    (A_eq csr, b_eq, A_ub csr | None).  Only the objective and the budget
    RHS vary per sample."""
    from scipy.sparse import lil_matrix

    nE = L - 1
    nvar = L + 4 * nE  # mu_i, then nu_e(a,b) flattened (a*2+b)
    n_windows = max(L - hop_order + 1, 0)

    # Equalities: for each edge e=(i,i+1):
    #   nu(1,0)+nu(1,1) = mu_i ; nu(0,1)+nu(1,1) = mu_{i+1} ; sum nu = 1
    A_eq = lil_matrix((3 * nE, nvar))
    b_eq = np.zeros(3 * nE)
    for e in range(nE):
        r = 3 * e
        A_eq[r, L + 4 * e + 2] = 1.0
        A_eq[r, L + 4 * e + 3] = 1.0
        A_eq[r, e] = -1.0
        A_eq[r + 1, L + 4 * e + 1] = 1.0
        A_eq[r + 1, L + 4 * e + 3] = 1.0
        A_eq[r + 1, e + 1] = -1.0
        A_eq[r + 2, L + 4 * e: L + 4 * e + 4] = 1.0
        b_eq[r + 2] = 1.0

    A_ub = None
    if n_windows:
        A_ub = lil_matrix((n_windows, nvar))
        for w in range(n_windows):
            A_ub[w, w: w + hop_order] = 1.0
        A_ub = A_ub.tocsr()
    return A_eq.tocsr(), b_eq, A_ub


def lp_relaxation_chain_budget(lops, pws, caps, hop_order: int = 9):
    """Local-polytope LP relaxation; returns (argmax label (L,), mu1 (L,)).

    Variables: mu_i = P(x_i = 1) per node; nu_i(a,b) per chain edge.
    Constraints: edge marginalization to both endpoints; 0 <= mu, nu;
    sum over each budget window of mu <= cap.
    """
    from scipy.optimize import linprog

    lops = np.asarray(lops, np.float64)
    L = lops.shape[0]
    pws = np.asarray(pws, np.float64)
    if pws.ndim == 2:
        pws = np.broadcast_to(pws, (max(L - 1, 0), 2, 2))
    n_windows = max(L - hop_order + 1, 0)
    if np.isscalar(caps) or isinstance(caps, (int, np.integer, float)):
        caps_arr = np.full(n_windows, int(caps), np.int64)
    else:
        caps_arr = np.asarray(caps, np.int64)[:n_windows]

    nE = L - 1
    nvar = L + 4 * nE
    c = np.zeros(nvar)
    # maximize => minimize -obj.  Unary: lops[i,0]*(1-mu) + lops[i,1]*mu
    c[:L] = -(lops[:, 1] - lops[:, 0])
    c[L:] = -pws.reshape(nE, 4).reshape(-1)

    A_eq, b_eq, A_ub = _lp_matrices(L, hop_order)
    b_ub = caps_arr.astype(np.float64) if n_windows else None

    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=(0, 1), method="highs")
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"LP failed: {res.message}")
    mu1 = res.x[:L]
    label = (mu1 > 0.5).astype(np.int8)
    return label, mu1
