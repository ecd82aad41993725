"""Chain MRFs with learned pairwise and budget (hop) factors, with their
exact MAP labels and the LP relaxation's labels.

A frozen copy of the port's ``RandomPGMHop``, ``MixedLengthHopData`` and
their oracles (the sliding-window dynamic programme for the exact MAP and
the local-polytope LP through scipy's HiGHS): for one seed it gives the
port's samples bit for bit (``tests/test_bench_traffic.py``), and later
changes to the program do not move it.

A sample of one chain of length L: unary log-potentials U(0, 1) (L, 2),
pairwise tables zero but [1, 1] ~ U(0, 2) on each edge, a cap per
position ~ U{1 .. hop_order - 1}; the window [w, w + hop_order) may hold
at most ``caps[w + hop_order // 2]`` ones.  Features: ``node_feature``
(L, 2), ``pws`` (L, 4), ``efeature_hop`` (L, hop_order) the one-hot caps;
labels ``label`` (exact MAP) and ``lp_label``.  A composite sample
(several lengths) concatenates one chain of each length, part i drawn from
its own generator seeded ``seed + 1000 i``.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import workers

NEG_INF = -1e18


def map_chain_budget(lops, pws, caps, hop_order):
    """Exact MAP of a binary chain with sliding-window budgets."""
    lops = np.asarray(lops, np.float64)
    L = lops.shape[0]
    h = hop_order
    pws = np.asarray(pws, np.float64)
    n_windows = max(L - h + 1, 0)
    caps_arr = np.asarray(caps, np.int64)[:n_windows]
    S = 1 << max(h - 1, 1)
    half = S >> 1
    states = np.arange(S)
    low_bit = states & 1
    popc = np.array([bin(s).count("1") for s in range(S)], np.int64)
    dp = np.full(S, NEG_INF)
    bp = [np.full(S, -1, np.int64)]
    dp[0] = lops[0, 0]
    dp[1] = lops[0, 1]
    ns0 = np.arange(0, S, 2)
    ns1 = np.arange(1, S, 2)
    for i in range(1, L):
        ndp = np.full(S, NEG_INF)
        nbp = np.full(S, -1, np.int64)
        w = i - h + 1
        for xi, ns in ((0, ns0), (1, ns1)):
            cand = dp + pws[i - 1][low_bit, xi]
            if w >= 0:
                cand = np.where(popc + xi > caps_arr[w], NEG_INF, cand)
            pa = ns >> 1
            pb = pa | half
            va, vb = cand[pa], cand[pb]
            take_b = vb > va
            ndp[ns] = np.where(take_b, vb, va) + lops[i, xi]
            nbp[ns] = np.where(take_b, pb, pa)
        dp = ndp
        bp.append(nbp)
    s = int(np.argmax(dp))
    xs = np.zeros(L, np.int8)
    for i in range(L - 1, 0, -1):
        xs[i] = s & 1
        s = int(bp[i][s])
    xs[0] = s & 1
    return xs


@functools.lru_cache(maxsize=16)
def _lp_matrices(L: int, hop_order: int):
    from scipy.sparse import lil_matrix

    nE = L - 1
    nvar = L + 4 * nE
    n_windows = max(L - hop_order + 1, 0)
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


def lp_labels(lops, pws, caps, hop_order):
    """The local-polytope LP relaxation's labels (mu_1 > 0.5)."""
    from scipy.optimize import linprog

    lops = np.asarray(lops, np.float64)
    L = lops.shape[0]
    pws = np.asarray(pws, np.float64)
    n_windows = max(L - hop_order + 1, 0)
    caps_arr = np.asarray(caps, np.int64)[:n_windows]
    nE = L - 1
    c = np.zeros(L + 4 * nE)
    c[:L] = -(lops[:, 1] - lops[:, 0])
    c[L:] = -pws.reshape(nE, 4).reshape(-1)
    A_eq, b_eq, A_ub = _lp_matrices(L, hop_order)
    b_ub = caps_arr.astype(np.float64) if n_windows else None
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=(0, 1), method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return (res.x[:L] > 0.5).astype(np.int8)


class Chain:
    """One length's sample stream (the port's ``RandomPGMHop`` with
    ``ret_efeature_pw=False``)."""

    def __init__(self, L: int, hop_order: int, seed: int):
        self.L = L
        self.h = hop_order | 1  # the reference forces it odd
        self.rng = np.random.RandomState(seed)

    def sample(self) -> dict:
        L, h = self.L, self.h
        hh = h >> 1
        lops = self.rng.uniform(0.0, 1.0, (L, 2))
        pws = np.zeros((L - 1, 2, 2), np.float64)
        pws[:, 1, 1] = self.rng.uniform(0, 2, L - 1)
        caps = self.rng.randint(1, h, L)
        window_caps = caps[hh: hh + max(L - h + 1, 0)]
        ef = np.zeros((L, h), np.float32)
        for i in range(hh, L - hh):
            ef[i, caps[i]] = 1.0
        ef[:hh, h - 1] = 1.0
        ef[L - hh:, h - 1] = 1.0
        pw_full = np.zeros((L, 4), np.float32)
        pw_full[: L - 1] = pws.reshape(L - 1, 4)
        return {
            "node_feature": lops.astype(np.float32),
            "efeature_hop": ef,
            "label": map_chain_budget(lops, pws, window_caps,
                                      h).astype(np.int32),
            "lp_label": lp_labels(lops, pws, window_caps,
                                  h).astype(np.int32),
            "pws": pw_full,
        }


def samples(seed: int, n: int, lengths, hop_order: int) -> dict:
    """n (composite) samples stacked: one chain of each of ``lengths``
    per sample, part i from ``RandomState(seed + 1000 i)``."""
    parts = [Chain(int(L), hop_order, seed + 1000 * i)
             for i, L in enumerate(lengths)]
    items = []
    for _ in range(n):
        chains = [p.sample() for p in parts]
        items.append({k: np.concatenate([c[k] for c in chains])
                      for k in chains[0]})
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _chunk(args):
    return samples(*args)


def make_pool(mix: dict, seed: int, batch: int, n_workers: int) -> list:
    """``mix["pool_batches"]`` distinct batches of ``batch`` samples of
    chains of ``mix["lengths"]``, in chunks of ``mix["chunk"]`` samples
    with seeds of their own drawn from ``seed``."""
    chunk = int(mix["chunk"])
    if batch % chunk:
        chunk = batch
    per = batch // chunk
    n = int(mix["pool_batches"]) * per
    seeds = workers.sub_seeds(seed, "rpgm_hop", n)
    jobs = [(s, chunk, tuple(mix["lengths"]), int(mix["hop_order"]))
            for s in seeds]
    parts = workers.map_jobs(_chunk, jobs, n_workers)
    return [workers.concat(parts[i * per:(i + 1) * per])
            for i in range(len(parts) // per)]
