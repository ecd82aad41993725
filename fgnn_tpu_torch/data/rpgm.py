"""Synthetic chain-MRF (RPGM) sample generators (counterpart of
``fgnn_tpu/data/rpgm.py``: the same seed gives the same bits).

Equivalents of the reference's on-the-fly datasets
(upstream ``lib/data/random_pgm*.py``) with the AD3 solver replaced by
the exact DP / LP oracles in rpgm_oracle.py:

  * :class:`RandomPGM`       — fixed pairwise + fixed-cap budget factors
    (random_pgm.py:9-70); features = unary log-potentials only.
  * :class:`RandomPGMNoHop`  — same without budget factors
    (random_pgm_nohop.py).
  * :class:`RandomPGMPw`     — learned pairwise (random sym. 2x2 with only
    [1,1] = U(0,2)) + fixed-cap budget factors (random_pgm_pw.py:17-95);
    features include the 3-neighborhood pairwise windows (3, L) x 4 or the
    raw per-edge potentials.
  * :class:`RandomPGMPwNoHop` — same without budget factors.
  * :class:`RandomPGMHop`    — learned pairwise + per-position random caps,
    cap one-hot factor features (random_pgm_hop.py:17-135).

Each sample carries BOTH the exact MAP assignment (label) and the LP
relaxation assignment (lp_label baseline).  Layout is channels-last:
node features (L, 2), pairwise edge features (L, 3, 4) etc.

Two generators of chains of mixed lengths serve the COO batching modes
(``graph.build_joint_coo``, the hop trainer's ``--coo``):

  * :class:`MixedLengthHopData` — each sample one chain per configured
    length, concatenated (``--mixed-lengths``);
  * :class:`BucketedHopData`  — each batch one length, drawn per batch
    from a distribution (``--length-dist``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .rpgm_oracle import lp_relaxation_chain_budget, map_chain_budget

NO_BUDGET_CAP = 10 ** 9  # effectively disables budget windows


def _solve(lops, pws, caps, hop_order):
    label, _ = map_chain_budget(lops, pws, caps, hop_order)
    lp_label, _ = lp_relaxation_chain_budget(lops, pws, caps, hop_order)
    return label.astype(np.int32), lp_label.astype(np.int32)


def _pairwise_window_features(pws_right: np.ndarray, L: int) -> np.ndarray:
    """(L, 3, 4) neighborhood pairwise features (random_pgm_pw.py:64-73):
    slot 0 = transposed left edge, slot 1 = zeros (self), slot 2 = right."""
    ef = np.zeros((L, 3, 4), np.float32)
    for i in range(L):
        if i > 0:
            ef[i, 0] = pws_right[i - 1].T.reshape(-1)
        if i < L - 1:
            ef[i, 2] = pws_right[i].reshape(-1)
    return ef


@dataclass
class RandomPGM:
    """Fixed-transition chain MRF with fixed-cap budget factors."""

    chain_length: int = 30
    cap: int = 5
    transition: Optional[np.ndarray] = None   # (2,2) shared pairwise
    hop_order: int = 9
    seed: Optional[int] = None
    with_hops: bool = True

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)
        if self.transition is None:
            # the value the reference dataset writer actually uses
            # (data_generate/generate_random_pgm.py:45)
            self.transition = [0.0, 0.1, 0.2, 1.0]
        self.transition = np.asarray(self.transition, np.float64).reshape(2, 2)

    def sample(self) -> dict:
        L = self.chain_length
        lops = self.rng.uniform(0.0, 1.0, (L, 2))
        cap = self.cap if self.with_hops else NO_BUDGET_CAP
        label, lp_label = _solve(lops, self.transition, cap, self.hop_order)
        return {
            "node_feature": lops.astype(np.float32),    # (L, 2)
            "label": label,
            "lp_label": lp_label,
        }


def RandomPGMNoHop(chain_length=30, transition=None, hop_order=9, seed=None):
    return RandomPGM(chain_length, 0, transition, hop_order, seed,
                     with_hops=False)


@dataclass
class RandomPGMPw:
    """Random-pairwise chain MRF with fixed-cap budget factors."""

    chain_length: int = 30
    cap: int = 5
    hop_order: int = 9
    ret_efeature: bool = True
    seed: Optional[int] = None
    with_hops: bool = True

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)

    def _draw_pws(self, L):
        """pws_right[i] is the 2x2 table on edge (i, i+1): zeros except
        [1,1] ~ U(0,2) (random_pgm_pw.py:53-62)."""
        pws = np.zeros((L - 1, 2, 2), np.float64)
        pws[:, 1, 1] = self.rng.uniform(0, 2, L - 1)
        return pws

    def sample(self) -> dict:
        L = self.chain_length
        lops = self.rng.uniform(0.0, 1.0, (L, 2))
        pws = self._draw_pws(L)
        cap = self.cap if self.with_hops else NO_BUDGET_CAP
        label, lp_label = _solve(lops, pws, cap, self.hop_order)
        out = {
            "node_feature": lops.astype(np.float32),
            "label": label,
            "lp_label": lp_label,
        }
        if self.ret_efeature:
            out["efeature_pw"] = _pairwise_window_features(pws, L)  # (L, 3, 4)
        else:
            pw_full = np.zeros((L, 4), np.float32)
            pw_full[: L - 1] = pws.reshape(L - 1, 4)
            out["pws"] = pw_full.astype(np.float32)                 # (L, 4)
        return out


def RandomPGMPwNoHop(chain_length=30, hop_order=9, ret_efeature=True, seed=None):
    return RandomPGMPw(chain_length, 0, hop_order, ret_efeature, seed,
                       with_hops=False)


@dataclass
class RandomPGMHop:
    """Random pairwise + per-position random budget caps with cap one-hot
    factor features (random_pgm_hop.py)."""

    chain_length: int = 30
    hop_order: int = 9
    ret_efeature_pw: bool = True
    seed: Optional[int] = None

    def __post_init__(self):
        if not (self.hop_order & 1):
            self.hop_order += 1  # reference forces odd (random_pgm_hop.py:20)
        self.half_hop = self.hop_order >> 1
        self.rng = np.random.RandomState(self.seed)

    def _hop_features(self, caps) -> np.ndarray:
        """(L, hop_order) one-hot of the window cap per CENTER position;
        boundary positions get one-hot(hop_order-1) (random_pgm_hop.py:70-85)."""
        L, h, hh = self.chain_length, self.hop_order, self.half_hop
        ef = np.zeros((L, h), np.float32)
        for i in range(hh, L - hh):
            ef[i, caps[i]] = 1.0
        ef[:hh, h - 1] = 1.0
        ef[L - hh:, h - 1] = 1.0
        return ef

    def sample(self) -> dict:
        L, h, hh = self.chain_length, self.hop_order, self.half_hop
        lops = self.rng.uniform(0.0, 1.0, (L, 2))
        pws = np.zeros((L - 1, 2, 2), np.float64)
        pws[:, 1, 1] = self.rng.uniform(0, 2, L - 1)
        caps = self.rng.randint(1, h, L)
        # window starting at w uses caps[w + half_hop] (random_pgm_hop.py:43)
        window_caps = caps[hh: hh + max(L - h + 1, 0)]
        label, lp_label = _solve(lops, pws, window_caps, h)
        out = {
            "node_feature": lops.astype(np.float32),        # (L, 2)
            "efeature_hop": self._hop_features(caps),       # (L, h)
            "label": label,
            "lp_label": lp_label,
        }
        if self.ret_efeature_pw:
            out["efeature_pw"] = _pairwise_window_features(pws, L)
        else:
            pw_full = np.zeros((L, 4), np.float32)
            pw_full[: L - 1] = pws.reshape(L - 1, 4)
            out["pws"] = pw_full.astype(np.float32)
        return out


def batches(dataset, batch_size: int, n_batches: int) -> Iterator[dict]:
    """Stack per-sample dicts into batched arrays."""
    for _ in range(n_batches):
        items = [dataset.sample() for _ in range(batch_size)]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class MixedLengthHopData:
    """Chains of mixed lengths for COO disjoint-union batching.

    Each ``sample()`` is one composite group: one oracle-labelled chain
    per configured length, concatenated along the node axis, so
    ``batches()`` stacks fixed (B, sum_L, ...) arrays whose flat form is a
    ragged batch with no padding.  Part i draws from its own generator,
    seeded ``seed + 1000 * i``.
    """

    def __init__(self, lengths, hop_order: int = 9,
                 ret_efeature_pw: bool = False, seed: Optional[int] = None):
        self.lengths = tuple(int(x) for x in lengths)
        if not self.lengths:
            raise ValueError("need at least one chain length")
        self.parts = [
            RandomPGMHop(L, hop_order=hop_order,
                         ret_efeature_pw=ret_efeature_pw,
                         seed=None if seed is None else seed + 1000 * i)
            for i, L in enumerate(self.lengths)
        ]

    @property
    def total_nodes(self) -> int:
        return sum(self.lengths)

    def sample(self) -> dict:
        items = [p.sample() for p in self.parts]
        return {k: np.concatenate([it[k] for it in items])
                for k in items[0]}


class BucketedHopData:
    """Chain lengths drawn from a distribution, in bucketed batches.

    ``batches(batch_size, n)`` draws each batch's length from
    ``(lengths, probs)`` (``RandomState(seed)``) and fills the batch with
    chains of that length from the length's own generator (seeded
    ``seed + 1000 * i``): homogeneous (B, L, ...) batches, no padding.
    """

    def __init__(self, lengths, probs=None, hop_order: int = 9,
                 ret_efeature_pw: bool = False, seed: Optional[int] = None):
        self.lengths = tuple(int(x) for x in lengths)
        if not self.lengths:
            raise ValueError("need at least one chain length")
        if probs is None:
            probs = [1.0 / len(self.lengths)] * len(self.lengths)
        probs = np.asarray(list(probs), np.float64)
        if probs.size != len(self.lengths):
            raise ValueError("--length-dist must give one probability per "
                             "length")
        self.probs = probs / probs.sum()
        self.parts = {
            L: RandomPGMHop(L, hop_order=hop_order,
                            ret_efeature_pw=ret_efeature_pw,
                            seed=None if seed is None else seed + 1000 * i)
            for i, L in enumerate(self.lengths)
        }
        self.rng = np.random.RandomState(seed)

    def batches(self, batch_size: int,
                n: Optional[int] = None) -> Iterator[dict]:
        count = 0
        while n is None or count < n:
            L = int(self.rng.choice(self.lengths, p=self.probs))
            items = [self.parts[L].sample() for _ in range(batch_size)]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
            count += 1
