"""Static graph-table builders for the synthetic chain trainers
(counterpart of ``fgnn_tpu/data/tables.py``, the same arrays).

Equivalents of the table generators embedded in the reference training
scripts, in channels-last layout (nn_idx (N, K) int32, efeature (N, K, C)):

  * :func:`chain_knn_table` — train_syn_fixed_pw_hop.py:86-101: asymmetric
    window ``range(i-hk, i) + range(i+1, i+hk)`` with boundary clamping and
    the quirk that the last of the k slots stays 0-initialized (kept for
    behavioral parity; pass ``symmetric=True`` for the fixed variant).
  * :func:`pw_factor_table` — train_syn_hop_factor.py:112-132: the joint
    [L vars ; L pairwise-factor nodes] graph: var i sees factors (i-1, i)
    (circular), factor i sees vars (i, i+1); 3 feature channels
    (var-side flag, factor-side flag, signed offset).
  * :func:`high_factor_table` — train_syn_hop_factor.py:135-151: circular
    bipartite [L vars ; L hop-factor nodes] with window k.
  * :func:`global_factor_table` — train_syn_pw_factor.py:136-156: var-chain
    KNN + one dummy global factor node.
"""

from __future__ import annotations

import numpy as np


def chain_knn_table(n: int, k: int, symmetric: bool = False):
    """(n, k) chain-window neighbor table + (n, k, 1) offset features."""
    nn_idx = np.zeros((n, k), np.int32)
    ef = np.zeros((n, k, 1), np.float32)
    hk = k // 2
    for i in range(n):
        if symmetric:
            arr = [j for j in range(i - hk, i + hk + 1) if j != i][:k]
        else:
            arr = list(range(i - hk, i)) + list(range(i + 1, i + hk))
        for idx, j in enumerate(arr):
            j = min(max(j, 0), n - 1)
            nn_idx[i, idx] = j
            ef[i, idx, 0] = i - j
    return nn_idx, ef


def pw_factor_table(n: int):
    """Joint [n vars ; n pw-factors] table: (2n, 2) idx, (2n, 2, 3) features."""
    nn_idx = np.zeros((2 * n, 2), np.int32)
    ef = np.zeros((2 * n, 2, 3), np.float32)
    for i in range(n):
        for idx, nb in enumerate([(i - 1) % n, i]):
            nn_idx[i, idx] = n + nb
            ef[i, idx, 0] = 1.0
            ef[i, idx, 2] = (i - nb + 0.5) * 2.0
        for idx, nb in enumerate([i, (i + 1) % n]):
            nn_idx[n + i, idx] = nb
            ef[n + i, idx, 1] = 1.0
            ef[n + i, idx, 2] = (i - nb + 0.5) * 2.0
    return nn_idx, ef


def high_factor_table(n: int, k: int):
    """Joint [n vars ; n hop-factors] circular window table:
    (2n, k) idx, (2n, k, 2) side-flag features."""
    nn_idx = np.zeros((2 * n, k), np.int32)
    ef = np.zeros((2 * n, k, 2), np.float32)
    hk = k >> 1
    for i in range(n):
        for idx in range(k):
            nb = (i + idx - hk + n) % n
            nn_idx[i, idx] = nb + n
            ef[i, idx, 0] = 1.0
            nn_idx[n + i, idx] = nb
            ef[n + i, idx, 1] = 1.0
    return nn_idx, ef


def global_factor_table(n: int, k: int):
    """[n vars ; 1 global factor] var-KNN table (train_syn_pw_factor.py:136-156):
    (n+1, k) idx, (n+1, k, 1) offsets, plus the dummy factor feature (1, 1)."""
    if k % 2 == 0:
        k = k + 1
    nn_idx = np.zeros((n + 1, k), np.int32)
    ef = np.zeros((n + 1, k, 1), np.float32)
    hk = k // 2
    for i in range(n):
        for idx, j in enumerate(range(i - hk, i + hk)):
            j = min(max(j, 0), n - 1)
            nn_idx[i, idx] = j
            ef[i, idx, 0] = i - j
    nn_idx[n, :] = n
    factor_feature = np.zeros((1, 1), np.float32)
    return nn_idx, ef, factor_feature
