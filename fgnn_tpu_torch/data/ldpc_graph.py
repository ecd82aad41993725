"""LDPC factor-graph structure of the 96.3.963 code.

Counterpart of ``fgnn_tpu/data/ldpc_graph.py``:

* the bipartite structure: the per-variable check table ``var_checks
  (96, 3)``, the per-check variable table ``factors (48, 6)``, and the
  7-dim per-edge features (the 6 signals of the incident check plus the
  variable's / check's own signal) in the (N, K, 7) layout;
* the joint structure of the concat (``FactorMPNN``) formulation: the
  [96 variables ; 48 checks] table ``joint_nn_idx (144, 6)``, whose
  variable rows name their 3 checks (96 + c) and then themselves 3 times
  (self padding), and its 2-channel side flags ``joint_etype (144, 6,
  2)``: channel 0 on a variable's check edges, channel 1 on a check's
  variable edges, all zero on the padding;
* the dense parity-check matrix of the encoded words (``parity_check``),
  the code-aware attention mask of the Error Correction Code Transformer
  over its [96 bits ; 48 checks] tokens (``code_mask``, arXiv:2203.14966,
  Algorithm 1), and the syndrome of hard decisions (``syndrome``), which
  runs on any device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .alist import default_paths, read_alist


@dataclass
class LDPCStructure:
    n_vars: int             # 96
    n_checks: int           # 48
    var_deg: int            # 3
    check_deg: int          # 6
    factors: np.ndarray     # (48, 6) variable ids per check
    var_checks: np.ndarray  # (96, 3) check ids per variable
    joint_nn_idx: np.ndarray  # (144, 6) the [vars ; checks] table
    joint_etype: np.ndarray   # (144, 6, 2) side flags

    @classmethod
    def from_alist_file(cls, path: str | None = None) -> "LDPCStructure":
        a = read_alist(path or default_paths()["alist"])
        n_vars, n_checks = a.N, a.M
        var_deg, check_deg = a.max_col_deg, a.max_row_deg
        factors = np.asarray(a.row_items, dtype=np.int64)
        var_checks = np.asarray(a.col_items, dtype=np.int64)
        nn_idx = np.zeros((n_vars + n_checks, check_deg), np.int64)
        etype = np.zeros((n_vars + n_checks, check_deg, 2), np.float32)
        nn_idx[:n_vars, :var_deg] = n_vars + var_checks
        etype[:n_vars, :var_deg, 0] = 1.0
        nn_idx[:n_vars, var_deg:] = np.arange(n_vars)[:, None]
        nn_idx[n_vars:] = factors
        etype[n_vars:, :, 1] = 1.0
        return cls(n_vars, n_checks, var_deg, check_deg, factors,
                   var_checks, nn_idx, etype)

    def check_signals(self, y: np.ndarray) -> np.ndarray:
        """Signals gathered per check: (48, 6)."""
        return y[self.factors]

    def bipartite_features(self, y: np.ndarray):
        """Returns (hop (48,6), nn_idx_f2v (96,3), nn_idx_v2f (48,6),
        efeature_f2v (96,3,7), efeature_v2f (48,6,7))."""
        hop = self.check_signals(y).astype(np.float32)
        ef_f2v = np.concatenate(
            [hop[self.var_checks],
             np.repeat(y.reshape(-1, 1, 1), self.var_deg, axis=1)], axis=2
        ).astype(np.float32)
        ef_v2f = np.concatenate(
            [np.repeat(hop[:, None, :], self.check_deg, axis=1),
             hop[..., None]], axis=2
        ).astype(np.float32)
        return hop, self.var_checks, self.factors, ef_f2v, ef_v2f

    def joint_features(self, y: np.ndarray):
        """The joint graph's inputs for one received word y (96,):
        (nn_idx (144, 6), etype (144, 6, 2), efeature (144, 6, 7),
        hop (48, 6)).  A variable row's edge features are the
        bipartite f2v features of its checks, zero on the padding; a
        check row's are its v2f features."""
        hop = self.check_signals(y).astype(np.float32)
        ef_node = np.concatenate(
            [hop[self.var_checks],
             np.repeat(y.reshape(-1, 1, 1), self.var_deg, axis=1)], axis=2
        ).astype(np.float32)                                 # (96, 3, 7)
        ef_node = np.concatenate([ef_node, np.zeros_like(ef_node)],
                                 axis=1)                     # (96, 6, 7)
        ef_hop = np.concatenate(
            [np.repeat(hop[:, None, :], self.check_deg, axis=1),
             hop[..., None]], axis=2).astype(np.float32)     # (48, 6, 7)
        efeature = np.concatenate([ef_node, ef_hop], axis=0)
        return self.joint_nn_idx, self.joint_etype, efeature, hop


def parity_check() -> np.ndarray:
    """The dense parity-check matrix (48, 96) uint8 of the [s ; t] words
    that the generator ``G`` encodes (``ldpc_channel.encode``): the code's
    ``A2`` file, the 96.3.963 matrix with three ones added, of full rank 48,
    which the sum-product baseline decodes on.  The 96.3.963 matrix itself
    has rank 46, and about half of the encoded words break one of its
    checks."""
    a = read_alist(default_paths()["A2"])
    h = np.zeros((a.M, a.N), np.uint8)
    for i, row in enumerate(a.row_items):
        h[i, row] = 1
    return h


def code_mask(h: np.ndarray) -> np.ndarray:
    """The code-aware attention mask (n + m, n + m), True where a token may
    attend, of a parity-check matrix ``h`` (m, n): tokens are the n bits and
    then the m checks.  Each token attends to itself; for every check i the
    bits it holds attend to each other and to check token n + i, which
    attends to them.  Check tokens are not joined to each other."""
    h = np.asarray(h).astype(bool)
    m, n = h.shape
    mask = np.eye(n + m, dtype=bool)
    for i in range(m):
        bits = np.flatnonzero(h[i])
        mask[np.ix_(bits, bits)] = True
        mask[bits, n + i] = True
        mask[n + i, bits] = True
    return mask


def syndrome(bits: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """H b mod 2 (..., m) of hard decisions ``bits`` (..., n) in {0, 1} and
    the parity-check matrix ``h`` (m, n) of 0 and 1 in bits' floating dtype,
    on their device: a product of 0 and 1 whose sums, at most a check's
    degree, every float dtype holds exactly (bfloat16 up to 256)."""
    return torch.matmul(bits, h.t()).remainder(2)


@functools.lru_cache(maxsize=None)
def default_structure() -> LDPCStructure:
    return LDPCStructure.from_alist_file()
