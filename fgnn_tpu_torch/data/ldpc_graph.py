"""LDPC factor-graph structure of the 96.3.963 code.

Counterpart of ``fgnn_tpu/data/ldpc_graph.py`` (bipartite tables only):
the per-variable check table ``var_checks (96, 3)``, the per-check
variable table ``factors (48, 6)``, and the 7-dim per-edge features (the
6 signals of the incident check plus the variable's / check's own signal)
in the (N, K, 7) layout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .alist import default_paths, read_alist


@dataclass
class LDPCStructure:
    n_vars: int             # 96
    n_checks: int           # 48
    var_deg: int            # 3
    check_deg: int          # 6
    factors: np.ndarray     # (48, 6) variable ids per check
    var_checks: np.ndarray  # (96, 3) check ids per variable

    @classmethod
    def from_alist_file(cls, path: str | None = None) -> "LDPCStructure":
        a = read_alist(path or default_paths()["alist"])
        factors = np.asarray(a.row_items, dtype=np.int64)
        var_checks = np.asarray(a.col_items, dtype=np.int64)
        return cls(a.N, a.M, a.max_col_deg, a.max_row_deg, factors,
                   var_checks)

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


@functools.lru_cache(maxsize=None)
def default_structure() -> LDPCStructure:
    return LDPCStructure.from_alist_file()
