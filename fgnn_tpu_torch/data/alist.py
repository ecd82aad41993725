"""Parsers for the LDPC code assets: MacKay alist matrices and Radford
Neal's binary mod2 (bit-packed GF(2)) matrix format.

Counterpart of ``fgnn_tpu/data/alist.py``; the port keeps its own copy of
the 96.3.963 code files under ``codes/96.3.963``.

  * alist: header "N M", "max_col_deg max_row_deg", per-column degrees,
    per-row degrees, then N lines of column entries and M lines of row
    entries (1-based, zero-padded when degrees vary).
  * mod2mat: int32 n_rows, int32 n_cols, then per column ceil(n_rows/32)
    words of 8 bytes, bits packed low-order-first into the low 32 bits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class AlistMatrix:
    """Sparse GF(2) matrix in adjacency-list form.

    N = number of columns (variables), M = number of rows (checks).
    ``col_items[n]`` lists the (0-based) rows containing column n;
    ``row_items[m]`` lists the (0-based) columns in row m.
    """

    N: int
    M: int
    col_items: list
    row_items: list

    @property
    def max_col_deg(self) -> int:
        return max(len(c) for c in self.col_items)

    @property
    def max_row_deg(self) -> int:
        return max(len(r) for r in self.row_items)


def read_alist(path: str) -> AlistMatrix:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    N, M = int(next(it)), int(next(it))
    max_cd, max_rd = int(next(it)), int(next(it))
    col_deg = [int(next(it)) for _ in range(N)]
    row_deg = [int(next(it)) for _ in range(M)]
    col_items = []
    for n in range(N):
        entries = [int(next(it)) for _ in range(max_cd)]
        col_items.append([e - 1 for e in entries if e > 0])
        if len(col_items[-1]) != col_deg[n]:
            raise ValueError(f"{path}: column {n} lists {entries}, "
                             f"degree {col_deg[n]}")
    row_items = []
    for m in range(M):
        entries = [int(next(it)) for _ in range(max_rd)]
        row_items.append([e - 1 for e in entries if e > 0])
        if len(row_items[-1]) != row_deg[m]:
            raise ValueError(f"{path}: row {m} lists {entries}, "
                             f"degree {row_deg[m]}")
    return AlistMatrix(N, M, col_items, row_items)


def read_mod2mat(path: str) -> np.ndarray:
    """Read a Radford-Neal binary mod2 matrix -> dense uint8 (n_rows, n_cols)."""
    with open(path, "rb") as f:
        raw = f.read()
    n_rows, n_cols = np.frombuffer(raw[:8], dtype="<i4")
    n_words = (n_rows + 31) // 32
    words = np.frombuffer(raw[8:], dtype="<u8")
    if words.size != n_cols * n_words:
        raise ValueError(f"{path}: {words.size} words for a "
                         f"{n_rows}x{n_cols} matrix")
    words = words.reshape(n_cols, n_words)
    out = np.zeros((n_rows, n_cols), dtype=np.uint8)
    for i in range(n_rows):
        w, b = divmod(i, 32)
        out[i] = (words[:, w] >> np.uint64(b)) & np.uint64(1)
    return out


CODES_DIR = os.path.join(os.path.dirname(__file__), "codes", "96.3.963")


def default_paths():
    return {
        "alist": os.path.join(CODES_DIR, "96.3.963"),
        "G": os.path.join(CODES_DIR, "G"),
    }
