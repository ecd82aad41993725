"""Sum-product (belief network) LDPC decoder, numpy reference (counterpart
of ``fgnn_tpu/data/bp_ref.py``).

MacKay's 1995 belief-net decoder: solve A x = z given per-bit priors
``bias[n] = P(x_n = 1)``.  Per iteration (flooding schedule):

  1. check pass: per check m, leave-one-out products of the incoming
     difference messages dqc = q0 - q1 give dpc = 0.5 * prod_{other} dqc
     and the check->variable messages pc0/pc1 = 0.5 +- dpc (sign flipped
     when z[m] = 1);
  2. variable pass: per variable n, prior-weighted leave-one-out products
     of pc0/pc1 give the new dqc = (qc0-qc1)/(qc0+qc1), clipped to
     +-0.9999999999, zeroed when the normaliser underflows 1e-40; the full
     product gives the pseudoposterior q1[n];
  3. hard-decide x[n] = (q1[n] >= 0.5) and stop once A x == z.

This module is the host oracle; ``data/ldpc_cpp`` is the native host
decoder and ``ops/bp.py`` the batched torch version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alist import AlistMatrix

CLIP = 0.9999999999
TINYDIV = 1e-40


@dataclass
class BPGraph:
    """Padded edge-index structure of a parity-check matrix."""

    N: int
    M: int
    # rows: (M, max_rd) column ids, -1 padded; row_mask (M, max_rd)
    row_cols: np.ndarray
    row_mask: np.ndarray
    # cols: (N, max_cd) row ids, -1 padded; col_mask (N, max_cd)
    col_rows: np.ndarray
    col_mask: np.ndarray
    # position of (col n via slot u) within its row's list: (N, max_cd)
    col_slot: np.ndarray
    H: np.ndarray  # dense (M, N) uint8 for syndrome checks

    @classmethod
    def from_alist(cls, a: AlistMatrix) -> "BPGraph":
        max_rd, max_cd = a.max_row_deg, a.max_col_deg
        row_cols = -np.ones((a.M, max_rd), np.int64)
        for m, cols in enumerate(a.row_items):
            row_cols[m, : len(cols)] = cols
        col_rows = -np.ones((a.N, max_cd), np.int64)
        col_slot = -np.ones((a.N, max_cd), np.int64)
        for n in range(a.N):
            for u, m in enumerate(a.col_items[n]):
                col_rows[n, u] = m
                # slot of column n within row m's (column-sorted) list
                col_slot[n, u] = list(a.row_items[m]).index(n)
        return cls(
            N=a.N, M=a.M,
            row_cols=row_cols, row_mask=row_cols >= 0,
            col_rows=col_rows, col_mask=col_rows >= 0,
            col_slot=col_slot, H=a.to_dense(),
        )


def _leave_one_out_prod(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-row leave-one-out products by forward and backward cumulative
    products; padded slots (``mask`` false) contribute 1."""
    v = np.where(mask, vals, 1.0)
    fwd = np.ones_like(v)
    bwd = np.ones_like(v)
    fwd[:, 1:] = np.cumprod(v[:, :-1], axis=1)
    bwd[:, :-1] = np.cumprod(v[:, :0:-1], axis=1)[:, ::-1]
    return fwd * bwd


def bp_decode(graph: BPGraph, bias: np.ndarray, z: np.ndarray | None = None,
              max_loops: int = 100):
    """Decode one word.  Returns (x, success, iterations, q1)."""
    N, M = graph.N, graph.M
    bias = np.asarray(bias, np.float64)
    z = np.zeros(M, np.uint8) if z is None else np.asarray(z, np.uint8)

    # dqc indexed (M, max_rd): the variable->check message, check side
    dqc = np.where(graph.row_mask,
                   (1.0 - 2.0 * bias)[np.clip(graph.row_cols, 0, N - 1)],
                   1.0)
    x = np.zeros(N, np.uint8)
    sign = np.where(z.astype(bool), -1.0, 1.0)[:, None]
    rows = np.clip(graph.col_rows, 0, M - 1)
    slots = np.clip(graph.col_slot, 0, graph.row_cols.shape[1] - 1)

    for it in range(1, max_loops + 1):
        # ---- check pass ----
        dpc = 0.5 * _leave_one_out_prod(dqc, graph.row_mask)
        pc0 = 0.5 + sign * dpc                      # (M, max_rd)
        pc1 = 0.5 - sign * dpc

        # variable-side views: pc of (n, u) is at (col_rows, col_slot)
        pc0_v = np.where(graph.col_mask, pc0[rows, slots], 1.0)
        pc1_v = np.where(graph.col_mask, pc1[rows, slots], 1.0)

        # ---- variable pass ----
        qt0 = (1.0 - bias) * np.prod(pc0_v, axis=1)
        qt1 = bias * np.prod(pc1_v, axis=1)
        tot = qt0 + qt1
        q1 = np.where(tot > TINYDIV, qt1 / np.maximum(tot, TINYDIV), 0.49)

        qc0 = (1.0 - bias)[:, None] * _leave_one_out_prod(pc0_v,
                                                          graph.col_mask)
        qc1 = bias[:, None] * _leave_one_out_prod(pc1_v, graph.col_mask)
        s = qc0 + qc1
        d = qc0 - qc1
        new_dqc_v = np.where(s > TINYDIV, d / np.maximum(s, TINYDIV), 0.0)
        new_dqc_v = np.clip(new_dqc_v, -CLIP, CLIP)

        # scatter back to the check-side layout
        dqc = np.where(graph.row_mask, dqc, 1.0)
        dqc[rows[graph.col_mask], slots[graph.col_mask]] = \
            new_dqc_v[graph.col_mask]

        # ---- score ----
        x = (q1 >= 0.5).astype(np.uint8)
        if np.array_equal((graph.H @ x) % 2, z):
            return x, True, it, q1

    return x, False, max_loops, q1


def decode_posteriors(graph: BPGraph, posteriors: np.ndarray, K: int = 48,
                      max_loops: int = 100):
    """Decode with bias = the bit posteriors of the [s ; t] vector against
    the all-zero syndrome; returns (the first K bits, success, iterations).
    """
    x, ok, its, _ = bp_decode(graph, posteriors, None, max_loops)
    return x[:K], ok, its
