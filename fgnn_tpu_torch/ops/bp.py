"""Batched sum-product LDPC decoding as torch ops (counterpart of
``fgnn_tpu/ops/bp.py``).

The classical belief-network decoder of ``data/bp_ref.py``, vectorised
over a batch: dense (B, M, rd) / (B, N, cd) tensor ops, leave-one-out
products from exclusive prefix and suffix products, and a per-sample
``done`` freeze in place of the early stop (the same result, since frozen
messages stop evolving).  The loop runs a fixed ``max_loops`` times with
no host synchronisation, as ``lax.fori_loop`` runs the JAX version; no
value is read back inside it.

The prefix and suffix products multiply left to right (right to left), one
slot at a time, as the JAX package's cumulative products do on the CPU;
``torch.cumprod`` rounds in another order.  Every op is an elementwise
IEEE f32 op or a gather, so the card and the CPU give the same bits, and
the JAX package's posteriors lie within an f32 ulp of the port's
(tests/test_torch_bp.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CLIP = 0.9999999999  # rounds to 1.0 in f32, as in the JAX package
TINY = 1e-40


@dataclass(frozen=True)
class BPGraphArrays:
    """The padded index structure of a parity-check matrix, as tensors on
    one device."""

    row_cols: torch.Tensor   # (M, rd) int64, padding clamped to 0
    row_mask: torch.Tensor   # (M, rd) bool
    col_rows: torch.Tensor   # (N, cd) int64
    col_mask: torch.Tensor   # (N, cd) bool
    col_slot: torch.Tensor   # (N, cd) int64: slot within the check's row
    inv_n: torch.Tensor      # (M, rd) int64: variable of a check-side slot
    inv_u: torch.Tensor      # (M, rd) int64: its variable-side slot
    N: int
    M: int

    @classmethod
    def from_ref(cls, g, device="cpu") -> "BPGraphArrays":
        """Build from a ``data.bp_ref.BPGraph``."""
        M, rd = g.row_cols.shape
        N, cd = g.col_rows.shape
        inv_n = np.zeros((M, rd), np.int64)
        inv_u = np.zeros((M, rd), np.int64)
        for n in range(N):
            for u in range(cd):
                if g.col_mask[n, u]:
                    m, slot = g.col_rows[n, u], g.col_slot[n, u]
                    inv_n[m, slot] = n
                    inv_u[m, slot] = u

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return cls(
            row_cols=t(np.maximum(g.row_cols, 0)),
            row_mask=t(g.row_mask, torch.bool),
            col_rows=t(np.maximum(g.col_rows, 0)),
            col_mask=t(g.col_mask, torch.bool),
            col_slot=t(np.maximum(g.col_slot, 0)),
            inv_n=t(inv_n), inv_u=t(inv_u), N=int(N), M=int(M))


def _loo_prod(v: torch.Tensor):
    """Leave-one-out products along the last axis, and the full product.

    Slot i gets (v_0 * ... * v_{i-1}) * (v_{i+1} * ... * v_{D-1}), the
    prefix multiplied left to right and the suffix right to left; padded
    slots must hold 1."""
    D = v.shape[-1]
    ones = torch.ones_like(v[..., 0])
    fwd = [ones, v[..., 0]]
    for i in range(1, D - 1):
        fwd.append(fwd[-1] * v[..., i])
    bwd = [ones, v[..., D - 1]]
    for i in range(D - 2, 0, -1):
        bwd.append(bwd[-1] * v[..., i])
    loo = torch.stack(fwd[:D], -1) * torch.stack(bwd[:D][::-1], -1)
    return loo, fwd[D - 1] * v[..., D - 1]


def bp_decode_batch(graph: BPGraphArrays, bias: torch.Tensor,
                    max_loops: int = 100, return_posterior: bool = False):
    """Decode a batch against the all-zero syndrome, on ``bias``'s device
    (``graph`` must be there too).

    bias: (B, N) float, P(bit = 1).  Returns (x (B, N) int32 hard
    decisions, success (B,) bool, iters (B,) int32: the iteration at which
    each word converged, max_loops where it did not[, q1 (B, N) float32
    posteriors P(bit = 1), frozen at each word's convergence, with
    ``return_posterior``])."""
    g = graph
    if bias.device != g.row_cols.device:
        raise ValueError(f"bias on {bias.device}, the graph on "
                         f"{g.row_cols.device}")
    bias = bias.float()
    B = bias.shape[0]
    prior0 = 1.0 - bias                                    # (B, N)
    prior1 = bias
    one = bias.new_ones(())
    dqc = torch.where(g.row_mask, (1.0 - 2.0 * bias)[:, g.row_cols], one)
    q1 = torch.full_like(bias, 0.49)
    done = torch.zeros(B, dtype=torch.bool, device=bias.device)
    iters = torch.zeros(B, dtype=torch.int32, device=bias.device)

    for _ in range(max_loops):
        # ---- check pass (z = 0 everywhere) ----
        dpc = 0.5 * _loo_prod(dqc)[0]                      # (B, M, rd)
        pc0 = 0.5 + dpc
        pc1 = 0.5 - dpc
        # the variable-side view
        pc0_v = torch.where(g.col_mask, pc0[:, g.col_rows, g.col_slot], one)
        pc1_v = torch.where(g.col_mask, pc1[:, g.col_rows, g.col_slot], one)
        # ---- variable pass ----
        loo0, all0 = _loo_prod(pc0_v)
        loo1, all1 = _loo_prod(pc1_v)
        qt0 = prior0 * all0
        qt1 = prior1 * all1
        tot = qt0 + qt1
        q1_new = torch.where(tot > TINY, qt1 / tot.clamp_min(TINY), q1)
        qc0 = prior0[..., None] * loo0
        qc1 = prior1[..., None] * loo1
        s = qc0 + qc1
        d = torch.where(s > TINY, (qc0 - qc1) / s.clamp_min(TINY),
                        torch.zeros((), device=s.device))
        d = d.clamp(-CLIP, CLIP)
        dqc_new = torch.where(g.row_mask, d[:, g.inv_n, g.inv_u], one)
        # freeze the decoded words
        dqc = torch.where(done[:, None, None], dqc, dqc_new)
        q1 = torch.where(done[:, None], q1, q1_new)
        # ---- score ----
        x = (q1 >= 0.5).to(torch.int32)
        syn = torch.where(g.row_mask, x[:, g.row_cols], 0).sum(-1) % 2
        ok = (syn == 0).all(-1)
        iters = torch.where(done, iters, iters + 1)
        done = done | ok

    x = (q1 >= 0.5).to(torch.int32)
    if return_posterior:
        return x, done, iters, q1
    return x, done, iters
