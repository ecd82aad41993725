"""Code-aware masked attention: the attention of the Error Correction Code
Transformer (arXiv:2203.14966), whose sparsity comes from the code's
parity-check matrix (``data.ldpc_graph.code_mask``) and not from a gather
table.

For q, k, v (B, h, L, d) and the code's boolean mask (L, L), True where
query i may attend to key j,

    out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(d), masked to -inf) v_j

Every row of a code's mask holds its diagonal; a mask with a row that
allows no key raises.

Two routes, by the tensors' device; nothing falls back:

* on a CUDA tensor, the hand-written kernels of ``csrc/code_attention.cu``
  (``CodeAttention``): a forward and a backward that visit only the pairs
  the mask allows, from the mask's row and column tables (``CodeTables``,
  built once per mask on the host).  They read q, k and v in place, in the
  layout the model's views give them (strides (L d, d_h, d, 1) of a (B, L,
  d) map), and write out, dq, dk and dv in q's memory order; f32, or bf16
  with an f32 softmax and f32 sums.  A call the kernels do not take (a head
  width outside ``HEAD_WIDTHS``, too many tokens for a block's shared
  memory) raises;
* the plain route (``plain_attention``: scores, mask, softmax, weighted
  sum, in PyTorch ops) on the CPU.

Each call's forward runs inside an ``attention`` span
(``utils.profiling.annotate``) that holds the masked attention alone, its
first op ``torch.empty_like(q)`` (the benchmark reads the call's shape from
it), and the backward kernel inside an ``attention_bwd`` span.  Calls count
themselves in ``fused_mp.CODE_ATTENTION_COUNTS``: ``kernel_launches`` for
the forward kernel, ``bwd_launches`` for the backward kernel,
``plain_calls`` for the plain route.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.debug import check_kernel_outputs, nan_checks_on
from ..utils.profiling import annotate
from . import fused_mp
from .fused_mp import CODE_ATTENTION_COUNTS, SMEM_PER_BLOCK

HEAD_WIDTHS = (4, 8, 16, 32)  # the kernels' instantiations
ROW_VALUES = 32  # a block stages 32 values of each token: 128 bytes


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The plain route: dense scores, -inf where ``mask`` is False, the
    softmax over keys and the weighted sum of v."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    scores = scores.masked_fill(mask.logical_not(), float("-inf"))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _host_mask(mask) -> np.ndarray:
    m = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask)
    if m.dtype != np.bool_ or m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"the mask must be a square bool (L, L); got "
                         f"{m.dtype} {m.shape}")
    empty = np.flatnonzero(~m.any(axis=1))
    if empty.size:
        raise ValueError(f"rows {empty.tolist()} of the mask allow no key")
    return m


def packed_table(mask: np.ndarray) -> np.ndarray:
    """Each row's allowed columns of a bool ``mask`` (L, L), as the kernels
    read them: one int32 array of the rows longest first (``order``, L;
    ties in row order), their lengths (``count``, L) and the columns by
    step (``key``, (width, L) with width the longest row's length):
    key[n, s] is the n-th allowed column, ascending in n, of row order[s],
    and -1 past its length.  A warp's lanes walk consecutive slots s, so
    each step reads one line of ``key``."""
    counts = mask.sum(axis=1)
    order = np.argsort(-counts, kind="stable")
    width = int(counts.max(initial=0))
    key = np.full((width, mask.shape[0]), -1, np.int64)
    for s, i in enumerate(order):
        cols = np.flatnonzero(mask[i])
        key[:cols.size, s] = cols
    return np.concatenate([order, counts[order], key.ravel()]).astype(
        np.int32)


class CodeTables(nn.Module):
    """The row table (each query's allowed keys) and the column table (each
    key's queries) of a bool mask (L, L), as non-persistent buffers that
    follow the module's device: built once, on the host, from the mask (a
    CUDA mask is read back once).  A row that allows no key raises."""

    def __init__(self, mask):
        super().__init__()
        m = _host_mask(mask)
        self.tokens, self.pairs = m.shape[0], int(m.sum())
        self.register_buffer("rows", torch.as_tensor(packed_table(m)),
                             persistent=False)
        self.register_buffer("cols", torch.as_tensor(packed_table(m.T)),
                             persistent=False)


def heads_per_block(heads: int, dh: int) -> int:
    """The heads a block stages: as many as make ``ROW_VALUES`` values of a
    token (whole rows of 128 bytes, which keeps the gathers free of bank
    conflicts), or fewer where they do not divide ``heads``."""
    return int(np.gcd(heads, max(1, ROW_VALUES // dh)))


def bwd_smem(L: int, heads: int, dh: int) -> int:
    """Shared bytes of a backward block, the larger of the two: q, k, v and
    dO of its heads in f32, their log-sum-exp and D."""
    hg = heads_per_block(heads, dh)
    return 4 * L * hg * dh * 4 + 2 * L * hg * 4


def check_kernel_args(q, k, v, tables: CodeTables) -> None:
    """Raise ``ValueError`` where the kernels do not take q, k, v (B, h, L,
    d_h) with ``tables``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (B, h, L, d_h) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise ValueError(f"q, k, v must be f32 or bf16 on one device; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    _, H, L, dh = q.shape
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"head width {dh}: the kernels take {HEAD_WIDTHS}")
    if L != tables.tokens:
        raise ValueError(f"{L} tokens against a mask of {tables.tokens}")
    if bwd_smem(L, H, dh) > SMEM_PER_BLOCK:
        raise ValueError(f"{L} tokens of head width {dh} do not fit a "
                         f"block's shared memory")
    if tables.rows.device != q.device:
        raise ValueError(f"the tables are on {tables.rows.device}, q on "
                         f"{q.device}")


def _aligned(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place: 4 elements at a time."""
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            and t.data_ptr() % (4 * t.element_size()) == 0)


def in_layout_of(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``t`` in q's memory order, where the kernels read it in place: t
    itself where it is already, else a copy."""
    if t.stride() == q.stride() and _aligned(t):
        return t
    return torch.empty_like(q).copy_(t)


def _dims(q):
    B, H, L, dh = q.shape
    return (B, H, L, dh, heads_per_block(H, dh), *q.stride()[:3],
            dh ** -0.5, int(q.dtype == torch.bfloat16))


def attention_fwd(q, k, v, tables: CodeTables):
    """(out, lse) of the forward kernel: out in q's memory order, the
    log-sum-exp (B, h, L) f32.  k and v in q's layout."""
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    fused_mp._launch("code_attention", "code_attn_fwd", q.device,
                     tuple(q.shape), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), tables.rows.data_ptr(),
                     *_dims(q))
    CODE_ATTENTION_COUNTS["kernel_launches"] += 1
    return out, lse


def attention_bwd(q, k, v, out, lse, dout, tables: CodeTables):
    """(dq, dk, dv) of the backward kernel, in q's memory order; every
    tensor in q's layout."""
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fused_mp._launch("code_attention", "code_attn_bwd", q.device,
                     tuple(q.shape), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     tables.rows.data_ptr(), tables.cols.data_ptr(),
                     *_dims(q))
    CODE_ATTENTION_COUNTS["bwd_launches"] += 1
    return dq, dk, dv


class CodeAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves q, k, v, out and the
    log-sum-exp, the backward launches the backward kernel in an
    ``attention_bwd`` span.  Under ``utils.debug.nan_debug`` the kernels'
    outputs are checked for NaN, as the dispatcher never sees their
    writes."""

    @staticmethod
    def forward(ctx, q, k, v, tables):
        out, lse = attention_fwd(q, k, v, tables)
        check_kernel_outputs("code_attn_fwd", out)
        ctx.tables, ctx.nan_checks = tables, nan_checks_on()
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with annotate("attention_bwd"):
            grads = attention_bwd(q, k, v, out, lse,
                                  in_layout_of(dout.to(q.dtype), q),
                                  ctx.tables)
        check_kernel_outputs("code_attn_bwd", *grads,
                             enabled=ctx.nan_checks or nan_checks_on())
        return (*grads, None)


def code_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor,
                   tables: CodeTables | None = None) -> torch.Tensor:
    """Masked attention of q, k, v (B, h, L, d) under the code's boolean
    ``mask`` (L, L), on their device.  ``tables``: the mask's
    ``CodeTables`` on q's device (the model keeps them beside its mask);
    without them a CUDA call builds them here, reading the mask back."""
    L = q.shape[-2]
    if mask.dtype != torch.bool or mask.shape != (L, k.shape[-2]):
        raise ValueError(f"mask must be a bool ({L}, {k.shape[-2]}); got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not q.is_cuda:
        if not bool(mask.any(dim=-1).all()):
            raise ValueError("a row of the mask allows no key")
        with annotate("attention"):
            CODE_ATTENTION_COUNTS["plain_calls"] += 1
            return plain_attention(q, k, v, mask)
    if tables is None:
        tables = CodeTables(mask).to(q.device)
    check_kernel_args(q, k, v, tables)
    with annotate("attention"):
        if not _aligned(q):
            q = q.clone(memory_format=torch.contiguous_format)
        return CodeAttention.apply(q, in_layout_of(k, q), in_layout_of(v, q),
                                   tables)
