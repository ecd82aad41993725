"""Code-aware masked attention: the attention of the Error Correction Code
Transformer (arXiv:2203.14966), whose sparsity comes from the code's
parity-check matrix (``data.ldpc_graph.code_mask``) and not from a gather
table.

For q, k, v (B, h, L, d) and the code's boolean mask (L, L), True where
query i may attend to key j,

    out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(d), masked to -inf) v_j

Every row of a code's mask holds its diagonal, so no row is all masked.

Two routes, by the tensors' device; nothing falls back:

* on a CUDA tensor, ``torch.nn.functional.scaled_dot_product_attention``
  with the mask broadcast over batch and heads, pinned to its
  memory-efficient back end (``SDPA_BACKEND``): the one that takes
  f32 and an arbitrary mask, where flash attention takes neither and
  cuDNN's takes no f32.  A call the back end refuses raises;
* the plain route (``plain_attention``: scores, mask, softmax, weighted
  sum, in PyTorch ops) on the CPU, which has no memory-efficient kernel.

Each call runs inside an ``attention`` span (``utils.profiling.annotate``)
that holds the masked attention alone, and counts itself in
``fused_mp.CODE_ATTENTION_COUNTS``: ``kernel_launches`` for a call of
torch's memory-efficient attention, ``plain_calls`` for the plain route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from .fused_mp import CODE_ATTENTION_COUNTS

SDPA_BACKEND = "EFFICIENT_ATTENTION"  # a torch.nn.attention.SDPBackend


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The plain route: dense scores, -inf where ``mask`` is False, the
    softmax over keys and the weighted sum of v."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    scores = scores.masked_fill(mask.logical_not(), float("-inf"))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _sdpa(q, k, v, mask):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def code_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked attention of q, k, v (B, h, L, d) under the code's boolean
    ``mask`` (L, L), on their device."""
    if mask.dtype != torch.bool or mask.shape != (q.shape[-2], k.shape[-2]):
        raise ValueError(f"mask must be a bool ({q.shape[-2]}, "
                         f"{k.shape[-2]}); got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    with annotate("attention"):
        if q.is_cuda:
            CODE_ATTENTION_COUNTS["kernel_launches"] += 1
            return _sdpa(q, k, v, mask)
        CODE_ATTENTION_COUNTS["plain_calls"] += 1
        return plain_attention(q, k, v, mask)
