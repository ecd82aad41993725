"""The Error Correction Code Transformer (ECCT; Choukroun & Wolf, NeurIPS
2022, arXiv:2203.14966) over a binary linear code's parity-check matrix.

A received word y (B, n) at unit amplitude (BPSK +-1 plus noise) becomes
n + m tokens: the bits' magnitudes |y| and the bipolar syndrome 1 - 2 s of
the hard decisions b = 1[y > 0] (s = H b mod 2, computed on the device).
Token i is h_i * W_i, a learned (n + m, d) embedding without bias; N pre-LN
encoder layers follow,

    x <- x + MHA(LN(x), mask)
    x <- x + W2 GELU(W1 LN(x) + b1) + b2

(heads of width d / h, a 4 d feed-forward width, the exact erf GELU, no
dropout), with one more LayerNorm after layer N / 2 (``mid_norm``, as the
authors' public code has it) and a final one; then ``Linear(d, 1)`` per
token gives (B, n + m) and ``Linear(n + m, n)`` one logit per bit.  A
positive logit says the channel flipped the bit: the decoded word is b XOR
1[logit > 0], and the loss is the BCE of the logits against the flips.

The attention is the code-aware masked attention (``ops/code_attention.py``)
under the mask of the paper's Algorithm 1 (``data.ldpc_graph.code_mask``),
whose row and column tables the model builds once beside the mask
(``tables``, a ``CodeTables`` of non-persistent buffers).
Every linear map is the port's ``Dense``, so the compute-dtype policy
(``models/policy.py``) reaches the model; the LayerNorms compute in their
input's dtype with f32 parameters cast to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.ldpc_graph import code_mask, syndrome
from ..ops.code_attention import CodeTables, code_attention
from .norm import Dense, uniform_


class LayerNorm(nn.LayerNorm):
    """torch's LayerNorm over the last axis (eps 1e-5), its parameters
    cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class CodeSelfAttention(nn.Module):
    """Multi-head self-attention under the code's mask: Dense q, k, v and
    output maps of width d, ``heads`` heads of width d / heads."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"heads {heads}")
        self.heads = heads
        self.q, self.k, self.v, self.o = (Dense(d_model, d_model)
                                          for _ in range(4))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                tables: CodeTables) -> torch.Tensor:
        B, L, d = x.shape

        def split(t):
            return t.view(B, L, self.heads, d // self.heads).transpose(1, 2)

        a = code_attention(split(self.q(x)), split(self.k(x)),
                           split(self.v(x)), mask, tables)
        return self.o(a.transpose(1, 2).reshape(B, L, d))


class EncoderLayer(nn.Module):
    """One pre-LN encoder layer: masked self-attention, then the GELU
    feed-forward of width 4 d, each with its residual."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.attn = CodeSelfAttention(d_model, heads)
        self.norm2 = LayerNorm(d_model)
        self.ff1 = Dense(d_model, 4 * d_model)
        self.ff2 = Dense(4 * d_model, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                tables: CodeTables) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask, tables)
        return x + self.ff2(F.gelu(self.ff1(self.norm2(x))))


class ECCT(nn.Module):
    """ECCT of the code whose parity-check matrix is ``checks_mask`` (m, n)
    (nonzero where check i holds bit j) over words of ``n`` bits:
    ``forward(y)`` maps received words at unit amplitude (B, n) to one
    logit per bit (B, n)."""

    def __init__(self, n: int, checks_mask, d_model: int = 128,
                 n_layers: int = 6, heads: int = 8):
        super().__init__()
        h = np.asarray(checks_mask) != 0
        if h.ndim != 2 or h.shape[1] != n:
            raise ValueError(f"checks_mask must be (m, {n}); got {h.shape}")
        m = h.shape[0]
        self.n, self.m = n, m
        self.register_buffer("h", torch.as_tensor(h, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("mask", torch.as_tensor(code_mask(h)),
                             persistent=False)
        self.tables = CodeTables(self.mask)
        self.embed = nn.Parameter(torch.empty(n + m, d_model))
        self.layers = nn.ModuleList(EncoderLayer(d_model, heads)
                                    for _ in range(n_layers))
        self.mid_norm = LayerNorm(d_model) if n_layers > 1 else None
        self.norm = LayerNorm(d_model)
        self.token_out = Dense(d_model, 1)
        self.bit_out = Dense(n + m, n)

    def init_(self, generator: torch.Generator) -> None:
        """The embedding's Xavier uniform draw (the authors' init)."""
        bound = math.sqrt(6.0 / sum(self.embed.shape))
        uniform_(self.embed, -bound, bound, generator)

    def tokens(self, y: torch.Tensor) -> torch.Tensor:
        """The n + m token values [|y| ; 1 - 2 s] (B, n + m)."""
        bits = (y > 0).to(self.h.dtype)
        s = syndrome(bits, self.h).to(y.dtype)
        return torch.cat([y.abs(), 1.0 - 2.0 * s], dim=-1)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = self.tokens(y).unsqueeze(-1) * self.embed
        for i, layer in enumerate(self.layers, start=1):
            x = layer(x, self.mask, self.tables)
            if self.mid_norm is not None and i == len(self.layers) // 2:
                x = self.mid_norm(x)
        t = self.token_out(self.norm(x)).squeeze(-1)
        return self.bit_out(t)
