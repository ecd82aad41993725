"""Plain reference of the Error Correction Code Transformer (ECCT;
Choukroun & Wolf, NeurIPS 2022, arXiv:2203.14966) on MacKay's (96, 48)
code: its forward, its loss and its parameter tree.

Written from the paper's equations in plain PyTorch over a dict of
parameters named as the configuration's parameter tree, with the code's
parity-check matrix from the benchmark's own copy of the code files: the
``A2`` matrix, whose checks every word the generator sends satisfies.
Tokens: the received word at unit amplitude y / 10^(snr/20) gives |y|
(96) and the bipolar syndrome 1 - 2 (H b mod 2) of b = 1[y > 0] (48);
token i is h_i W_i.  Each of the N pre-LN layers adds multi-head attention over the
code's mask (the paper's Algorithm 1: each token itself, the bits of one
check with each other and with that check's token; masked scores -inf
before an explicit softmax; dense over all 144 x 144 pairs) and a GELU
(erf) feed-forward of width 4 d; one more LayerNorm after layer N / 2
(the authors' public code), a final one, Linear(d, 1) per token and
Linear(144, 96).  LayerNorm as torch's (biased variance, eps 1e-5).  The
loss: BCE of the logits against the bits the channel flipped,
1[b != codeword].

A ``Counter`` counts 2 per multiply-add of every dense layer and 4 d/h per
allowed pair of the mask per head (the scores and the weighted sum over
the allowed pairs only, no masked work).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..traffic.ldpc_words import CODES, read_alist
from . import common as C

N_BITS, N_CHECKS = 96, 48
N_TOKENS = N_BITS + N_CHECKS


@functools.lru_cache(maxsize=None)
def parity_check() -> np.ndarray:
    """H (48, 96) as uint8 from the checks of ``codes/96.3.963/A2``: the
    matrix of the [s ; G s] words the generator sends (96.3.963 with three
    ones added, of full rank 48)."""
    _, rows = read_alist(os.path.join(CODES, "A2"))
    h = np.zeros((N_CHECKS, N_BITS), np.uint8)
    for i, row in enumerate(rows):
        h[i, row] = 1
    return h


@functools.lru_cache(maxsize=None)
def mask() -> np.ndarray:
    """The code's attention mask (144, 144), True where query i may
    attend to key j (Algorithm 1)."""
    h = parity_check()
    out = np.eye(N_TOKENS, dtype=bool)
    for i in range(N_CHECKS):
        for a in np.flatnonzero(h[i]):
            for b in np.flatnonzero(h[i]):
                out[a, b] = True
            out[a, N_BITS + i] = out[N_BITS + i, a] = True
    return out


def allowed_pairs() -> int:
    return int(mask().sum())


def ln_spec(name, d):
    return [(f"{name}.weight", (d,), "bn_w"), (f"{name}.bias", (d,), "b")]


def specs(cfg) -> list:
    """(name, shape, init kind) of every parameter."""
    d, n = cfg["dims"], cfg["layers"]
    out = [("embed", (N_TOKENS, d), "w")]
    for i in range(n):
        p = f"layers.{i}"
        out += ln_spec(f"{p}.norm1", d)
        for m in "qkvo":
            out += C.dense_spec(f"{p}.attn.{m}", d, d)
        out += (ln_spec(f"{p}.norm2", d)
                + C.dense_spec(f"{p}.ff1", d, 4 * d)
                + C.dense_spec(f"{p}.ff2", 4 * d, d))
    if n > 1:
        out += ln_spec("mid_norm", d)
    return (out + ln_spec("norm", d) + C.dense_spec("token_out", d, 1)
            + C.dense_spec("bit_out", N_TOKENS, N_BITS))


class Tables:
    """H and the mask on ``device``: H in each dtype it is asked for."""

    def __init__(self, device):
        self.device = device
        self.mask = torch.as_tensor(mask(), device=device)
        self._h = torch.as_tensor(parity_check(), device=device)

    def h(self, dtype):
        return self._h.to(dtype)


def layer_norm(x, P, name, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * P[f"{name}.weight"]
            + P[f"{name}.bias"])


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(x, P, name, heads, mask, ctr=None):
    B, L, d = x.shape
    dh = d // heads

    def split(t):
        return t.reshape(B, L, heads, dh).permute(0, 2, 1, 3)

    q, k, v = (split(C.dense(x, P, f"{name}.{m}", ctr)) for m in "qkv")
    if ctr is not None:
        ctr.flops += 4 * dh * int(mask.sum()) * B * heads
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    s = s.masked_fill(~mask, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = (e / e.sum(dim=-1, keepdim=True)) @ v
    return C.dense(a.permute(0, 2, 1, 3).reshape(B, L, d), P, f"{name}.o",
                   ctr)


def forward(P, cfg, tabs, y, ctr=None):
    """Logits (B, 96) of received words at unit amplitude y (B, 96)."""
    n, heads = cfg["layers"], cfg["heads"]
    bits = (y > 0).to(y.dtype)
    s = torch.remainder(bits @ tabs.h(y.dtype).t(), 2)
    tok = torch.cat([y.abs(), 1.0 - 2.0 * s], dim=-1)
    x = tok[..., None] * P["embed"]
    for i in range(n):
        p = f"layers.{i}"
        x = x + attention(layer_norm(x, P, f"{p}.norm1"), P, f"{p}.attn",
                          heads, tabs.mask, ctr)
        h = gelu(C.dense(layer_norm(x, P, f"{p}.norm2"), P, f"{p}.ff1", ctr))
        x = x + C.dense(h, P, f"{p}.ff2", ctr)
        if n > 1 and i + 1 == n // 2:
            x = layer_norm(x, P, "mid_norm")
    t = C.dense(layer_norm(x, P, "norm"), P, "token_out", ctr)[..., 0]
    return C.dense(t, P, "bit_out", ctr)


def unit_amplitude(y, snr_db):
    """y / 10^(snr_db / 20), per word."""
    return y / torch.pow(10.0, snr_db / 20.0)[:, None]


def flips(y, label):
    """1[(y > 0) != label], the bits the channel flipped, in y's dtype."""
    return ((y > 0) != (label != 0)).to(y.dtype)
