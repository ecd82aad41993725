"""Typed-edge message passing: the core FGNN conv.

Counterpart of ``fgnn_tpu/ops/typed_mp.py`` for this slice: the
NO_EXTENSION conv over a shared 2-D table.  Per destination node i and
neighbour slot k (source j = nn_idx[i, k]):

    m[i, k] = sum_t etype[i, k, t] * (W_t x[j])

aggregated over k by max, (1/g) logsumexp(g .), mean or sum, then a bias.
Padded slots (self loops) contribute real messages: nothing is masked, as
in the JAX package.

``filters`` keeps the JAX layout (C_in, C_out * T) with column c * T + t,
so weights carry across unchanged.  A ``GatherTable`` is checked and
classified once, on the host:

* ``broadcast``: a single source row (N_src == 1), the LDPC global-factor
  f2v conv; an exact broadcast;
* ``identity``: nn_idx.ravel() == arange(N_src), the global-factor v2f
  conv; an exact reshape;
* ``gather``: everything else, which runs the typed-mp forward kernel
  (``ops/fused_mp.py``) on h = x @ W_tmajor.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import fused_mp

_NO_EXT = ("only NO_EXTENSION typed message passing is ported: the DIFF/"
           "NEIGHBOR mode is ROADMAP.md, port queue item 4")


class Extension(enum.Enum):
    """Edge-input construction variants (the JAX package's names)."""

    NO_EXTENSION = 0
    ORIG_WITH_NEIGHBOR = 1
    ORIG_WITH_DIFF = 2


def aggregate(msgs: torch.Tensor, aggregator: str, gamma: float = 3.0,
              dim: int = 2) -> torch.Tensor:
    """Aggregate per-edge messages over the neighbour axis ``dim``."""
    if aggregator == "max":
        return msgs.amax(dim=dim)
    if aggregator == "softmax":
        return torch.logsumexp(gamma * msgs, dim=dim) * (1.0 / gamma)
    if aggregator == "mean":
        return msgs.mean(dim=dim)
    if aggregator == "sum":
        return msgs.sum(dim=dim)
    raise ValueError(f"unknown aggregator {aggregator!r}")


class GatherTable(nn.Module):
    """A shared (Nd, K) gather table over ``n_src`` source rows.

    The indices are checked and the shortcut is chosen once, here, on the
    host; the table itself is a non-persistent buffer, so it moves with
    ``.to(device)`` and stays out of the state dict."""

    def __init__(self, idx, n_src: int):
        super().__init__()
        idx = np.array(idx)
        if idx.ndim != 2 or idx.size == 0 \
                or not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(f"a gather table is a non-empty 2-D integer "
                             f"array; got {idx.dtype} {idx.shape}")
        if idx.min() < 0 or idx.max() >= n_src:
            raise ValueError(f"table indices must lie in [0, {n_src}); got "
                             f"[{idx.min()}, {idx.max()}]")
        self.n_src = int(n_src)
        self.nd, self.k = idx.shape
        if self.n_src == 1:
            self.kind = "broadcast"
        elif idx.size == self.n_src and np.array_equal(
                idx.reshape(-1), np.arange(self.n_src)):
            self.kind = "identity"
        else:
            self.kind = "gather"
        self.register_buffer("idx", torch.as_tensor(idx.astype(np.int32)),
                             persistent=False)

    def extra_repr(self) -> str:
        return f"({self.nd}, {self.k}) over {self.n_src}, {self.kind}"


def tmajor_filters(filters: torch.Tensor, nout: int, T: int) -> torch.Tensor:
    """Reorder columns c * T + t to t * nout + c, so that x @ W reshapes to
    (B, N, T, nout)."""
    cin = filters.shape[0]
    return filters.reshape(cin, nout, T).transpose(1, 2).reshape(cin, T * nout)


def typed_mp_conv(x: torch.Tensor, table, etype: torch.Tensor,
                  filters: torch.Tensor, nout: int, *,
                  extension: Extension = Extension.NO_EXTENSION,
                  aggregator: str = "softmax", gamma: float = 3.0,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The typed-edge graph conv (without norm and activation).

    x: (B, N_src, C_in); table: a ``GatherTable`` (or a host array, checked
    on each call); etype: (B, N_dst, K, T); filters: (C_in, nout * T) with
    column c * T + t; bias: (nout,), added after the aggregation.
    Returns (B, N_dst, nout).
    """
    if extension != Extension.NO_EXTENSION:
        raise NotImplementedError(_NO_EXT)
    if not isinstance(table, GatherTable):
        if isinstance(table, torch.Tensor):
            raise TypeError("pass a GatherTable (built once) or a host "
                            "array, not a tensor")
        table = GatherTable(table, x.shape[1]).to(x.device)
    if table.n_src != x.shape[1]:
        raise ValueError(f"table is over {table.n_src} sources, x has "
                         f"{x.shape[1]}")
    B = x.shape[0]
    T = etype.shape[-1]

    if table.kind == "gather":
        h = torch.matmul(x, tmajor_filters(filters, nout, T))
        h = h.reshape(B, table.n_src, T, nout)
        out = fused_mp.typed_mp_fwd(h, table.idx, etype.contiguous(),
                                    aggregator, gamma)
    else:
        h = torch.matmul(x, filters).reshape(B, table.n_src, nout, T)
        if table.kind == "broadcast":
            hg = h[:, :1, None].expand(B, table.nd, table.k, nout, T)
        else:
            hg = h.reshape(B, table.nd, table.k, nout, T)
        if T == 1:
            msgs = hg[..., 0] * etype
        else:
            msgs = (hg * etype[..., None, :]).sum(dim=-1)
        out = aggregate(msgs, aggregator, gamma)
    if bias is not None:
        out = out + bias
    return out
