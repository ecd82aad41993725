"""Typed-edge message passing: the core FGNN conv.

Counterpart of ``fgnn_tpu/ops/typed_mp.py`` over a shared 2-D table.  Per
destination node i and neighbour slot k (source j = nn_idx[i, k]):

    NO_EXTENSION        m[i, k] = sum_t etype[i, k, t] * (W_t x[j])
    ORIG_WITH_DIFF      m[i, k] = sum_t etype[i, k, t] * (W_t [x_i ; x_i - x_j])
    ORIG_WITH_NEIGHBOR  m[i, k] = sum_t etype[i, k, t] * (W_t [x_i ; x_j])

aggregated over k by max, (1/g) logsumexp(g .), mean or sum, then a bias.
Padded slots (self loops) contribute real messages: nothing is masked, as
in the JAX package.  The extensions split their (2 C_in, nout T) filter
bank W = [W_self ; W_nbr] as the JAX package does: [x_i ; x_i - x_j] W =
x_i (W_self + W_nbr) - x_j W_nbr and [x_i ; x_j] W = x_i W_self + x_j W_nbr,
so the matmuls run once per node and each edge adds two gathered rows; they
index x by destination, so they need N_dst == N_src.

``filters`` keeps the JAX layout (C_in, C_out * T) with column c * T + t,
so weights carry across unchanged.  A ``GatherTable`` is checked and
classified once, on the host:

* ``broadcast``: a single source row (N_src == 1), the LDPC global-factor
  f2v conv; an exact broadcast;
* ``identity``: nn_idx.ravel() == arange(N_src), the global-factor v2f
  conv; an exact reshape;
* ``gather``: everything else, which runs the typed-mp kernels
  (``ops/fused_mp.py``) on h = x @ W_tmajor: the forward, and under
  autograd the backward, which walks the table's transposed form.

The shortcuts serve NO_EXTENSION only: an extension conv runs the kernels'
DIFF/NEIGHBOR mode whatever the table's kind, as the JAX package never
takes a shortcut for one.

Dtypes follow the JAX package under either compute policy
(``models/policy.py``).  A conv whose x is bf16 runs the kernels' bf16
mode, as the TPU kernel runs under the bf16 policy: h = x @ W is computed
in f32 and stored in bf16, etype is taken in f32 (the kernel rounds it to
bf16), and out is bf16.  The shortcuts compute h in f32 from the filters
rounded to x's dtype, round etype to x's dtype, and return f32, as
``fgnn_tpu/ops/typed_mp.py:394-415``.  An f32 x runs the f32 mode
throughout: the port does not round h to bf16 under the f32 policy, as the
TPU's default matmul precision does.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import fused_mp

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
    ``.to(device)`` and stays out of the state dict.

    The transposed table, each source row's in-edges ``e = d * K + k``, is
    built here too, as CSR: the edges of source j are
    ``src_edge[src_ptr[j]:src_ptr[j + 1]]``, in ascending order, so the
    backward sums them in a fixed order (``ops/fused_mp.py``).  Where
    Nd == n_src, so is its form for the DIFF/NEIGHBOR mode, over 2 n_src
    rows (``ext_ptr``, ``ext_edge``): row 2 d lists d's own K edges (the
    self row they all read), row 2 j + 1 lists j's in-edges."""

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
        flat = idx.reshape(-1)
        counts = np.bincount(flat, minlength=self.n_src)
        self.register_buffer("src_ptr", torch.as_tensor(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)),
            persistent=False)
        self.register_buffer("src_edge", torch.as_tensor(
            np.argsort(flat, kind="stable").astype(np.int32)),
            persistent=False)
        ext_ptr = ext_edge = None
        if self.nd == self.n_src:
            edges = np.arange(flat.size)
            rows = np.concatenate([2 * (edges // self.k), 2 * flat + 1])
            order = np.argsort(rows, kind="stable")
            ext_ptr = torch.as_tensor(np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=2 * self.n_src))]
            ).astype(np.int32))
            ext_edge = torch.as_tensor(
                np.concatenate([edges, edges])[order].astype(np.int32))
        self.register_buffer("ext_ptr", ext_ptr, persistent=False)
        self.register_buffer("ext_edge", ext_edge, persistent=False)

    def extra_repr(self) -> str:
        return f"({self.nd}, {self.k}) over {self.n_src}, {self.kind}"


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor in f32, any other unchanged: the type a bf16 conv's
    products accumulate in."""
    return t.float() if t.dtype == torch.bfloat16 else t


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
    column c * T + t, or (2 C_in, nout * T) for the extensions; bias:
    (nout,), added after the aggregation.  Returns (B, N_dst, nout).
    """
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

    if extension != Extension.NO_EXTENSION:
        out = _extension_conv(x, table, etype, filters, nout, extension,
                              aggregator, gamma)
    elif table.kind == "gather":
        h = torch.matmul(_wide(x), tmajor_filters(filters, nout, T))
        h = h.to(x.dtype).reshape(B, table.n_src, T, nout)
        out = fused_mp.typed_mp_fwd(h, table, _wide(etype).contiguous(),
                                    aggregator, gamma)
    else:
        h = torch.matmul(_wide(x), _wide(filters.to(x.dtype)))
        h = h.reshape(B, table.n_src, nout, T)
        if table.kind == "broadcast":
            hg = h[:, :1, None].expand(B, table.nd, table.k, nout, T)
        else:
            hg = h.reshape(B, table.nd, table.k, nout, T)
        et = etype.to(x.dtype)
        if T == 1:
            msgs = hg[..., 0] * et
        else:
            msgs = (hg * et[..., None, :]).sum(dim=-1)
        out = aggregate(msgs, aggregator, gamma)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _extension_conv(x, table: GatherTable, etype, filters, nout: int,
                    extension: Extension, aggregator: str, gamma: float):
    """The DIFF/NEIGHBOR conv through the kernels' extension mode: one
    matmul gives each node its self row x W_a and its neighbour row
    x W_b (the sign folded into W_b), interleaved as (B, 2 N, T, nout),
    in x's dtype."""
    B, N, cin = x.shape
    T = etype.shape[-1]
    if table.nd != N:
        raise ValueError(f"{extension.name} indexes x by destination and "
                         f"needs N_dst == N_src; got a ({table.nd}, "
                         f"{table.k}) table over {N} sources")
    if tuple(filters.shape) != (2 * cin, nout * T):
        raise ValueError(f"{extension.name} takes filters (2 C_in, nout T) "
                         f"= {(2 * cin, nout * T)}; got "
                         f"{tuple(filters.shape)}")
    w_self, w_nbr = filters[:cin], filters[cin:]
    if extension == Extension.ORIG_WITH_DIFF:
        w_a, w_b = w_self + w_nbr, -w_nbr
    elif extension == Extension.ORIG_WITH_NEIGHBOR:
        w_a, w_b = w_self, w_nbr
    else:
        raise ValueError(f"unknown extension {extension}")
    w = torch.cat([tmajor_filters(w_a, nout, T),
                   tmajor_filters(w_b, nout, T)], dim=1)
    h = torch.matmul(_wide(x), w).to(x.dtype).reshape(B, 2 * N, T, nout)
    return fused_mp.typed_mp_fwd(h, table, _wide(etype).contiguous(),
                                 aggregator, gamma, ext=True)


def gather_nodes(x: torch.Tensor, nn_idx) -> torch.Tensor:
    """Per-edge source rows: x (B, N_src, C) and nn_idx (N_dst, K), shared
    by the batch, or (B, N_dst, K), per sample; returns (B, N_dst, K, C).

    Plain indexing (the JAX package's one-hot product is a TPU layout
    choice).  ``nn_idx`` is a host array or a tensor; its range is checked
    on the host, as ``GatherTable`` checks, and any other rank raises
    ``ValueError``."""
    idx = torch.as_tensor(nn_idx)
    if idx.ndim not in (2, 3):
        raise ValueError(f"nn_idx must be rank 2 or 3, got "
                         f"{tuple(idx.shape)}")
    n_src = x.shape[1]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_src):
        raise ValueError(f"nn_idx must lie in [0, {n_src}); got "
                         f"[{int(idx.min())}, {int(idx.max())}]")
    idx = idx.to(device=x.device, dtype=torch.long)
    if idx.ndim == 2:
        return x[:, idx]
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx]
