"""Segment (COO edge-list) aggregation ops (counterpart of
``fgnn_tpu/ops/segment.py``).

The COO form generalises the dense gather tables of ``ops/typed_mp.py``:
edges are a flat list ``(src[e], dst[e])`` with per-edge type weights,
and messages combine into destinations with masked segment reductions.
It batches graphs of different sizes as one flat disjoint union
(``graph.build_joint_coo``).  The JAX package runs these ops as
``jax.ops.segment_*``; no Pallas kernel backs them, so the port runs them
as PyTorch ops too.

**Deterministic by construction.**  ``index_add_``,
``scatter_reduce``, ``index_put_(accumulate=True)`` and the backward of
``x[idx]`` add with atomics on CUDA, in an order that changes from run to
run.  None of them runs here.  A ``Segments`` groups the edges of an index
array by segment once, on the host: a padded table ``(n, W)`` lists the
edges of segment i in ascending order (the padding points at one extra
row), and ``pos[e]`` is the flat slot of edge e in that table.  Then

* a segment reduction gathers its rows into the padded table
  (``index_select``) and reduces along the table's second dimension:
  ``sum`` for sum and mean, ``amax`` for max and the softmax's shift;
* the backward of that gather is a gather too (each edge has one slot:
  ``grad.view(n * W, C)[pos]``);
* ``gather(x, seg)`` (``x[ids]``) has, as its backward, the padded-table
  sum of the cotangent's rows;

each a ``torch.autograd.Function`` whose backward gathers and never
scatters.  So two runs on one device give the same bits, forward and
backward, without ``torch.use_deterministic_algorithms``.

Semantics are the JAX package's: masked edges take -1e30 in max and
softmax and 0 in sum and mean; mean divides by the destination's valid
edges (at least 1); max returns 0 where a destination has no edge or
only masked ones (out <= -5e29); the softmax's shift m is 0 where it is
not finite and its sum is floored at 1e-30.  Max's gradient splits evenly
among tied maxima (``amax``'s rule, and ``jax.ops.segment_max``'s), which
the dense kernels' first-win argmax does not: so a COO graph never runs
the typed-mp kernels, whatever its degrees.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

_NEG_INF = -1e30


def _host(a) -> np.ndarray:
    """A flat numpy array of ``a`` (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).reshape(-1)


def _host_ints(a, what: str) -> np.ndarray:
    a = _host(a)
    if a.size and not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{what} must be integers; got {a.dtype}")
    return a.astype(np.int64)


class Segments(nn.Module):
    """Edges grouped by ``ids`` (ids[e] in [0, n)), once, on the host.

    ``table`` (n, W): the edges of segment i in ascending order, padded
    with E, the index of one extra row (W = the largest segment, at least
    1); ``pos`` (E,): the flat slot of edge e in ``table``; ``count``
    (n,): edges per segment, in f32.  The index arrays are non-persistent
    buffers: they move with ``.to(device)`` and stay out of the state
    dict."""

    def __init__(self, ids, n: int):
        super().__init__()
        ids = _host_ints(ids, "segment ids")
        n = int(n)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"segment ids must lie in [0, {n}); got "
                             f"[{ids.min()}, {ids.max()}]")
        E = ids.size
        count = np.bincount(ids, minlength=n)
        width = max(1, int(count.max()) if n else 1)
        order = np.argsort(ids, kind="stable")
        start = np.concatenate([[0], np.cumsum(count)])[:-1]
        sorted_ids = ids[order]
        slot = np.arange(E) - start[sorted_ids]
        table = np.full((n, width), E, np.int64)
        table[sorted_ids, slot] = order
        pos = np.empty(E, np.int64)
        pos[order] = sorted_ids * width + slot
        self.n, self.width, self.n_edges = n, width, E
        self.padded = bool((count < width).any())
        self.register_buffer("ids", torch.from_numpy(ids), persistent=False)
        self.register_buffer("table", torch.from_numpy(table),
                             persistent=False)
        self.register_buffer("pos", torch.from_numpy(pos), persistent=False)
        self.register_buffer("count", torch.from_numpy(
            count.astype(np.float32)), persistent=False)

    def extra_repr(self) -> str:
        return f"{self.n_edges} edges in {self.n} segments, width {self.width}"


def segment_bins(seg, num_segments: int) -> Segments:
    """The nodes of a disjoint union grouped by sample: ``seg`` is each
    node's sample id, -1 (or any negative) for padding, which goes to an
    extra bin ``num_segments``."""
    seg = _host_ints(seg, "seg")
    return Segments(np.where(seg >= 0, seg, num_segments), num_segments + 1)


def _padded(flat: torch.Tensor, seg: Segments, fill: float) -> torch.Tensor:
    """(n, W, C): the rows of ``flat`` (E, C) in ``seg``'s table."""
    if seg.padded:
        flat = torch.cat([flat, flat.new_full((1, flat.shape[1]), fill)])
    return flat.index_select(0, seg.table.view(-1)).view(
        seg.n, seg.width, flat.shape[1])


def _table_sum(rows: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Per segment, the sum of its edges' rows of ``rows`` (E, ...), in
    ascending edge order."""
    flat = rows.reshape(rows.shape[0], -1)
    return _padded(flat, seg, 0.0).sum(dim=1).view(seg.n, *rows.shape[1:])


class _Pad(torch.autograd.Function):
    """data (E, ...) -> (n, W, ...) laid out by ``seg.table``, ``fill`` in
    the padding; backward gathers each edge's slot."""

    @staticmethod
    def forward(ctx, data, seg, fill):
        ctx.seg, ctx.shape = seg, data.shape
        out = _padded(data.reshape(data.shape[0], -1), seg, fill)
        return out.view(seg.n, seg.width, *data.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        seg = ctx.seg
        grad = grad.reshape(seg.n * seg.width, -1).index_select(0, seg.pos)
        return grad.view(ctx.shape), None, None


class _Gather(torch.autograd.Function):
    """x[seg.ids]; backward: each row's cotangents summed in edge order."""

    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.ids)

    @staticmethod
    def backward(ctx, grad):
        return _table_sum(grad, ctx.seg), None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg):
        ctx.seg = seg
        return _table_sum(data, seg)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.seg.ids), None


def _check_edges(data: torch.Tensor, seg: Segments) -> None:
    if data.shape[0] != seg.n_edges:
        raise ValueError(f"data has {data.shape[0]} rows; the segments "
                         f"group {seg.n_edges}")


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``x[seg.ids]``, x (n, ...), with a backward that does not scatter."""
    if x.shape[0] != seg.n:
        raise ValueError(f"x has {x.shape[0]} rows; the segments index "
                         f"{seg.n}")
    return _Gather.apply(x, seg)


def segment_sum(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    _check_edges(data, seg)
    return _SegmentSum.apply(data, seg)


def segment_max(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    """-inf for an empty segment; the gradient splits among ties."""
    _check_edges(data, seg)
    return _Pad.apply(data, seg, float("-inf")).amax(dim=1)


def segment_mean(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    cnt = seg.count.to(data.dtype).clamp_min(1.0)
    return segment_sum(data, seg) / cnt.view(-1, *(1,) * (data.ndim - 1))


def segment_logsumexp(data: torch.Tensor, seg: Segments,
                      gamma: float = 3.0) -> torch.Tensor:
    """(1/gamma) logsumexp(gamma x) per segment, shifted by its max."""
    _check_edges(data, seg)
    padded = _Pad.apply(data, seg, float("-inf"))
    m = padded.amax(dim=1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(gamma * (padded - m.unsqueeze(1))).sum(dim=1)
    return m + (1.0 / gamma) * torch.log(s.clamp_min(1e-30))


class CooGraph(nn.Module):
    """A flat COO graph: one graph, or the disjoint union of several
    (``graph.build_joint_coo``).  Passed to ``MPConv`` and ``FactorMPNN``
    in place of a ``GatherTable``.

    src/dst:      (E,) edge endpoints; dst in [0, num_nodes), src in
                  [0, num_src) (num_src defaults to num_nodes)
    edge_mask:    (E,) bool, False for padding edges, or None
    num_nodes:    destination count (the aggregation's segments)
    seg:          (num_nodes,) sample id per node (-1: padding), for the
                  per-sample InstanceNorm of a disjoint union, or None
    num_segments: samples in the union

    Built once, on the host: the edges by destination (``by_dst``) and by
    source (``by_src``), the valid edges per destination (``mean_count``,
    at least 1), and with ``seg`` the nodes by sample (``bins``).  Where
    every edge is valid the mask is not applied at all: the result is the
    same.
    """

    def __init__(self, src, dst, edge_mask=None, num_nodes: int = 0,
                 seg=None, num_segments: int = 1,
                 num_src: Optional[int] = None):
        super().__init__()
        src = _host_ints(src, "src")
        dst = _host_ints(dst, "dst")
        if src.shape != dst.shape:
            raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
        self.num_nodes = int(num_nodes)
        self.num_src = self.num_nodes if num_src is None else int(num_src)
        self.num_segments = int(num_segments)
        mask = (np.ones(src.shape, bool) if edge_mask is None
                else _host(edge_mask).astype(bool))
        if mask.shape != src.shape:
            raise ValueError(f"edge_mask {mask.shape}, edges {src.shape}")
        self.masked = not mask.all()
        self.register_buffer("src", torch.from_numpy(src), persistent=False)
        self.register_buffer("dst", torch.from_numpy(dst), persistent=False)
        self.register_buffer("edge_mask", None if edge_mask is None
                             else torch.from_numpy(mask), persistent=False)
        self.by_dst = Segments(dst, self.num_nodes)
        self.by_src = Segments(src, self.num_src)
        valid = np.bincount(dst[mask], minlength=self.num_nodes)
        self.register_buffer("mean_count", torch.from_numpy(
            np.maximum(valid, 1).astype(np.float32)), persistent=False)
        if seg is None:
            self.register_buffer("seg", None, persistent=False)
            self.bins = None
        else:
            seg = _host_ints(seg, "seg")
            self.register_buffer("seg", torch.from_numpy(seg),
                                 persistent=False)
            self.bins = segment_bins(seg, self.num_segments)

    @property
    def n_edges(self) -> int:
        return self.by_dst.n_edges

    def extra_repr(self) -> str:
        return (f"{self.n_edges} edges, {self.num_src} -> {self.num_nodes} "
                f"nodes, {self.num_segments} segments"
                + (", masked" if self.masked else ""))


def typed_mp_conv_coo(x: torch.Tensor, graph: CooGraph, etype: torch.Tensor,
                      filters: torch.Tensor, nout: int, *,
                      aggregator: str = "max", gamma: float = 3.0,
                      bias: Optional[torch.Tensor] = None,
                      extension: str = "none") -> torch.Tensor:
    """COO-form typed message passing over ``graph``.

    x: (num_src, C_in) (the extensions index x by destination too, so they
    need num_src == num_nodes); etype: (E, T); filters: (C_in, nout * T),
    column c * T + t, or (2 C_in, nout * T) for the extensions;
    extension: 'none' | 'diff' ([x_i ; x_i - x_j]) | 'neighbor'
    ([x_i ; x_j]), factored as in ``ops/typed_mp.py``: the matmuls run per
    node and each edge adds two gathered rows.  Returns (num_nodes, nout).

    Dtypes promote as the JAX package's do: x @ filters, with a bf16 x and
    f32 filters, is computed and returned in f32 (x cast up, exactly).
    """
    T = etype.shape[-1]
    if x.shape[0] != graph.num_src:
        raise ValueError(f"x has {x.shape[0]} rows; the graph has "
                         f"{graph.num_src} sources")
    dt = torch.promote_types(x.dtype, filters.dtype)
    xw, fw = x.to(dt), filters.to(dt)
    if extension == "none":
        he = gather(xw @ fw, graph.by_src)
    elif extension in ("diff", "neighbor"):
        if graph.num_src != graph.num_nodes:
            raise ValueError(f"{extension} indexes x by destination and "
                             f"needs num_src == num_nodes; got "
                             f"{graph.num_src} -> {graph.num_nodes}")
        cin = x.shape[-1]
        w_self, w_nbr = fw[:cin], fw[cin:]
        b = gather(xw @ w_nbr, graph.by_src)
        if extension == "diff":
            he = gather(xw @ (w_self + w_nbr), graph.by_dst) - b
        else:
            he = gather(xw @ w_self, graph.by_dst) + b
    else:
        raise ValueError(f"unknown extension {extension!r}")
    mt = torch.promote_types(he.dtype, etype.dtype)
    msgs = torch.einsum("ect,et->ec", he.view(-1, nout, T).to(mt),
                        etype.to(mt))

    mask = graph.edge_mask[:, None] if graph.masked else None
    if aggregator in ("max", "softmax"):
        if mask is not None:
            msgs = torch.where(mask, msgs, _NEG_INF)
        if aggregator == "max":
            out = segment_max(msgs, graph.by_dst)
            out = torch.where(out <= _NEG_INF / 2, 0.0, out)
        else:
            out = segment_logsumexp(msgs, graph.by_dst, gamma)
    elif aggregator in ("mean", "sum"):
        if mask is not None:
            msgs = torch.where(mask, msgs, 0.0)
        out = segment_sum(msgs, graph.by_dst)
        if aggregator == "mean":
            out = out / graph.mean_count.to(out.dtype)[:, None]
    else:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if bias is not None:
        out = out + bias
    return out
