"""Halo-exchange edge-partitioned typed message passing (counterpart of
``fgnn_tpu/parallel/halo.py``): the large-graph scaling mode.

Where ``edge_partition.py`` replicates the source features on every rank,
this shards BOTH the edge list and the source rows over the ``data`` axis
and exchanges only the boundary ("halo") rows that cross a partition, with
one ``all_to_all``.

The plan (``build_halo_plan``, numpy on the host, static per graph; field
for field the JAX package's):

  * destinations are split into contiguous blocks of ``Nd`` rows, one per
    rank, and every edge lives on the rank that owns its destination, so
    each segment reduction is local;
  * sources are split into blocks of ``Ns`` rows; for each (owner p ->
    consumer d) pair the plan lists the rows of p that d's edges read,
    padded to one halo width ``H``, so the exchange is one static
    ``all_to_all`` of (D, H, C);
  * each rank's edges split into a LOCAL-source list, which reads only its
    own block, and a REMOTE-source list, which reads the received rows.

``halo_typed_mp_coo`` issues the exchange asynchronously, aggregates the
local list while it is in flight, then the remote list, and merges the two
partials per destination with the aggregator's exact merge (``_combine``:
a sum for sum and mean, the maximum, and a shifted two-phase merge for the
gamma-logsumexp "softmax"), so the result equals ``typed_mp_conv_coo`` on
the whole graph.  The gathers and reductions are ``ops/segment.py``'s
(their backwards gather, so no atomics); the exchange's backward is the
same exchange of the cotangents.  As in the JAX package, each rank's loss
is its own: the gradients of the replicated filters are partial, and a
trainer reduces them as it does a data-parallel gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.segment import Segments, gather, segment_max, segment_sum
from .comm import all_to_all_start

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static exchange plan for one graph structure (host-side numpy).

    Shapes: D = n_shards, H = halo width (max boundary rows any device needs
    from any other), EL/ER = per-device local/remote edge-slot counts.
    """

    n_shards: int
    n_src: int               # original source-row count
    n_dst: int               # original destination-row count
    src_block: int           # Ns: padded source rows per device
    dst_block: int           # Nd: padded destination rows per device
    halo: int                # H
    send_idx: np.ndarray     # (D, D, H) int32: rows p sends to d (local ids)
    src_loc: np.ndarray      # (D, EL) int32 into the device's own x block
    dst_loc: np.ndarray      # (D, EL) int32 local destination row
    mask_loc: np.ndarray     # (D, EL) bool
    perm_loc: np.ndarray     # (D, EL) int64 original edge index (0 if pad)
    src_rem: np.ndarray      # (D, ER) int32 into the received (D*H) halo rows
    dst_rem: np.ndarray      # (D, ER) int32
    mask_rem: np.ndarray     # (D, ER) bool
    perm_rem: np.ndarray     # (D, ER) int64

    def pad_src(self, x):
        """Zero-pad source features (n_src, C) to (D * Ns, C)."""
        pad = self.n_shards * self.src_block - x.shape[0]
        if pad == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    def shard_edge_data(self, arr: np.ndarray):
        """Reorder per-edge data (E, ...) into the plan's (D, EL, ...) local
        and (D, ER, ...) remote layouts (padding slots zeroed)."""
        arr = np.asarray(arr)
        loc = arr[self.perm_loc] * self.mask_loc.reshape(
            self.mask_loc.shape + (1,) * (arr.ndim - 1)).astype(arr.dtype)
        rem = arr[self.perm_rem] * self.mask_rem.reshape(
            self.mask_rem.shape + (1,) * (arr.ndim - 1)).astype(arr.dtype)
        return loc, rem

    @property
    def comm_rows_per_device(self) -> int:
        """Rows each device ships ((D-1) * H real slots)."""
        return (self.n_shards - 1) * self.halo


def build_halo_plan(src, dst, n_src: int, n_dst: int,
                    n_shards: int) -> HaloPlan:
    """Build the static halo-exchange plan for an edge list.

    src/dst: (E,) int arrays (valid edges only — pad AFTER planning is not
    supported; masked padding slots are created by the plan itself).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    D = int(n_shards)
    Ns = -(-n_src // D)
    Nd = -(-n_dst // D)
    owner_src = src // Ns
    owner_dst = dst // Nd

    shard_edges = [np.nonzero(owner_dst == d)[0] for d in range(D)]
    # Per-shard local/remote split + halo lists.
    needed = [[None] * D for _ in range(D)]   # needed[d][p]: global src ids
    loc_lists, rem_lists = [], []
    H = 1
    for d in range(D):
        e = shard_edges[d]
        is_loc = owner_src[e] == d
        loc_lists.append(e[is_loc])
        rem_lists.append(e[~is_loc])
        for p in range(D):
            if p == d:
                continue
            ids = np.unique(src[e[~is_loc][owner_src[e[~is_loc]] == p]])
            needed[d][p] = ids
            H = max(H, len(ids))

    EL = max(1, max(len(l) for l in loc_lists))
    ER = max(1, max(len(r) for r in rem_lists))

    send_idx = np.zeros((D, D, H), np.int32)
    src_loc = np.zeros((D, EL), np.int32)
    dst_loc = np.zeros((D, EL), np.int32)
    mask_loc = np.zeros((D, EL), bool)
    perm_loc = np.zeros((D, EL), np.int64)
    src_rem = np.zeros((D, ER), np.int32)
    dst_rem = np.zeros((D, ER), np.int32)
    mask_rem = np.zeros((D, ER), bool)
    perm_rem = np.zeros((D, ER), np.int64)

    for d in range(D):
        # position of each needed remote row inside the received (D*H) halo
        pos = {}
        for p in range(D):
            if p == d:
                continue
            ids = needed[d][p]
            send_idx[p, d, : len(ids)] = (ids - p * Ns).astype(np.int32)
            for i, g in enumerate(ids):
                pos[int(g)] = p * H + i
        el = loc_lists[d]
        src_loc[d, : len(el)] = (src[el] - d * Ns).astype(np.int32)
        dst_loc[d, : len(el)] = (dst[el] - d * Nd).astype(np.int32)
        mask_loc[d, : len(el)] = True
        perm_loc[d, : len(el)] = el
        er = rem_lists[d]
        src_rem[d, : len(er)] = np.fromiter(
            (pos[int(g)] for g in src[er]), np.int32, count=len(er))
        dst_rem[d, : len(er)] = (dst[er] - d * Nd).astype(np.int32)
        mask_rem[d, : len(er)] = True
        perm_rem[d, : len(er)] = er

    return HaloPlan(
        n_shards=D, n_src=int(n_src), n_dst=int(n_dst), src_block=int(Ns),
        dst_block=int(Nd), halo=int(H), send_idx=send_idx,
        src_loc=src_loc, dst_loc=dst_loc, mask_loc=mask_loc,
        perm_loc=perm_loc, src_rem=src_rem, dst_rem=dst_rem,
        mask_rem=mask_rem, perm_rem=perm_rem)


class HaloGraph(nn.Module):
    """This rank's share of a halo plan, passed to ``MPConv`` in place of a
    ``GatherTable`` (as a ``CooGraph`` is): built once, on the host, from
    the plan and the mesh (``plan.n_shards`` is its data axis).

    ``send`` groups the rows this rank ships by their source row, ``src_*``
    and ``dst_*`` the local and remote edge slots by source and by
    destination (``ops/segment.Segments``); ``perm_*`` index each slot's
    edge in the original order (padding slots: one extra, zero row), and
    ``mask_*`` mark the valid slots.  ``.to(device)`` moves them."""

    def __init__(self, plan: HaloPlan, mesh):
        super().__init__()
        if plan.n_shards != mesh.dp:
            raise ValueError(f"a plan of {plan.n_shards} shards on a data "
                             f"axis of {mesh.dp}")
        r = mesh.data_rank
        D, Ns, Nd, H = plan.n_shards, plan.src_block, plan.dst_block, \
            plan.halo
        self.plan, self.mesh = plan, mesh
        self.send = Segments(plan.send_idx[r].reshape(-1), Ns)
        self.src_loc = Segments(plan.src_loc[r], Ns)
        self.dst_loc = Segments(plan.dst_loc[r], Nd)
        self.src_rem = Segments(plan.src_rem[r], D * H)
        self.dst_rem = Segments(plan.dst_rem[r], Nd)
        for side in ("loc", "rem"):
            mask = getattr(plan, f"mask_{side}")[r]
            perm = np.where(mask, getattr(plan, f"perm_{side}")[r], -1)
            self.register_buffer(f"mask_{side}", torch.from_numpy(mask),
                                 persistent=False)
            self.register_buffer(f"perm_{side}", torch.from_numpy(perm),
                                 persistent=False)

    def local_src(self, x):
        """This rank's block (Ns, C) of the whole source features (n_src,
        C), zero-padded as ``plan.pad_src``."""
        p = self.plan
        r = self.mesh.data_rank
        return p.pad_src(x)[r * p.src_block:(r + 1) * p.src_block]

    def shard_etype(self, etype: torch.Tensor):
        """(E, T) in the original edge order -> this rank's local (EL, T)
        and remote (ER, T) slots, zero in the padding slots."""
        ext = torch.cat([etype, etype.new_zeros((1,) + etype.shape[1:])])
        pad = etype.shape[0]
        return tuple(ext.index_select(0, torch.where(perm < 0, pad, perm))
                     for perm in (self.perm_loc, self.perm_rem))


def _partial(msgs, seg, mask, aggregator, gamma):
    """Masked partial aggregation of one edge list into (Nd, C)."""
    if aggregator in ("sum", "mean"):
        msgs = torch.where(mask[:, None], msgs, 0.0)
        return segment_sum(msgs, seg), segment_sum(mask.to(msgs.dtype), seg)
    msgs = torch.where(mask[:, None], msgs, _NEG)
    m = segment_max(msgs, seg)
    m = torch.clamp_min(m, _NEG)  # empty segments: -inf -> _NEG
    if aggregator == "max":
        return (m,)
    # softmax (gamma-logsumexp): keep (max, sum-of-shifted-exps)
    shifted = torch.exp(gamma * (msgs - gather(m, seg)))
    return m, segment_sum(shifted, seg)


def _combine(pl, pr, aggregator, gamma):
    if aggregator in ("sum", "mean"):
        s = pl[0] + pr[0]
        if aggregator == "mean":
            cnt = pl[1] + pr[1]
            return s / cnt.clamp_min(1.0)[:, None]
        return s
    if aggregator == "max":
        m = torch.maximum(pl[0], pr[0])
        return torch.where(m <= _NEG / 2, 0.0, m)
    # softmax: exact logsumexp merge of the two shifted partials
    m = torch.maximum(pl[0], pr[0])
    s = (pl[1] * torch.exp(gamma * (pl[0] - m))
         + pr[1] * torch.exp(gamma * (pr[0] - m)))
    # destinations with no edge at all: match segment_logsumexp's
    # empty-segment value (max clamped to 0 -> log(1e-30)/gamma)
    m = torch.where(m <= _NEG / 2, 0.0, m)
    return m + torch.log(s.clamp_min(1e-30)) / gamma


def halo_typed_mp_coo(x: torch.Tensor, etype_loc: torch.Tensor,
                      etype_rem: torch.Tensor, filters: torch.Tensor,
                      nout: int, graph: HaloGraph, *,
                      aggregator: str = "max", gamma: float = 3.0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sharded-source COO typed message passing with halo exchange, on
    this rank.

    x: (Ns, C_in), this rank's block of source rows (``graph.local_src``);
    etype_loc (EL, T), etype_rem (ER, T): its edges' type weights in plan
    order (``graph.shard_etype``); filters (C_in, nout * T), replicated.
    Returns this rank's (Nd, nout) destination rows; rows past
    ``plan.n_dst`` overall are padding."""
    T = etype_loc.shape[-1]
    if x.shape[0] != graph.plan.src_block:
        raise ValueError(f"x has {x.shape[0]} rows; a rank holds "
                         f"{graph.plan.src_block}")
    D, H = graph.plan.n_shards, graph.plan.halo
    # Halo exchange, in flight while the local edges aggregate.
    send = gather(x, graph.send).view(D, H, -1)
    recv, work = all_to_all_start(send, graph.mesh.data_group)

    h_l = gather(x @ filters, graph.src_loc).view(-1, nout, T)
    msgs_l = torch.einsum("ect,et->ec", h_l, etype_loc.to(h_l.dtype))
    part_l = _partial(msgs_l, graph.dst_loc, graph.mask_loc, aggregator,
                      gamma)

    if work is not None:
        work.wait()
    h_r = gather(recv.reshape(D * H, -1) @ filters,
                 graph.src_rem).view(-1, nout, T)
    msgs_r = torch.einsum("ect,et->ec", h_r, etype_rem.to(h_r.dtype))
    part_r = _partial(msgs_r, graph.dst_rem, graph.mask_rem, aggregator,
                      gamma)

    out = _combine(part_l, part_r, aggregator, gamma)
    if bias is not None:
        out = out + bias
    return out
