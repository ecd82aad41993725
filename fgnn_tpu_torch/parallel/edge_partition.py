"""Edge-partitioned typed message passing across the ranks of a mesh
(counterpart of ``fgnn_tpu/parallel/edge_partition.py``).

The factor-variable incidence EDGE LIST is sharded over the ``data`` axis:
each rank aggregates its contiguous block of edges into a partial per
destination (``ops/segment.py``, deterministic), and the partials are
combined over the ranks:

  * sum / mean : the sum of the partials (and of the valid counts for mean)
  * max        : the maximum, -1e30 for a rank's empty segments
  * softmax    : two phases — the maximum of the local maxima, then the sum
                 of the exponentials shifted by it (an exact logsumexp
                 across shards)

Source features and filters are replicated, and so is the output; a loss
taken from it is one replicated loss, and sum and mean give every rank its
full gradients (``comm.sum_over_ranks``, ``comm.replicated``).  Max and
softmax combine with ``comm.max_over_ranks``, whose backward raises, as
JAX cannot differentiate ``pmax``.  Replication is the right trade below
~10^5 nodes; above, ``halo.py`` shards the sources too.  No Pallas kernel
backs the JAX version (``jax.ops.segment_*``), so this runs PyTorch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segment import Segments, gather, segment_max, segment_sum
from .comm import max_over_ranks, replicated, sum_over_ranks

_NEG = -1e30


def pad_edges(src, dst, etype, n_shards: int):
    """Pad the edge list to a multiple of n_shards with masked self-edges."""
    E = src.shape[0]
    Ep = -(-E // n_shards) * n_shards
    pad = Ep - E
    src = np.concatenate([src, np.zeros(pad, src.dtype)])
    dst = np.concatenate([dst, np.zeros(pad, dst.dtype)])
    etype = np.concatenate([etype, np.zeros((pad,) + etype.shape[1:],
                                            etype.dtype)])
    mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    return src, dst, etype, mask


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def partitioned_typed_mp_coo(x, src, dst, etype, edge_mask, filters,
                             nout: int, num_dst: int, mesh, *,
                             aggregator: str = "max",
                             gamma: float = 3.0) -> torch.Tensor:
    """COO typed message passing with the edges sharded over the data axis.

    x (N_src, C_in), filters (C_in, nout * T): replicated; src, dst (E,)
    (host arrays or tensors), etype (E, T) and edge_mask (E,): the whole
    padded edge list (``pad_edges``: E divisible by the data axis), of
    which this rank takes block ``mesh.data_rank``.  Returns (num_dst,
    nout), the same on every rank."""
    D = mesh.dp
    E, T = etype.shape[0], etype.shape[-1]
    if E % D:
        raise ValueError(f"{E} edges do not split over {D} ranks: pad them "
                         "(pad_edges)")
    lo, hi = mesh.data_rank * (E // D), (mesh.data_rank + 1) * (E // D)
    group = mesh.data_group
    by_src = Segments(_host(src).reshape(-1)[lo:hi], x.shape[0]).to(x.device)
    by_dst = Segments(_host(dst).reshape(-1)[lo:hi], num_dst).to(x.device)
    mask = torch.as_tensor(_host(edge_mask).reshape(-1)[lo:hi],
                           device=x.device)[:, None]
    x, filters = replicated(x, group), replicated(filters, group)
    et = replicated(torch.as_tensor(etype, device=x.device), group)[lo:hi]

    h = gather(x @ filters, by_src).view(-1, nout, T)
    msgs = torch.einsum("ect,et->ec", h, et.to(h.dtype))
    if aggregator in ("sum", "mean"):
        msgs = torch.where(mask, msgs, 0.0)
        total = sum_over_ranks(segment_sum(msgs, by_dst), group)
        if aggregator == "mean":
            cnt = segment_sum(mask.to(msgs.dtype), by_dst)
            cnt = sum_over_ranks(cnt, group)
            total = total / cnt.clamp_min(1.0)
        return total
    if aggregator == "max":
        msgs = torch.where(mask, msgs, _NEG)
        total = max_over_ranks(segment_max(msgs, by_dst), group)
        return torch.where(total <= _NEG / 2, 0.0, total)
    if aggregator == "softmax":
        msgs = torch.where(mask, msgs, _NEG)
        m = max_over_ranks(segment_max(msgs, by_dst), group)
        m_safe = torch.where(m <= _NEG / 2, 0.0, m)
        shifted = torch.exp(gamma * (msgs - gather(m_safe, by_dst)))
        shifted = torch.where(mask, shifted, 0.0)
        s = sum_over_ranks(segment_sum(shifted, by_dst), group)
        return m_safe + torch.log(s.clamp_min(1e-30)) / gamma
    raise ValueError(aggregator)
