"""Point-cloud KNN helpers (counterpart of ``fgnn_tpu/models/knn.py``),
layout (B, N, C).  No model of the repository uses them."""

from __future__ import annotations

import torch

from ..ops.typed_mp import gather_nodes


def pairwise_distance(x: torch.Tensor) -> torch.Tensor:
    """Negative squared euclidean distances: x (B, N, C) -> (B, N, N),
    [b, i, j] = -||x_i - x_j||^2, in the JAX package's order of sums."""
    inner = -2.0 * torch.einsum("bic,bjc->bij", x, x)
    sq = x.square().sum(dim=-1, keepdim=True)          # (B, N, 1)
    return -sq - inner - sq.transpose(-1, -2)


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest nodes of each node (itself included), (B, N, k)
    int32, nearest first.  Among equal distances the lower index comes
    first, as ``jax.lax.top_k`` orders them: a stable descending sort,
    where ``torch.topk`` promises no order among ties."""
    d = pairwise_distance(x)
    order = torch.sort(d, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def get_nn_node_feature(x: torch.Tensor, nn_idx) -> torch.Tensor:
    """Neighbour features (B, N, K, C)."""
    return gather_nodes(x, nn_idx)


def get_edge_feature(x: torch.Tensor, nn_idx) -> torch.Tensor:
    """Central-minus-neighbour differences (B, N, K, C)."""
    return x[:, :, None, :] - gather_nodes(x, nn_idx)
