"""FactorNN: the bipartite factor-graph network (counterpart of
``fgnn_tpu/models/factor_nn.py``).

Variables and factors keep separate features; each layer computes

  nodes:   v2v(x)   + sum_j F2V_j(factors_j)   gathered over the f2v tables
  factors: f2f_j(f) + V2F_j(nodes)             gathered over the v2f tables

with NO_EXTENSION typed message passing, residual adds where a layer keeps
its width, skip links across layers, and a final per-node head.

Layer rule (``_make_mp``):
  nin == nout                 -> MPConvResidual (no outer residual)
  nin, nout <= MAX_MPNN_DIM   -> MPConv(nin -> nout)
  otherwise                   -> MPConvResidual bottleneck to nout
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .base import IIDMap, IIDMapBN, IIDMapIN
from .mp_conv import MPConv, MPConvResidual
from .norm import Dense, instance_norm

GNN_IMMEDIATE_DIM = 64  # bottleneck width of MPConvResidual
MAX_MPNN_DIM = 128      # widest conv run without a bottleneck


def _make_mp(nin: int, nout: int, netype: int, aggregator: str) -> nn.Module:
    if nin == nout:
        return MPConvResidual(nin, GNN_IMMEDIATE_DIM, netype,
                              with_residual=False, aggregator=aggregator)
    if nin <= MAX_MPNN_DIM and nout <= MAX_MPNN_DIM:
        return MPConv(nin, nout, netype, aggregator=aggregator)
    return MPConvResidual(nin, GNN_IMMEDIATE_DIM, netype,
                          with_residual=False, aggregator=aggregator,
                          nout=nout)


class FactorNN(nn.Module):
    """Bipartite VF/FV factor-graph network, layout (B, N, C).

    forward(node_feature (B, N_vars, node_feature_dim),
            factor_features [ (B, N_fac_j, factor_feature_dims[j]) ],
            tables_f2v [ GatherTable (N_vars, K_j) over N_fac_j ],
            tables_v2f [ GatherTable (N_fac_j, K'_j) over N_vars ],
            etype_f2v [ (B, N_vars, K_j, netype_j) ],
            etype_v2f [ (B, N_fac_j, K'_j, netype_j) ])
    returns (per-variable logits (B, N_vars, 1), the final factor features).
    """

    def __init__(self, node_feature_dim: int,
                 factor_feature_dims: Sequence[int],
                 dim_mapping_list: Sequence[int],
                 netype_list: Sequence[int], *,
                 skip_link: Optional[Dict[int, int]] = None,
                 aggregator: str = "max"):
        super().__init__()
        dims = list(dim_mapping_list)
        self.ntypes = len(factor_feature_dims)
        self.n_layers = len(dims) - 1
        self.dims = dims
        self.skip = dict(skip_link or {})

        self.node_mapping = IIDMap(node_feature_dim, dims[0])
        for j, fd in enumerate(factor_feature_dims):
            self.add_module(f"factor_mapping_{j}", IIDMapBN(fd, dims[0]))
        for idx in range(self.n_layers):
            nin, nout = dims[idx], dims[idx + 1]
            self.add_module(f"v2v_{idx}", IIDMapIN(nin, nout))
            for j in range(self.ntypes):
                self.add_module(f"f2f_{idx}_{j}", IIDMapIN(nin, nout))
                for side in ("f2v", "v2f"):
                    self.add_module(f"{side}_{idx}_{j}", _make_mp(
                        nin, nout, netype_list[j], aggregator))
        self.final_conv1 = Dense(dims[-1], 128)
        self.final_conv2 = Dense(128, 1)  # two classes: one logit

    def forward(self, node_feature, factor_features, tables_f2v, tables_v2f,
                etype_f2v, etype_v2f):
        x = self.node_mapping(node_feature)
        fs = [getattr(self, f"factor_mapping_{j}")(factor_features[j])
              for j in range(self.ntypes)]

        inter = []
        for idx in range(self.n_layers):
            nfeat = getattr(self, f"v2v_{idx}")(x)
            nf = [getattr(self, f"f2f_{idx}_{j}")(fs[j])
                  for j in range(self.ntypes)]
            for j in range(self.ntypes):
                f2v = getattr(self, f"f2v_{idx}_{j}")
                v2f = getattr(self, f"v2f_{idx}_{j}")
                nfeat = nfeat + f2v(fs[j], tables_f2v[j], etype_f2v[j])
                nf[j] = nf[j] + v2f(x, tables_v2f[j], etype_v2f[j])

            if self.dims[idx] == self.dims[idx + 1]:
                x = x + nfeat
                fs = [a + b for a, b in zip(nf, fs)]
            else:
                x = nfeat
                fs = nf

            if idx in self.skip:
                ox, ofs = inter[self.skip[idx]]
                x = x + ox
                fs = [a + b for a, b in zip(ofs, fs)]
            inter.append((x, fs))

        h = torch.relu(instance_norm(self.final_conv1(x)))
        return self.final_conv2(h), fs
