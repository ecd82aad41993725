"""FactorMPNN: the concat ("joint graph") factor-graph network
(counterpart of ``fgnn_tpu/models/factor_mpnn.py``).

Per layer and per factor type, the node features and that type's factor
features are concatenated along the node axis into one joint [variables ;
factors] graph, one shared message-passing conv runs over it, the result is
split back, and the per-type node features are merged with a per-node
merge map.  Factor features are carried forward per type; ``skip_link``
{layer: earlier layer} adds an earlier layer's outputs (node and every
factor feature) to a layer's, after its merge.

Layer choice (as the JAX package):
  nin == nout                -> MPConvResidual (max, ORIG_WITH_DIFF,
                                bottleneck ``gnn_immediate_dim``)
  nin, nout <= max_mpnn_dim  -> MPConv (softmax, ORIG_WITH_DIFF)
  otherwise                  -> pointwise Dense + InstanceNorm + ReLU
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.segment import CooGraph
from ..ops.typed_mp import Extension
from .base import IIDMap, IIDMapBN
from .mp_conv import MPConv, MPConvResidual
from .norm import BatchNorm, Dense, instance_norm, leaky_relu


class _PointwiseFallback(nn.Module):
    """Dense + InstanceNorm + ReLU, the branch without message passing.
    The flax module's InstanceNorm ``in`` has no parameters.  ``seg``
    (a flat disjoint union's nodes by sample) makes the InstanceNorm's
    statistics per sample."""

    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)

    def forward(self, x: torch.Tensor, seg=None) -> torch.Tensor:
        return instance_norm(self.conv(x), seg=seg, activation="relu")


class _FinalMerge(nn.Module):
    """Last-layer merge head: Dense(->256)+BN+LeakyReLU ->
    Dense(256)+LeakyReLU -> Dense(->nout)."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = Dense(nin, 256)
        self.bn = BatchNorm(256)
        self.conv2 = Dense(256, 256)
        self.conv3 = Dense(256, nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv1(x), activation="leaky_relu")
        x = leaky_relu(self.conv2(x))
        return self.conv3(x)


class FactorMPNN(nn.Module):
    """forward(node_features (B, N_vars, node_dim),
               factor_features [ (B, N_fac_j, factor_feature_dims[j]) ],
               tables [ GatherTable (N_vars + N_fac_j, K_j) over the joint
                        graph ],
               etypes [ (B, N_vars + N_fac_j, K_j, netype_j) ])
    returns (node features after the last merge (B, N_vars, dims[-1]),
    the per-type factor features).

    Flat (disjoint-union) mode: node_features (N_vars_flat, node_dim),
    factor features (N_fac_flat_j, dim_j), each table a ``CooGraph`` over
    that type's joint [all vars ; all factors_j] numbering
    (``graph.build_joint_coo``) and each etype (E_j, netype_j).  The same
    parameters serve both modes.

    ``gnn_immediate_dim``, ``max_mpnn_dim`` and ``skip_link`` have the JAX
    module's meaning and defaults (64, 64, none)."""

    def __init__(self, node_feature_dim: int,
                 factor_feature_dims: Sequence[int],
                 dim_mapping_list: Sequence[int],
                 netype_list: Sequence[int], *,
                 gnn_immediate_dim: int = 64, max_mpnn_dim: int = 64,
                 skip_link: Optional[Dict[int, int]] = None):
        super().__init__()
        dims = list(dim_mapping_list)
        self.ntypes = len(factor_feature_dims)
        self.n_layers = len(dims) - 1
        self.skip = dict(skip_link or {})
        self.mapping_0 = IIDMap(node_feature_dim, dims[0])
        for j, fd in enumerate(factor_feature_dims):
            self.add_module(f"mapping_{j + 1}", IIDMap(fd, dims[0]))
        diff = Extension.ORIG_WITH_DIFF
        for midx in range(self.n_layers):
            nin, nout = dims[midx], dims[midx + 1]
            for j in range(self.ntypes):
                if nin == nout:
                    mod = MPConvResidual(nin, gnn_immediate_dim,
                                         netype_list[j], extension=diff)
                elif nin <= max_mpnn_dim and nout <= max_mpnn_dim:
                    mod = MPConv(nin, nout, netype_list[j], extension=diff)
                else:
                    mod = _PointwiseFallback(nin, nout)
                self.add_module(f"mp_nn_{midx}_{j}", mod)
            merge = (IIDMapBN if midx < self.n_layers - 1 else _FinalMerge)(
                self.ntypes * nout, nout)
            self.add_module(f"merge_{midx}", merge)

    def forward(self, node_features, factor_features, tables, etypes):
        nnode = node_features.shape[-2]
        x = self.mapping_0(node_features)
        fs = [getattr(self, f"mapping_{j + 1}")(factor_features[j])
              for j in range(self.ntypes)]
        inter = []
        for midx in range(self.n_layers):
            cn, cf = [], []
            for j in range(self.ntypes):
                joint = torch.cat([x, fs[j]], dim=-2)
                mod = getattr(self, f"mp_nn_{midx}_{j}")
                if isinstance(mod, _PointwiseFallback):
                    joint = mod(joint, tables[j].bins if isinstance(
                        tables[j], CooGraph) else None)
                else:
                    joint = mod(joint, tables[j], etypes[j])
                cn.append(joint[..., :nnode, :])
                cf.append(joint[..., nnode:, :])
            x = getattr(self, f"merge_{midx}")(torch.cat(cn, dim=-1))
            fs = cf
            if midx in self.skip:
                ox, ofs = inter[self.skip[midx]]
                x = x + ox
                fs = [a + b for a, b in zip(fs, ofs)]
            inter.append((x, fs))
        return x, fs
