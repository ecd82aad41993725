"""Top-level models of the three synthetic chain-MRF MAP workloads
(counterpart of ``fgnn_tpu/models/synthetic.py``, dense tables).

* ``SynFixedModel``: a plain GNN over the variable chain, variants
  ``mp_nn``, ``mp_nn_comp``, ``simple_gnn`` and ``iid``.
* ``SynPwFactorModel``: FactorMPNN with learned pairwise factors and one
  dummy global factor.
* ``SynHopFactorModel``: FactorMPNN with learned pairwise and learned
  budget (hop) factors.
* ``SynHopFactorModelCoo``: the hop model over a flat disjoint union of
  chains of any lengths (``graph.build_joint_coo``), with the same
  parameters.

Each holds its edge-weight MLPs (``emodel*``) beside the network.  The
tables are ``GatherTable``s the caller builds once (``train/synthetic.py``);
the per-edge features are the tables' static (N, K, C) features, whose
edge weights are shared by every sample of a batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.typed_mp import Extension, GatherTable
from .base import MLP
from .containers import IIDBlock, MPSequential
from .factor_mpnn import FactorMPNN
from .mp_conv import MPConv, MPConvResidual
from .norm import Dense

FMPNN_DIMS = (64, 64, 128, 128, 256, 256, 128, 128, 64, 64, 2)
NODE_FEATURE_DIM = 2  # the unary log-potentials
PW_FEATURE_DIM = 4    # a pairwise factor's 2x2 table
VARIANTS = ("mp_nn", "mp_nn_comp", "simple_gnn", "iid")

# after the first conv: "res" is an MPConvResidual keeping the width, an
# int an IIDBlock to that width
_FIXED_PLANS = {
    "mp_nn": ["res", 128, "res", 256, "res", 128, "res", 64, "res"],
    "mp_nn_comp": ["res", 128, "res", 256, "res", "res", "res", "res", "res",
                   128, "res", 64, "res"],
    "simple_gnn": ["res"],
}


def _fixed_stack(variant: str, netypes: int):
    layers = [MPConv(NODE_FEATURE_DIM, 64, netypes,
                     extension=Extension.ORIG_WITH_NEIGHBOR)]
    width = 64
    for step in _FIXED_PLANS[variant]:
        if step == "res":
            layers.append(MPConvResidual(
                width, 64, netypes, extension=Extension.ORIG_WITH_DIFF))
        else:
            layers.append(IIDBlock(width, step))
            width = step
    return layers + [Dense(width, 2)]


def _shared(etype: torch.Tensor, batch: int) -> torch.Tensor:
    """(N, K, T) edge weights of a static table, for each of ``batch``
    samples."""
    return etype.expand(batch, *etype.shape)


class SynFixedModel(MPSequential):
    """forward(node_feature (B, L, 2), table (GatherTable (L, K) over L),
    efeature (L, K, 1)) -> logits (B, L, 2).

    The layers sit at the top of the parameter tree beside ``emodel``, as
    the flax model builds them in its own compact scope."""

    def __init__(self, variant: str = "mp_nn", netypes: int = 16):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        super().__init__([] if variant == "iid"
                         else _fixed_stack(variant, netypes))
        self.variant = variant
        self.emodel = MLP(1, [64, netypes])
        if variant == "iid":
            self.iid_0 = Dense(NODE_FEATURE_DIM, 64)
            self.iid_1 = Dense(64, 2)

    def forward(self, node_feature: torch.Tensor, table: GatherTable,
                efeature: torch.Tensor) -> torch.Tensor:
        etype = _shared(self.emodel(efeature), node_feature.shape[0])
        if self.variant == "iid":
            return self.iid_1(torch.relu(self.iid_0(node_feature)))
        return super().forward(node_feature, table, etype)


class SynPwFactorModel(torch.nn.Module):
    """FactorMPNN(2, [4, 1], dims, [16, 16]) over the chain's pairwise
    factor graph and one dummy global factor.

    forward(node_feature (B, L, 2), pws (B, L, 4), table_pw (2L, 2) over 2L,
    ef_pw (2L, 2, 3), table_high (L+1, k) over L+1, ef_high (L+1, k, 1))
    -> logits (B, L, 2)."""

    def __init__(self, netypes: int = 16, dims: Sequence[int] = FMPNN_DIMS):
        super().__init__()
        self.emodel_pw = MLP(3, [64, netypes])
        self.emodel_high = MLP(1, [64, netypes])
        self.fmpnn = FactorMPNN(NODE_FEATURE_DIM, (PW_FEATURE_DIM, 1),
                                dims, (netypes, netypes))

    def forward(self, node_feature, pws, table_pw, ef_pw, table_high,
                ef_high):
        B = node_feature.shape[0]
        high_feature = node_feature.new_zeros(B, 1, 1)
        out, _ = self.fmpnn(
            node_feature, [pws, high_feature], [table_pw, table_high],
            [_shared(self.emodel_pw(ef_pw), B),
             _shared(self.emodel_high(ef_high), B)])
        return out


class SynHopFactorModel(torch.nn.Module):
    """FactorMPNN(2, [4, hop_order], dims, [16, 16]) with learned pairwise
    and learned hop factors on circular joint tables.

    forward(node_feature (B, L, 2), pws (B, L, 4), hops (B, L, hop_order),
    table_pw (2L, 2) over 2L, ef_pw (2L, 2, 3), table_high (2L, hop_order)
    over 2L, ef_high (2L, hop_order, 2)) -> logits (B, L, 2)."""

    def __init__(self, hop_order: int = 9, netypes: int = 16,
                 dims: Sequence[int] = FMPNN_DIMS):
        super().__init__()
        self.emodel_pw = MLP(3, [64, netypes])
        self.emodel_high = MLP(2, [64, netypes])
        self.fmpnn = FactorMPNN(NODE_FEATURE_DIM, (PW_FEATURE_DIM, hop_order),
                                dims, (netypes, netypes))

    def forward(self, node_feature, pws, hops, table_pw, ef_pw, table_high,
                ef_high):
        B = node_feature.shape[0]
        out, _ = self.fmpnn(
            node_feature, [pws, hops], [table_pw, table_high],
            [_shared(self.emodel_pw(ef_pw), B),
             _shared(self.emodel_high(ef_high), B)])
        return out


class SynHopFactorModelCoo(SynHopFactorModel):
    """The flat disjoint-union form of ``SynHopFactorModel``: its
    parameters and state-dict keys are the dense model's, so weights load
    both ways (and the JAX COO model's flax tree through
    ``load_flax_variables``).

    forward(node_feature (NV, 2), pws (NF, 4), hops (NF, hop_order),
    coo_pw, ef_pw (E_pw, 3), coo_high, ef_high (E_hi, 2)): the features
    flat over the vars-first union numbering, each ``CooGraph`` over its
    type's joint numbering with per-edge features in its edge order
    (``graph.build_joint_coo``) -> flat logits (NV, 2)."""

    def forward(self, node_feature, pws, hops, coo_pw, ef_pw, coo_high,
                ef_high):
        out, _ = self.fmpnn(
            node_feature, [pws, hops], [coo_pw, coo_high],
            [self.emodel_pw(ef_pw), self.emodel_high(ef_high)])
        return out
