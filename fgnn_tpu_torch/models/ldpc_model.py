"""LDPCModel: the neural decoder for the MacKay 96.3.963 code (counterpart
of ``fgnn_tpu/models/ldpc_model.py``).

A bipartite FactorNN over 96 variables and 48 check factors, plus a second
factor type: one global factor connected to all 96 variables, whose final
feature feeds a burst-noise-level (sigma_b) regressor.  Edge weights come
from two small MLPs over the 7-dim per-edge features.

The model holds its code structure and all four gather tables (check
tables and global-factor tables) as device buffers; the decoder checks
each batch's tables against ``structure`` on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.ldpc_graph import default_structure
from ..ops.typed_mp import GatherTable
from .base import MLP
from .factor_nn import FactorNN
from .norm import BatchNorm, Dense

REFERENCE_DIMS = (64, 64, 64, 128, 256, 256, 128, 64, 64)
REFERENCE_SKIP = {4: 3, 5: 2, 7: 0}
NODE_FEATURE_DIM = 2  # [received signal, snr_db]
BP_FEATURE_DIM = 2    # --bp-features: [2 q1 - 1, converged]
HOP_ORDER = 6         # a check's feature: the signals of its 6 variables
EFEATURE_DIM = 7      # the 6 signals of a check + the variable's own
NEDGE_TYPES = 4
N_INFO_BITS = 48


class SigmaBRegressor(nn.Module):
    """Linear(nin->128)+BN+ReLU -> Linear(128->128)+ReLU -> Linear(128->1)
    +ReLU on (B, nin)."""

    def __init__(self, nin: int = 64):
        super().__init__()
        self.fc1 = Dense(nin, 128)
        self.bn = BatchNorm(128)
        self.fc2 = Dense(128, 128)
        self.fc3 = Dense(128, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.bn(self.fc1(h), activation="relu")
        h = torch.relu(self.fc2(h))
        return torch.relu(self.fc3(h))


class LDPCModel(nn.Module):
    """forward(node_feature (B, 96, 2), hop_feature (B, 48, 6),
    efeature_f2v (B, 96, 3, 7), efeature_v2f (B, 48, 6, 7)) returns
    (logits over the 48 info bits (B, 48), sigma_b_pred (B, 1)).

    ``dim_mapping_list`` and ``skip_link`` default to the reference
    configuration; the tests shrink them.  ``node_feature_dim`` is the
    width of node_feature: 2, or 4 with the sum-product features of
    ``--bp-features`` appended."""

    def __init__(self, *, aggregator: str = "max",
                 dim_mapping_list: Sequence[int] = REFERENCE_DIMS,
                 skip_link: Optional[Dict[int, int]] = None,
                 node_feature_dim: int = NODE_FEATURE_DIM):
        super().__init__()
        st = default_structure()
        self.structure = st
        self.n_code_bits = N = st.n_vars
        skip = REFERENCE_SKIP if skip_link is None else skip_link
        dims = tuple(dim_mapping_list)

        self.emodel_f2v = MLP(EFEATURE_DIM, [64, NEDGE_TYPES])
        self.emodel_v2f = MLP(EFEATURE_DIM, [64, NEDGE_TYPES])
        self.main = FactorNN(
            node_feature_dim, (HOP_ORDER, N), dims, (NEDGE_TYPES, 1),
            skip_link=skip, aggregator=aggregator)
        self.nhop_regressor = SigmaBRegressor(dims[-1])

        # check tables (type 0) and global-factor tables (type 1): every
        # variable sees factor 0, the factor sees all variables
        self.table_f2v = GatherTable(st.var_checks, st.n_checks)
        self.table_v2f = GatherTable(st.factors, N)
        self.gtable_f2v = GatherTable(np.zeros((N, 1), np.int32), 1)
        self.gtable_v2f = GatherTable(np.arange(N).reshape(1, N), N)

    def forward(self, node_feature, hop_feature, efeature_f2v, efeature_v2f):
        B, N = node_feature.shape[0], self.n_code_bits
        etype_f2v = self.emodel_f2v(efeature_f2v)
        etype_v2f = self.emodel_v2f(efeature_v2f)

        # the global factor's feature is the raw channel-0 signal, detached
        # as in the reference
        gfac_feature = node_feature[..., 0].detach().reshape(B, 1, N)
        ones = node_feature.new_ones(())
        hetype_f2v = ones.expand(B, N, 1, 1)
        hetype_v2f = ones.expand(B, 1, N, 1)

        res, fs = self.main(
            node_feature, [hop_feature, gfac_feature],
            [self.table_f2v, self.gtable_f2v],
            [self.table_v2f, self.gtable_v2f],
            [etype_f2v, hetype_f2v], [etype_v2f, hetype_v2f])

        res = res + node_feature[..., :1]  # the received signal, residually
        logits = res[:, :N_INFO_BITS, 0]
        sigma_b_pred = self.nhop_regressor(fs[1].reshape(B, -1))
        return logits, sigma_b_pred
