"""FactorGraph: the edge-list (COO) factor-graph IR (counterpart of
``fgnn_tpu/graph.py``).

A ``FactorGraph`` describes one factor type's variable-factor incidence as
flat edge arrays, held as numpy arrays on the host:

    var_idx[e]   the variable endpoint
    fac_idx[e]   the factor endpoint
    slot[e]      the variable's position within its factor (0..deg-1)
    edge_mask[e] False for padding edges

with the counts ``n_vars`` and ``n_factors``.  It converts to and from the
padded tables of the dense form (``from_factor_table``, ``to_v2f_table``,
``to_f2v_table``), batches by disjoint union (``disjoint_union``,
``pad_to``), and runs both message directions through the COO conv
(``v2f``, ``f2v``, on torch tensors).  ``build_joint_coo`` batches the
joint [variables ; factors] graphs of the concat formulation into one
``ops.segment.CooGraph``, so chains of different lengths batch with no
padding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .ops.segment import CooGraph, typed_mp_conv_coo


@dataclasses.dataclass(frozen=True, eq=False)
class FactorGraph:
    var_idx: np.ndarray    # (E,) int32
    fac_idx: np.ndarray    # (E,) int32
    slot: np.ndarray       # (E,) int32
    edge_mask: np.ndarray  # (E,) bool
    n_vars: int
    n_factors: int

    # --------------------------------------------------------- constructors
    @classmethod
    def from_edges(cls, var_idx, fac_idx, slot=None, n_vars=None,
                   n_factors=None, edge_mask=None) -> "FactorGraph":
        """``slot`` defaults to each factor's running count of edges, in
        input order."""
        var_idx = np.asarray(var_idx, np.int32)
        fac_idx = np.asarray(fac_idx, np.int32)
        if slot is None:
            slot = np.zeros_like(fac_idx)
            seen: dict = {}
            for e, f in enumerate(fac_idx):
                slot[e] = seen.get(int(f), 0)
                seen[int(f)] = slot[e] + 1
        if edge_mask is None:
            edge_mask = np.ones(var_idx.shape, bool)
        return cls(
            var_idx=var_idx, fac_idx=fac_idx,
            slot=np.asarray(slot, np.int32),
            edge_mask=np.asarray(edge_mask, bool),
            n_vars=int(n_vars if n_vars is not None else var_idx.max() + 1),
            n_factors=int(n_factors if n_factors is not None
                          else fac_idx.max() + 1))

    @classmethod
    def from_factor_table(cls, factors, n_vars: int,
                          valid=None) -> "FactorGraph":
        """factors: (N_fac, K) member-variable table; ``valid`` masks
        padded slots."""
        factors = np.asarray(factors)
        nf, K = factors.shape
        fac_idx = np.repeat(np.arange(nf, dtype=np.int32), K)
        slot = np.tile(np.arange(K, dtype=np.int32), nf)
        var_idx = factors.reshape(-1).astype(np.int32)
        mask = (np.ones_like(var_idx, dtype=bool) if valid is None
                else np.asarray(valid).reshape(-1).astype(bool))
        return cls.from_edges(var_idx, fac_idx, slot, n_vars, nf, mask)

    # ----------------------------------------------------------- conversions
    def to_v2f_table(self) -> np.ndarray:
        """Padded (n_factors, max_deg) member table, -1 on empty slots."""
        mask = self.edge_mask
        slot = self.slot[mask]
        deg = int(slot.max()) + 1 if mask.any() else 0
        out = -np.ones((self.n_factors, deg), np.int32)
        out[self.fac_idx[mask], slot] = self.var_idx[mask]
        return out

    def to_f2v_table(self) -> np.ndarray:
        """Padded (n_vars, max_var_deg) incident-factor table, -1 padded;
        each variable's factors in edge order."""
        var = self.var_idx[self.edge_mask]
        fac = self.fac_idx[self.edge_mask]
        counts = np.bincount(var, minlength=self.n_vars)
        deg = int(counts.max()) if counts.size else 0
        out = -np.ones((self.n_vars, deg), np.int32)
        order = np.argsort(var, kind="stable")
        start = np.concatenate([[0], np.cumsum(counts)])[:-1]
        out[var[order], np.arange(var.size) - start[var[order]]] = \
            fac[order]
        return out

    def to_coo(self) -> CooGraph:
        """The v2f direction as a CooGraph over the joint [vars ; factors]
        numbering: src = vars, dst = factors + n_vars."""
        return CooGraph(self.var_idx, self.fac_idx + self.n_vars,
                        edge_mask=self.edge_mask,
                        num_nodes=self.n_vars + self.n_factors)

    # ------------------------------------------------------------- batching
    @classmethod
    def disjoint_union(cls, graphs: Sequence["FactorGraph"]) -> "FactorGraph":
        """Concatenate graphs with index offsets."""
        vo, fo = 0, 0
        vs, fs = [], []
        for g in graphs:
            vs.append(g.var_idx + vo)
            fs.append(g.fac_idx + fo)
            vo += g.n_vars
            fo += g.n_factors
        return cls(var_idx=np.concatenate(vs).astype(np.int32),
                   fac_idx=np.concatenate(fs).astype(np.int32),
                   slot=np.concatenate([g.slot for g in graphs]),
                   edge_mask=np.concatenate([g.edge_mask for g in graphs]),
                   n_vars=vo, n_factors=fo)

    def pad_to(self, n_edges: int) -> "FactorGraph":
        """Pad the edge list to ``n_edges`` with masked edges (0, 0, 0)."""
        pad = n_edges - self.n_edges
        if pad < 0:
            raise ValueError(f"cannot pad {self.n_edges} edges to {n_edges}")
        z = np.zeros(pad, np.int32)
        return dataclasses.replace(
            self, var_idx=np.concatenate([self.var_idx, z]),
            fac_idx=np.concatenate([self.fac_idx, z]),
            slot=np.concatenate([self.slot, z]),
            edge_mask=np.concatenate([self.edge_mask, np.zeros(pad, bool)]))

    @property
    def n_edges(self) -> int:
        return int(self.var_idx.shape[0])

    # ---------------------------------------------------------- message ops
    def _coo(self, direction: str, device) -> CooGraph:
        """This graph's CooGraph in one direction, on ``device``."""
        if direction == "v2f":
            g = CooGraph(self.var_idx, self.fac_idx, self.edge_mask,
                         num_nodes=self.n_factors, num_src=self.n_vars)
        else:
            g = CooGraph(self.fac_idx, self.var_idx, self.edge_mask,
                         num_nodes=self.n_vars, num_src=self.n_factors)
        return g.to(device)

    def v2f(self, var_features: torch.Tensor, etype: torch.Tensor,
            filters: torch.Tensor, nout: int, *, aggregator: str = "max",
            gamma: float = 3.0, bias=None) -> torch.Tensor:
        """Variable -> factor typed messages: (n_factors, nout)."""
        return typed_mp_conv_coo(
            var_features, self._coo("v2f", var_features.device), etype,
            filters, nout, aggregator=aggregator, gamma=gamma, bias=bias)

    def f2v(self, fac_features: torch.Tensor, etype: torch.Tensor,
            filters: torch.Tensor, nout: int, *, aggregator: str = "max",
            gamma: float = 3.0, bias=None) -> torch.Tensor:
        """Factor -> variable typed messages: (n_vars, nout)."""
        return typed_mp_conv_coo(
            fac_features, self._coo("f2v", fac_features.device), etype,
            filters, nout, aggregator=aggregator, gamma=gamma, bias=bias)


def build_joint_coo(tables, efeatures, n_vars_list):
    """Disjoint-union batch of concat-formulation joint graphs.

    tables:      per sample (N_b, K_b) joint neighbour table (rows
                 0..L_b-1 the variables, rows L_b..N_b-1 that type's
                 factors, entries in the sample's joint numbering: the
                 layout of ``data.tables.pw_factor_table`` and
                 ``high_factor_table``); row i's K_b entries are its
                 sources, i its destination
    efeatures:   per sample (N_b, K_b, C) per-edge features
    n_vars_list: per sample L_b

    Returns (a CooGraph over the vars-first union numbering [all vars by
    sample ; all factors by sample], with ``seg`` the sample of each node;
    ef_edges (E, C) float32, in the tables' row-major edge order; meta:
    n_vars, n_factors and the var and factor offsets v_off, f_off).
    """
    graphs, n_nodes = [], []
    for tab in tables:
        tab = np.asarray(tab)
        graphs.append(FactorGraph.from_factor_table(tab, n_vars=tab.shape[0]))
        n_nodes.append(tab.shape[0])
    u = FactorGraph.disjoint_union(graphs)   # interleaved numbering

    n_nodes = np.asarray(n_nodes)
    n_vars = np.asarray(list(n_vars_list))
    n_facs = n_nodes - n_vars
    off = np.concatenate([[0], np.cumsum(n_nodes)])
    v_off = np.concatenate([[0], np.cumsum(n_vars)])
    f_off = np.concatenate([[0], np.cumsum(n_facs)])
    NV, NF = int(v_off[-1]), int(f_off[-1])

    def remap(g):
        g = np.asarray(g, np.int64)
        b = np.searchsorted(off, g, side="right") - 1
        j = g - off[b]
        return np.where(j < n_vars[b], v_off[b] + j,
                        NV + f_off[b] + (j - n_vars[b])).astype(np.int32)

    seg = np.concatenate([
        np.repeat(np.arange(len(n_vars), dtype=np.int32), n_vars),
        np.repeat(np.arange(len(n_facs), dtype=np.int32), n_facs)])
    ef_edges = np.concatenate([np.asarray(ef).reshape(-1, np.shape(ef)[-1])
                               for ef in efeatures])
    coo = CooGraph(remap(u.var_idx), remap(u.fac_idx), u.edge_mask,
                   num_nodes=NV + NF, seg=seg, num_segments=len(n_vars))
    meta = dict(n_vars=NV, n_factors=NF, v_off=v_off, f_off=f_off)
    return coo, torch.from_numpy(ef_edges.astype(np.float32)), meta
