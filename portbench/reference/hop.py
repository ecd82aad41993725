"""Plain reference of the synthetic hop MAP model (``SynHopFactorModel``:
a concat-formulation FactorMPNN with learned pairwise and budget factors
on chain MRFs), its loss and its training step.

Written from the model's description (upstream ``syn_hop_factor``
training script, arXiv:1906.00554) in plain PyTorch.  A batch is a set of
chains, dense (B chains of one length) or composite (one chain of each of
several lengths per sample): the reference takes every chain as its own
graph in one flat union, vars first, then factors, chain by chain, which
is what both the dense and the COO form compute (BatchNorm over all rows,
InstanceNorm per chain).  The joint tables are rebuilt here from the
chain lengths (the upstream script's builders), and every DIFF conv forms
each edge's input [x_i ; x_i - x_j] and multiplies it out
(``common.diff_conv``).

Layer rule: nin == nout: a residual bottleneck block (Dense to
``gnn_immediate_dim``, BatchNorm, LeakyReLU, DIFF conv with max, Dense
back, BatchNorm, LeakyReLU, plus the input); nin, nout <=
``max_mpnn_dim``: a DIFF conv with softmax (gamma 3), BatchNorm and ReLU;
otherwise Dense, InstanceNorm and ReLU.  Per layer the two factor types'
joint outputs are split and their variable halves merged (Dense to nout,
BatchNorm, ReLU; the last: Dense 256, BatchNorm, LeakyReLU, Dense 256,
LeakyReLU, Dense nout).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common as C

NODE_DIM, PW_DIM, PW_EF, HIGH_EF = 2, 4, 3, 2


def pw_table(n: int):
    """The joint [n vars ; n pairwise factors] table (2n, 2) and its edge
    features (2n, 2, 3): var i sees factors i - 1 (circular) and i,
    factor i sees vars i and i + 1."""
    idx = np.zeros((2 * n, 2), np.int64)
    ef = np.zeros((2 * n, 2, 3), np.float32)
    for i in range(n):
        for s, nb in enumerate([(i - 1) % n, i]):
            idx[i, s] = n + nb
            ef[i, s, 0] = 1.0
            ef[i, s, 2] = (i - nb + 0.5) * 2.0
        for s, nb in enumerate([i, (i + 1) % n]):
            idx[n + i, s] = nb
            ef[n + i, s, 1] = 1.0
            ef[n + i, s, 2] = (i - nb + 0.5) * 2.0
    return idx, ef


def high_table(n: int, k: int):
    """The joint [n vars ; n budget factors] circular window table (2n, k)
    and its side flags (2n, k, 2)."""
    idx = np.zeros((2 * n, k), np.int64)
    ef = np.zeros((2 * n, k, 2), np.float32)
    hk = k >> 1
    for i in range(n):
        for s in range(k):
            nb = (i + s - hk + n) % n
            idx[i, s] = nb + n
            ef[i, s, 0] = 1.0
            idx[n + i, s] = nb
            ef[n + i, s, 1] = 1.0
    return idx, ef


def _conv(x, idx, etype, filters, bias, nout, aggregator, ctr):
    """``common.diff_conv``; under autograd recomputed in the backward
    rather than kept (its per-edge products are the largest tensors)."""
    if ctr is None and torch.is_grad_enabled():
        return checkpoint(C.diff_conv, x, idx, etype, filters, bias, nout,
                          aggregator, use_reentrant=False)
    return C.diff_conv(x, idx, etype, filters, bias, nout, aggregator,
                       ctr=ctr)


def _kind(cfg, nin, nout):
    if nin == nout:
        return "res"
    if nin <= cfg["max_mpnn_dim"] and nout <= cfg["max_mpnn_dim"]:
        return "conv"
    return "point"


def specs(cfg) -> list:
    d, T = cfg["dims"], cfg["edge_types"]
    med, hid = cfg["gnn_immediate_dim"], cfg["emodel_hidden"]
    out = (C.mlp_spec("emodel_pw", PW_EF, [hid, T])
           + C.mlp_spec("emodel_high", HIGH_EF, [hid, T]))
    f = "fmpnn"
    for j, nin in enumerate((NODE_DIM, PW_DIM, cfg["hop_order"])):
        out += C.dense_spec(f"{f}.mapping_{j}.conv", nin, d[0])
    n_layers = len(d) - 1
    for midx in range(n_layers):
        nin, nout = d[midx], d[midx + 1]
        for j in range(2):
            name = f"{f}.mp_nn_{midx}_{j}"
            kind = _kind(cfg, nin, nout)
            if kind == "res":
                out += C.mpres_spec(name, nin, med, nin, T, True)
            elif kind == "conv":
                out += C.mpconv_spec(name, nin, nout, T, True)
            else:
                out += C.dense_spec(f"{name}.conv", nin, nout)
        g = f"{f}.merge_{midx}"
        if midx < n_layers - 1:
            out += C.dense_spec(f"{g}.conv", 2 * nout, nout) + C.bn_spec(
                f"{g}.bn", nout)
        else:
            w = cfg["final_hidden"]
            out += (C.dense_spec(f"{g}.conv1", 2 * nout, w)
                    + C.bn_spec(f"{g}.bn", w) + C.dense_spec(f"{g}.conv2", w, w)
                    + C.dense_spec(f"{g}.conv3", w, nout))
    return out


class Union:
    """The flat union of chains of ``lengths`` (in order): per factor
    type the joint table over [all vars ; all factors] (rows: that many
    destinations, K edges each), each row's local row in its chain's own
    table (to index the per-length edge weights), and each joint node's
    chain."""

    def __init__(self, lengths, hop_order, device):
        lengths = [int(L) for L in lengths]
        nv = sum(lengths)
        v_off = np.concatenate([[0], np.cumsum(lengths)])[:-1]
        self.nv, self.lengths = nv, lengths
        self.types = []
        for build in (pw_table, lambda n: high_table(n, hop_order)):
            rows, srcs, local, keys = [], [], [], []
            for c, L in enumerate(lengths):
                idx, _ = build(L)

                def glob(u, c=c, L=L):
                    return np.where(u < L, v_off[c] + u, nv + v_off[c] + u - L)

                rows.append(glob(np.arange(2 * L)))
                srcs.append(glob(idx))
                local.append(np.arange(2 * L))
                keys.append(np.full(2 * L, L))
            order = np.argsort(np.concatenate(rows), kind="stable")
            t = lambda a: torch.as_tensor(a, device=device)
            self.types.append(dict(
                idx=t(np.concatenate(srcs)[order]),
                local=t(np.concatenate(local)[order]),
                length=np.concatenate(keys)[order],
                ef={L: torch.as_tensor(build(L)[1], device=device)
                    for L in set(lengths)}))
        seg = np.concatenate([np.repeat(np.arange(len(lengths)), lengths)] * 2)
        self.seg = torch.as_tensor(seg, device=device)
        self.n_seg = len(lengths)

    def etypes(self, P, j, name, ctr=None):
        """Per joint row the (K, T) edge weights of type j: the MLP of each
        length's edge features, gathered by the row's local index."""
        ty = self.types[j]
        parts = {L: C.mlp(ef.to(P[f"{name}.dense_0.weight"].dtype), P, name,
                          2, ctr) for L, ef in ty["ef"].items()}
        out = None
        for L, et in parts.items():
            rows = torch.as_tensor(np.nonzero(ty["length"] == L)[0],
                                   device=et.device)
            piece = et[ty["local"][rows]]
            if out is None:
                out = et.new_zeros((len(ty["length"]),) + et.shape[1:])
            out = out.index_put((rows,), piece)
        return out


def forward(P, cfg, union: Union, inputs, train, ctr=None):
    """Logits (NV, 2) of the union's variables from node_feature (NV, 2),
    pws (NV, 4) and hops (NV, hop_order), flat over the chains."""
    d, f = cfg["dims"], "fmpnn"
    nv = union.nv
    ets = [union.etypes(P, 0, "emodel_pw", ctr),
           union.etypes(P, 1, "emodel_high", ctr)]
    x = C.leaky(C.dense(inputs["node_feature"], P, f"{f}.mapping_0.conv",
                        ctr))
    fs = [C.leaky(C.dense(inputs[k], P, f"{f}.mapping_{j + 1}.conv", ctr))
          for j, k in enumerate(("pws", "hops"))]
    n_layers = len(d) - 1
    for midx in range(n_layers):
        nin, nout = d[midx], d[midx + 1]
        cn, cf = [], []
        for j in range(2):
            joint = torch.cat([x, fs[j]], dim=0)
            name = f"{f}.mp_nn_{midx}_{j}"
            kind = _kind(cfg, nin, nout)
            idx = union.types[j]["idx"]
            if kind == "point":
                joint = torch.relu(C.segment_instance_norm(
                    C.dense(joint, P, f"{name}.conv", ctr), union.seg,
                    union.n_seg))
            elif kind == "conv":
                y = _conv(joint, idx, ets[j], P[f"{name}.filters"],
                          P[f"{name}.bias"], nout, "softmax", ctr)
                joint = torch.relu(C.batch_norm(y, P, f"{name}.bn", train))
            else:
                med = cfg["gnn_immediate_dim"]
                h = C.leaky(C.batch_norm(C.dense(joint, P, f"{name}.conv1",
                                                 ctr), P, f"{name}.bn1",
                                         train))
                y = _conv(h, idx, ets[j], P[f"{name}.mp_conv.filters"],
                          P[f"{name}.mp_conv.bias"], med, "max", ctr)
                h = torch.relu(C.batch_norm(y, P, f"{name}.mp_conv.bn",
                                            train))
                h = C.leaky(C.batch_norm(C.dense(h, P, f"{name}.conv2", ctr),
                                         P, f"{name}.bn2", train))
                joint = h + joint
            cn.append(joint[:nv])
            cf.append(joint[nv:])
        g = f"{f}.merge_{midx}"
        h = torch.cat(cn, dim=-1)
        if midx < n_layers - 1:
            x = torch.relu(C.batch_norm(C.dense(h, P, f"{g}.conv", ctr), P,
                                        f"{g}.bn", train))
        else:
            h = C.leaky(C.batch_norm(C.dense(h, P, f"{g}.conv1", ctr), P,
                                     f"{g}.bn", train))
            h = C.leaky(C.dense(h, P, f"{g}.conv2", ctr))
            x = C.dense(h, P, f"{g}.conv3", ctr)
        fs = cf
    return x


def loss(logits, label):
    """Cross-entropy of (NV, 2) logits against the exact MAP labels."""
    return F.cross_entropy(logits, label.reshape(-1).long())
