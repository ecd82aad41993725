"""Plain reference of the LDPC decoder (``LDPCModel``: a bipartite
FactorNN over the 96 variables and 48 checks of the 96.3.963 code and one
global factor), its loss and its training step.

Written from the model's description (upstream ``train_ldpc.py:19-99``,
arXiv:1906.00554) in plain PyTorch over a dict of parameters named as the
configuration's parameter tree.  The code's tables come from the
benchmark's own copy of the code files; every conv gathers its sources
edge by edge (``common.typed_conv``).

Layer rule of the FactorNN: nin == nout: a bottleneck block (Dense to
``gnn_immediate_dim``, BatchNorm, LeakyReLU, conv, Dense back, BatchNorm,
LeakyReLU) without its residual; nin, nout <= ``max_mpnn_dim``: a conv
with BatchNorm and ReLU; otherwise the bottleneck block to nout.  Each
layer adds v2v / f2f (Dense, InstanceNorm, ReLU) to the f2v / v2f
messages, adds the layer's input where the width is kept, then the skip
links.  Logits: Dense 128, InstanceNorm, ReLU, Dense 1, plus the received
signal; the burst-noise regressor reads the global factor's feature.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..traffic.ldpc_words import code_tables
from . import common as C

N_VARS, N_CHECKS, N_INFO = 96, 48, 48
EF_DIM, HOP = 7, 6


def _mp_kind(cfg, nin, nout):
    if nin == nout:
        return "res", nout
    if nin <= cfg["max_mpnn_dim"] and nout <= cfg["max_mpnn_dim"]:
        return "conv", nout
    return "res", nout


def specs(cfg) -> list:
    """(name, shape, init kind) of every parameter and statistic."""
    d = cfg["dims"]
    T, med = cfg["edge_types"], cfg["gnn_immediate_dim"]
    out = (C.mlp_spec("emodel_f2v", EF_DIM, [cfg["emodel_hidden"], T])
           + C.mlp_spec("emodel_v2f", EF_DIM, [cfg["emodel_hidden"], T]))
    m = "main"
    out += C.dense_spec(f"{m}.node_mapping.conv", cfg["node_feature_dim"],
                        d[0])
    for j, fd in enumerate((HOP, N_VARS)):
        out += (C.dense_spec(f"{m}.factor_mapping_{j}.conv", fd, d[0])
                + C.bn_spec(f"{m}.factor_mapping_{j}.bn", d[0]))
    for idx in range(len(d) - 1):
        nin, nout = d[idx], d[idx + 1]
        out += C.dense_spec(f"{m}.v2v_{idx}.conv", nin, nout)
        for j, t in enumerate((T, 1)):
            out += C.dense_spec(f"{m}.f2f_{idx}_{j}.conv", nin, nout)
            for side in ("f2v", "v2f"):
                kind, _ = _mp_kind(cfg, nin, nout)
                name = f"{m}.{side}_{idx}_{j}"
                out += (C.mpres_spec(name, nin, med, nout, t, False)
                        if kind == "res"
                        else C.mpconv_spec(name, nin, nout, t, False))
    out += (C.dense_spec(f"{m}.final_conv1", d[-1], cfg["final_hidden"])
            + C.dense_spec(f"{m}.final_conv2", cfg["final_hidden"], 1))
    r, w = "nhop_regressor", cfg["regressor_hidden"]
    out += (C.dense_spec(f"{r}.fc1", d[-1], w) + C.bn_spec(f"{r}.bn", w)
            + C.dense_spec(f"{r}.fc2", w, w) + C.dense_spec(f"{r}.fc3", w, 1))
    return out


def tables(device):
    """The conv tables: checks per variable (96, 3), variables per check
    (48, 6), and the global factor's (96, 1) and (1, 96)."""
    var_checks, factors, _ = code_tables()
    t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    return {"f2v": t(var_checks), "v2f": t(factors),
            "gf2v": torch.zeros(N_VARS, 1, dtype=torch.long, device=device),
            "gv2f": torch.arange(N_VARS, device=device).view(1, N_VARS)}


def _mpconv(P, name, x, idx, etype, nout, cfg, train, ctr):
    y = C.typed_conv(x, idx, etype, P[f"{name}.filters"], P[f"{name}.bias"],
                     nout, cfg["aggregator"], ctr=ctr)
    return torch.relu(C.batch_norm(y, P, f"{name}.bn", train))


def _mp(P, name, x, idx, etype, nin, nout, cfg, train, ctr):
    kind, _ = _mp_kind(cfg, nin, nout)
    if kind == "conv":
        return _mpconv(P, name, x, idx, etype, nout, cfg, train, ctr)
    med = cfg["gnn_immediate_dim"]
    h = C.leaky(C.batch_norm(C.dense(x, P, f"{name}.conv1", ctr), P,
                             f"{name}.bn1", train))
    h = _mpconv(P, f"{name}.mp_conv", h, idx, etype, med, cfg, train, ctr)
    return C.leaky(C.batch_norm(C.dense(h, P, f"{name}.conv2", ctr), P,
                                f"{name}.bn2", train))


def forward(P, cfg, tabs, inputs, train, ctr=None):
    """(logits over the info bits (B, 48), sigma_b prediction (B, 1)) of
    inputs node_feature (B, 96, 2), hop_feature (B, 48, 6), efeature_f2v
    (B, 96, 3, 7), efeature_v2f (B, 48, 6, 7)."""
    node = inputs["node_feature"]
    B = node.shape[0]
    d = cfg["dims"]
    et_f2v = C.mlp(inputs["efeature_f2v"], P, "emodel_f2v", 2, ctr)
    et_v2f = C.mlp(inputs["efeature_v2f"], P, "emodel_v2f", 2, ctr)
    one = node.new_ones(())
    etypes = {"f2v": [et_f2v, one.expand(B, N_VARS, 1, 1)],
              "v2f": [et_v2f, one.expand(B, 1, N_VARS, 1)]}
    idxs = {"f2v": [tabs["f2v"], tabs["gf2v"]],
            "v2f": [tabs["v2f"], tabs["gv2f"]]}
    m = "main"
    x = C.leaky(C.dense(node, P, f"{m}.node_mapping.conv", ctr))
    gfac = node[..., 0].detach().reshape(B, 1, N_VARS)
    fs = [torch.relu(C.batch_norm(C.dense(f, P, f"{m}.factor_mapping_{j}.conv",
                                          ctr),
                                  P, f"{m}.factor_mapping_{j}.bn", train))
          for j, f in enumerate((inputs["hop_feature"], gfac))]
    skip = {int(k): v for k, v in cfg["skip_link"].items()}
    inter = []
    for idx in range(len(d) - 1):
        nin, nout = d[idx], d[idx + 1]
        nfeat = torch.relu(C.instance_norm(C.dense(x, P, f"{m}.v2v_{idx}.conv",
                                                   ctr)))
        nf = [torch.relu(C.instance_norm(C.dense(
            fs[j], P, f"{m}.f2f_{idx}_{j}.conv", ctr))) for j in range(2)]
        for j in range(2):
            nfeat = nfeat + _mp(P, f"{m}.f2v_{idx}_{j}", fs[j],
                                idxs["f2v"][j], etypes["f2v"][j], nin, nout,
                                cfg, train, ctr)
            nf[j] = nf[j] + _mp(P, f"{m}.v2f_{idx}_{j}", x, idxs["v2f"][j],
                                etypes["v2f"][j], nin, nout, cfg, train, ctr)
        if nin == nout:
            x = x + nfeat
            fs = [a + b for a, b in zip(nf, fs)]
        else:
            x, fs = nfeat, nf
        if idx in skip:
            ox, ofs = inter[skip[idx]]
            x = x + ox
            fs = [a + b for a, b in zip(ofs, fs)]
        inter.append((x, fs))
    h = torch.relu(C.instance_norm(C.dense(x, P, f"{m}.final_conv1", ctr)))
    res = C.dense(h, P, f"{m}.final_conv2", ctr) + node[..., :1]
    r = "nhop_regressor"
    s = torch.relu(C.batch_norm(C.dense(fs[1].reshape(B, -1), P, f"{r}.fc1",
                                        ctr), P, f"{r}.bn", train))
    s = torch.relu(C.dense(s, P, f"{r}.fc2", ctr))
    s = torch.relu(C.dense(s, P, f"{r}.fc3", ctr))
    return res[:, :N_INFO, 0], s


def losses(cfg, logits, sb_pred, batch):
    """(the info bits' mean BCE, the MSE of 10^(sigma_b / 20))."""
    label = batch["label"][:, :N_INFO].to(logits.dtype)
    sigma_b = batch["sigma_b"].to(logits.dtype).reshape(-1)
    bce = F.binary_cross_entropy_with_logits(logits, label)
    mse = (sb_pred.reshape(-1) - torch.pow(10.0, sigma_b / 20.0)).square() \
        .mean()
    return bce, mse


def objective(cfg, bce, mse):
    return bce + cfg["sigma_b_weight"] * mse
