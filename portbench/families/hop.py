"""The synthetic hop MAP family: the program's hop trainer
(``fgnn_tpu_torch.train.synthetic``: ``SynWorkload``, its ``stage`` and
``train_step``; dense tables, or ``--coo`` over a flat union with
``--mixed-lengths``) and the plain reference (``reference/hop.py``) on
the same weights and chains.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..reference import common as C
from ..reference import hop as ref

LOSSES = ("loss",)


def specs(cfg):
    return ref.specs(cfg)


def lengths_of(cfg, mix):
    return [int(L) for L in mix.get("lengths", [cfg["chain_length"]])]


class Program:
    """The port's hop trainer on ``device`` with the benchmark's weights."""

    def __init__(self, cfg, mix, batch, device):
        from fgnn_tpu_torch.train import common, synthetic

        self.synthetic, self.device = synthetic, device
        lengths = lengths_of(cfg, mix)
        coo = bool(mix.get("coo"))
        if not coo and lengths != [cfg["chain_length"]]:
            raise ValueError("the dense tables hold chains of the "
                             "configuration's length only")
        args = argparse.Namespace(
            chain_length=cfg["chain_length"], hop_order=cfg["hop_order"],
            hop_cap=0, neighbour=0, seed=0, batch_size=batch,
            dims=tuple(cfg["dims"]), coo=coo,
            mixed_lengths=",".join(map(str, lengths)) if coo else "",
            length_dist="", model_name="hop")
        self.wl = synthetic.SynWorkload("hop", args).to(device)
        self.model = self.wl.model
        opt = cfg["optimizer"]
        self.optimizer = common.make_optimizer(
            self.model.parameters(), opt["lr"],
            weight_decay=opt["weight_decay"])

    def stage(self, batch):
        return self.wl.stage(batch, self.device)

    def step(self, staged):
        return self.synthetic.train_step(self.wl, self.optimizer, staged,
                                         self.device)


class Reference:
    """The plain reference on ``device`` in ``dtype``."""

    def __init__(self, cfg, mix, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.lengths = lengths_of(cfg, mix)
        self._unions = {}

    def union(self, n):
        if n not in self._unions:
            self._unions[n] = ref.Union(self.lengths * n,
                                        self.cfg["hop_order"], self.device)
        return self._unions[n]

    def inputs(self, batch, dtype, rows=slice(None)):
        get = lambda k: np.asarray(batch[k])[rows]
        node = get("node_feature")
        flat = lambda a: torch.as_tensor(a.reshape(-1, a.shape[-1]),
                                         device=self.device).to(dtype)
        return node.shape[0], {
            "node_feature": flat(node), "pws": flat(get("pws")),
            "hops": flat(get("efeature_hop")),
            "label": torch.as_tensor(get("label").reshape(-1),
                                     device=self.device)}

    def count(self, batch, n):
        ctr = C.Counter()
        m, inp = self.inputs(batch, torch.float32, slice(0, n))
        with torch.no_grad():
            ref.forward(C.placeholders(specs(self.cfg), self.device),
                        self.cfg, self.union(m), inp, True, ctr)
        return ctr

    def train(self, P, batches, dtype, n_steps, rows=slice(None)):
        """``n_steps`` clipped Adam steps from P (updated in place);
        returns (each step's [loss], the first step's clipped
        gradients)."""
        opt = self.cfg["optimizer"]
        leaves = [s[0] for s in specs(self.cfg) if C.is_parameter(s)]

        def grads(step):
            m, inp = self.inputs(batches[step], dtype, rows)
            params = {k: v.detach().requires_grad_(k in leaves)
                      for k, v in P.items()}
            logits = ref.forward(params, self.cfg, self.union(m), inp, True)
            loss = ref.loss(logits, inp["label"])
            g = torch.autograd.grad(loss, [params[k] for k in leaves],
                                    allow_unused=True)
            return [float(loss.detach())], dict(zip(leaves, g))

        return C.adam_steps(P, grads, n_steps, opt["lr"], tuple(opt["betas"]),
                            opt["eps"], opt["weight_decay"],
                            clip=opt["clip_norm"])
