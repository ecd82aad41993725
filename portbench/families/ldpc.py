"""The LDPC decoder family: the program's entry points
(``fgnn_tpu_torch.train.ldpc``: ``decode_step`` over ``decode_logits``,
``stage_batch``, ``train_step``) and the plain reference
(``reference/ldpc.py``) on the same weights and words.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import common as C
from ..reference import ldpc as ref

INPUTS = ("node_feature", "hop_feature", "efeature_f2v", "efeature_v2f")
LOSSES = ("loss", "sigma_b_loss")


def specs(cfg):
    return ref.specs(cfg)


class Program:
    """The port's decoder on ``device`` with the benchmark's weights."""

    def __init__(self, cfg, mix, batch, device):
        from fgnn_tpu_torch.models import LDPCModel
        from fgnn_tpu_torch.train import common, ldpc

        self.ldpc, self.cfg, self.device = ldpc, cfg, device
        self.model = LDPCModel(
            aggregator=cfg["aggregator"], dim_mapping_list=cfg["dims"],
            skip_link={int(k): v for k, v in cfg["skip_link"].items()},
            node_feature_dim=cfg["node_feature_dim"]).to(device)
        self.optimizer = None
        if mix["loop"] == "train":
            opt = cfg["optimizer"]
            self.optimizer = common.make_optimizer(
                self.model.parameters(), opt["lr"], opt["weight_decay"])

    def stage(self, batch):
        return self.ldpc.stage_batch(self.model, batch, self.device)

    def step(self, staged):
        return self.ldpc.train_step(self.model, self.optimizer, staged,
                                    self.device, self.cfg["clean_weight"])

    def decode(self, batch):
        """Decisions (B, 48) of a host batch, left on the device."""
        return self.ldpc.decode_step(self.model, batch, self.device)

    def probe_stage(self, batch):
        return self.ldpc.model_inputs(self.model, batch, self.device)


class Reference:
    """The plain reference on ``device`` in ``dtype``."""

    def __init__(self, cfg, mix, device):
        self.cfg, self.device = cfg, device
        self.tabs = ref.tables(device)

    def inputs(self, batch, dtype, rows=slice(None)):
        out = {k: torch.as_tensor(np.asarray(batch[k])[rows],
                                  device=self.device).to(dtype)
               for k in INPUTS}
        out["label"] = torch.as_tensor(np.asarray(batch["label"])[rows],
                                       device=self.device)
        out["sigma_b"] = torch.as_tensor(np.asarray(batch["sigma_b"])[rows],
                                         device=self.device)
        return out

    def decode_logits(self, P, batch, dtype, rows=slice(None)):
        with torch.no_grad():
            logits, _ = ref.forward(P, self.cfg, self.tabs,
                                    self.inputs(batch, dtype, rows), False)
        return logits

    def count(self, batch, n):
        """Operations and convs of a forward over the first n words."""
        ctr = C.Counter()
        with torch.no_grad():
            ref.forward(C.placeholders(specs(self.cfg), self.device),
                        self.cfg, self.tabs,
                        self.inputs(batch, torch.float32, slice(0, n)),
                        True, ctr)
        return ctr

    def train(self, P, batches, dtype, n_steps, rows=slice(None)):
        """``n_steps`` Adam steps from parameters P (updated in place) on
        ``batches``; returns (each step's [bce, mse], the first step's
        gradients as the optimizer takes them)."""
        opt = self.cfg["optimizer"]
        leaves = [s[0] for s in specs(self.cfg) if C.is_parameter(s)]

        def grads(step):
            inp = self.inputs(batches[step], dtype, rows)
            params = {k: (v.detach().requires_grad_(k in leaves))
                      for k, v in P.items()}
            logits, sb = ref.forward(params, self.cfg, self.tabs, inp, True)
            bce, mse = ref.losses(self.cfg, logits, sb, inp)
            g = torch.autograd.grad(ref.objective(self.cfg, bce, mse),
                                    [params[k] for k in leaves],
                                    allow_unused=True)
            return [float(bce.detach()), float(mse.detach())], dict(
                zip(leaves, g))

        return C.adam_steps(P, grads, n_steps, opt["lr"], tuple(opt["betas"]),
                            opt["eps"], opt["weight_decay"])
