"""The ECCT family: the program's ECCT (``fgnn_tpu_torch.models.ecct``, on
the program's own copy of the code) with its trainer's steps
(``fgnn_tpu_torch.train.ecct``: ``stage_batch``, ``train_step``,
``decode_step``) and the plain reference (``reference/ecct.py``) on the
same weights and words.

The program's model module is imported with this module, so that a
checkout whose program has no ECCT fails as the run starts, before any
worker process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from fgnn_tpu_torch.models.ecct import ECCT

from ..reference import common as C
from ..reference import ecct as ref

LOSSES = ("loss",)
# words of a block of the reference's train step: its dense masked scores
# take 2 x 8 x 144^2 x 4 bytes a word and layer in f32
REF_BLOCK = 1024


def specs(cfg):
    return ref.specs(cfg)


class Program:
    """The port's ECCT and its Adam on ``device``, for the benchmark's
    weights."""

    def __init__(self, cfg, mix, batch, device):
        from fgnn_tpu_torch.data import parity_check
        from fgnn_tpu_torch.train import common
        from fgnn_tpu_torch.train import ecct as trainer

        self.trainer, self.device = trainer, device
        self.model = ECCT(ref.N_BITS, parity_check(), cfg["dims"],
                          cfg["layers"], cfg["heads"]).to(device)
        opt = cfg["optimizer"]
        self.optimizer = common.make_optimizer(
            self.model.parameters(), opt["lr"], opt["weight_decay"])

    def stage(self, batch):
        return self.trainer.stage_batch(batch, self.device)

    def step(self, staged):
        return self.trainer.train_step(self.model, self.optimizer, staged,
                                       self.device)

    def decode(self, batch):
        """Decoded words (B, 96) of a host batch, left on the device."""
        return self.trainer.decode_step(self.model, batch, self.device)


class Reference:
    """The plain reference on ``device`` in ``dtype``."""

    def __init__(self, cfg, mix, device):
        self.cfg, self.device = cfg, device
        self.tabs = ref.Tables(device)

    def inputs(self, batch, dtype, rows=slice(None)):
        """(received words at unit amplitude (B, 96), flips (B, 96)), in
        ``dtype``."""
        get = lambda k: torch.as_tensor(np.asarray(batch[k])[rows],
                                        device=self.device)
        y = ref.unit_amplitude(get("y").to(dtype), get("snr_db").to(dtype))
        return y, ref.flips(y, get("label"))

    def count(self, batch, n):
        """Operations of a forward over the first n words."""
        ctr = C.Counter()
        y, _ = self.inputs(batch, torch.float32, slice(0, n))
        with torch.no_grad():
            ref.forward(C.placeholders(specs(self.cfg), self.device),
                        self.cfg, self.tabs, y, ctr)
        return ctr

    def train(self, P, batches, dtype, n_steps, rows=slice(None)):
        """``n_steps`` Adam steps from P (updated in place) on ``batches``,
        each step's gradient summed over blocks of ``REF_BLOCK`` words;
        returns (each step's [bce], the first step's gradients)."""
        opt = self.cfg["optimizer"]
        leaves = [s[0] for s in specs(self.cfg) if C.is_parameter(s)]

        def grads(step):
            y, f = self.inputs(batches[step], dtype, rows)
            total, loss, g = y.numel(), 0.0, None
            for lo in range(0, y.shape[0], REF_BLOCK):
                params = {k: v.detach().requires_grad_(k in leaves)
                          for k, v in P.items()}
                logits = ref.forward(params, self.cfg, self.tabs,
                                     y[lo:lo + REF_BLOCK])
                part = F.binary_cross_entropy_with_logits(
                    logits, f[lo:lo + REF_BLOCK], reduction="sum") / total
                gs = torch.autograd.grad(part, [params[k] for k in leaves])
                g = list(gs) if g is None else [a + b for a, b in zip(g, gs)]
                loss += float(part.detach())
            return [loss], dict(zip(leaves, g))

        return C.adam_steps(P, grads, n_steps, opt["lr"], tuple(opt["betas"]),
                            opt["eps"], opt["weight_decay"])
