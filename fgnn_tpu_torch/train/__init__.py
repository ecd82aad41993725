"""Entry points of the port: ``python -m fgnn_tpu_torch.train.ldpc``, and
``syn_hop_factor``, ``syn_pw_factor``, ``syn_fixed_pw_hop``; the shared
training helpers of ``common``."""

from .common import (
    Schedules,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
    set_lr,
)

__all__ = ["Schedules", "load_checkpoint", "make_optimizer",
           "save_checkpoint", "set_lr"]
