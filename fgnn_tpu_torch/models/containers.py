"""Containers (counterpart of ``fgnn_tpu/models/containers.py``).

* ``MPSequential``: pass (x, table, etype) to message-passing children, x
  alone to per-node ones.
* ``IIDBlock``: Dense + BatchNorm + ReLU.

``ParallelNet``, ``MPEnsemble`` and ``GlobalPooling`` are on no ported path
yet (ROADMAP.md, port queue item 8).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.typed_mp import GatherTable
from .mp_conv import MPConv, MPConvResidual
from .norm import BatchNorm, Dense


class IIDBlock(nn.Module):
    """Dense + BatchNorm + ReLU, the block the reference's mp_sequential
    models put between message-passing layers."""

    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class MPSequential(nn.Module):
    """Run ``layers`` in order, layout (B, N, C).

    A child is named as flax names a module built in its parent's compact
    scope, ``{class name}_{i}`` counted per class (``MPConv_0``,
    ``MPConvResidual_0``, ``IIDBlock_0``, ``Dense_0``, ...), so that the
    JAX model's parameters carry across by path."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        counts: dict = {}
        self.order = []
        for mod in layers:
            cls = type(mod).__name__
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            self.add_module(name, mod)
            self.order.append(name)

    def forward(self, x: torch.Tensor, table: GatherTable,
                etype: torch.Tensor) -> torch.Tensor:
        for name in self.order:
            mod = getattr(self, name)
            if isinstance(mod, (MPConv, MPConvResidual)):
                x = mod(x, table, etype)
            else:
                x = mod(x)
        return x
