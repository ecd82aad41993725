"""MPConv: the module around the typed-edge conv (counterpart of
``fgnn_tpu/models/mp_conv.py``, dense-table branch, NO_EXTENSION)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.typed_mp import GatherTable, typed_mp_conv
from .norm import BatchNorm, Dense, leaky_relu, uniform_


class MPConv(nn.Module):
    """gather -> filter bank -> etype mix -> aggregate -> bias -> BatchNorm
    -> ReLU.  ``filters`` (nin, nout * T) keeps the JAX column layout
    c * T + t."""

    def __init__(self, nin: int, nout: int, nedge_types: int, *,
                 aggregator: str = "softmax"):
        super().__init__()
        self.nout = nout
        self.aggregator = aggregator
        self.filters = nn.Parameter(torch.empty(nin, nout * nedge_types))
        self.bias = nn.Parameter(torch.empty(nout))
        self.bn = BatchNorm(nout)

    def init_(self, generator: torch.Generator) -> None:
        uniform_(self.filters, -0.01, 0.01, generator)
        uniform_(self.bias, 0.0, 0.05, generator)

    def forward(self, x: torch.Tensor, table: GatherTable,
                etype: torch.Tensor) -> torch.Tensor:
        y = typed_mp_conv(x, table, etype, self.filters, self.nout,
                          aggregator=self.aggregator, bias=self.bias)
        return torch.relu(self.bn(y))


class MPConvResidual(nn.Module):
    """Bottleneck block: Dense(nin->nmed)+BN+LeakyReLU -> MPConv(nmed->nmed)
    -> Dense(nmed->nout)+BN+LeakyReLU [+ x when ``with_residual``]."""

    def __init__(self, nin: int, nmed: int, nedge_types: int, *,
                 with_residual: bool = True, aggregator: str = "max",
                 nout: Optional[int] = None):
        super().__init__()
        nout = nin if nout is None else nout
        self.with_residual = with_residual
        self.conv1 = Dense(nin, nmed)
        self.bn1 = BatchNorm(nmed)
        self.mp_conv = MPConv(nmed, nmed, nedge_types, aggregator=aggregator)
        self.conv2 = Dense(nmed, nout)
        self.bn2 = BatchNorm(nout)

    def forward(self, x: torch.Tensor, table: GatherTable,
                etype: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.bn1(self.conv1(x)))
        h = self.mp_conv(h, table, etype)
        h = leaky_relu(self.bn2(self.conv2(h)))
        if self.with_residual:
            h = h + x
        return h
