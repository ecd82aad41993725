"""Per-node MLP maps (counterpart of ``fgnn_tpu/models/base.py``).

* ``IIDMap``:   Dense + LeakyReLU
* ``IIDMapBN``: Dense + BatchNorm + ReLU
* ``IIDMapIN``: Dense + InstanceNorm + ReLU
* ``MLP``:      Dense stack with ReLU between layers
* ``MessagePassing``: the marker of modules whose forward takes
  (x, table, etype); the containers pass them the graph
* ``MaxPoolNodes``: max over the node axis, keepdim
* ``Flatten``:  (B, ...) -> (B, -1)
* ``Identity``: pass-through
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .norm import BatchNorm, Dense, instance_norm, leaky_relu


class MessagePassing(nn.Module):
    """Marker base of modules whose forward takes (x, table, etype): the
    containers (``containers._is_mp``) give such a child the graph."""

    def is_mp(self) -> bool:
        return True


class IIDMap(nn.Module):
    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.conv(x))


class IIDMapBN(nn.Module):
    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), activation="relu")


class IIDMapIN(nn.Module):
    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(self.conv(x), activation="relu")


class MLP(nn.Module):
    """Submodules ``dense_{i}``, as the flax module names them."""

    def __init__(self, nin: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(nin, f))
            nin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class MaxPoolNodes(nn.Module):
    """Max over the node axis ``axis``, keeping it (size 1)."""

    def __init__(self, axis: int = -2):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=self.axis, keepdim=True)


class Flatten(nn.Module):
    """(B, ...) -> (B, -1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
