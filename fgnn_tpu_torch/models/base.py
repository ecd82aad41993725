"""Per-node MLP maps (counterpart of ``fgnn_tpu/models/base.py``).

* ``IIDMap``:   Dense + LeakyReLU
* ``IIDMapBN``: Dense + BatchNorm + ReLU
* ``IIDMapIN``: Dense + InstanceNorm + ReLU
* ``MLP``:      Dense stack with ReLU between layers
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .norm import BatchNorm, Dense, instance_norm, leaky_relu


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
        return torch.relu(self.bn(self.conv(x)))


class IIDMapIN(nn.Module):
    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(instance_norm(self.conv(x)))


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
