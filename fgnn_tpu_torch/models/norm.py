"""Linear and normalization layers with the JAX package's semantics.

Counterpart of ``fgnn_tpu/models/norm.py``, layout ``(B, N, C)``:

* ``Dense``: per-node linear map; ``weight`` is (out, in), the transpose
  of the flax kernel (in, out).
* ``BatchNorm``: normalise each channel over every other axis; running
  stats with momentum 0.1, eps 1e-5, biased variance to normalise and
  unbiased variance for the running average; statistics in f32 with the
  two-pass variance (a one-pass variant failed golden parity in the JAX
  package).  ``self.training`` selects batch or running statistics.
* ``instance_norm``: per (b, c) over N, no affine, no running stats.

Every module with parameters has ``init_(generator)``, which draws them
from the same distributions as the JAX init; ``init_weights`` walks a
model with one seeded ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform_(t: torch.Tensor, low: float, high: float,
             generator: torch.Generator) -> None:
    """Fill ``t`` with U(low, high) drawn on the CPU from ``generator``."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape, dtype=t.dtype).uniform_(
            low, high, generator=generator))


class Dense(nn.Linear):
    """Per-node linear map (torch Conv2d-1x1 init: U(+-1/sqrt(fan_in)))."""

    def init_(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        uniform_(self.weight, -bound, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, -bound, bound, generator)


class BatchNorm(nn.Module):
    """torch.nn.BatchNorm2d semantics on (..., C): stats over all axes but -1."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.ndim - 1))
            xf = x.float()
            mean = xf.mean(dim=dims)
            var = (xf - mean).square().mean(dim=dims)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        return (x - mean.to(x.dtype)) * inv * self.weight + self.bias


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.InstanceNorm2d defaults on (B, N, C): per (b, c) over N.

    On a (B, 1, C) input the output is all zeros, as in the JAX package."""
    xf = x.float()
    mean = xf.mean(dim=-2, keepdim=True)
    var = (xf - mean).square().mean(dim=-2, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``module`` from the JAX init's distributions,
    reproducibly from ``seed`` (the numbers differ from JAX's)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return module
