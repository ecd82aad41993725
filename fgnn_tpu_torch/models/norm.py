"""Linear and normalization layers with the JAX package's semantics.

Counterpart of ``fgnn_tpu/models/norm.py``, layout ``(B, N, C)``:

* ``Dense``: per-node linear map; ``weight`` is (out, in), the transpose
  of the flax kernel (in, out).  It casts its input to the compute dtype
  (``models/policy.py``); under bf16 the product is rounded to bf16 and
  the bias added in bf16, as the flax module does.
* ``BatchNorm``: normalise each channel over every other axis; running
  stats with momentum 0.1, eps 1e-5, biased variance to normalise and
  unbiased variance for the running average; statistics in f32 (f64 for
  an f64 input, a reference run) with the two-pass variance (a one-pass
  variant failed golden parity in the JAX package).  ``self.training``
  selects batch or running statistics.  The output is in x's dtype:
  statistics, scale and shift are cast to it, as the flax module does.
  With a ``data_group`` (set by ``train.common.prepare_mesh_training``,
  or passed by the halo conv) the batch statistics are those of the
  global batch, SyncBatchNorm, as jit over a mesh computes them in the
  JAX package: the sums and counts, then the squared deviations, are
  all-reduced over the group (``parallel.comm.all_reduce_sum``, whose
  backward all-reduces the cotangents), and the running variance takes
  the global count.  Without one (a group of one rank) the code and its
  bits are the unmeshed ones.
* ``instance_norm``: per (b, c) over N, no affine, no running stats;
  statistics in f32, the result in x's dtype.  On a flat disjoint union
  (x (N_flat, C)) it takes the nodes grouped by sample
  (``ops.segment.segment_bins``, a ``CooGraph``'s ``bins``): statistics
  per (sample, channel), padding nodes in a bin of their own, counts
  floored at 1, through the deterministic segment sum.  ``InstanceNorm``
  is the same as a module without parameters.

Every module with parameters has ``init_(generator)``, which draws them
from the same distributions as the JAX init; ``init_weights`` walks a
model with one seeded ``torch.Generator``.  ``BatchNorm`` and
``instance_norm`` each run inside a ``norm`` span
(``utils.profiling.annotate``).

Both take the activation that follows them (``activation``: None,
"relu" or "leaky_relu"), so that an eval norm on the card runs as one
kernel with it (``ops/norm_act.py``): eval BatchNorm, and
``instance_norm`` without ``seg``, on an f32 contiguous CUDA input with no
autograd graph recorded (``norm_act.engages``).  Everything else runs the
plain code below and counts a plain call (``fused_mp.NORM_ACT_COUNTS``):
the CPU, bf16 (whose rounding follows the JAX chain step by step),
training, the COO and the halo's group statistics.  The plain code applies
the activation in place (``_activate_``) on the norm's fresh result: the
same kernels and bits as ``torch.relu`` or ``leaky_relu`` after the norm,
and no tensor of the input's size allocated while the caller still holds
the input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import norm_act
from ..ops.fused_mp import NORM_ACT_COUNTS
from ..ops.segment import Segments, gather, segment_sum
from ..parallel.comm import all_reduce_sum
from ..utils.profiling import annotate
from .policy import cast_compute


def _stats(x: torch.Tensor) -> torch.Tensor:
    """x in the type its statistics are taken in: f32, or f64 for f64."""
    return x if x.dtype == torch.float64 else x.float()


def uniform_(t: torch.Tensor, low: float, high: float,
             generator: torch.Generator) -> None:
    """Fill ``t`` with U(low, high) drawn on the CPU from ``generator``."""
    with torch.no_grad():
        t.copy_(torch.empty(t.shape, dtype=t.dtype).uniform_(
            low, high, generator=generator))


class Dense(nn.Linear):
    """Per-node linear map (torch Conv2d-1x1 init: U(+-1/sqrt(fan_in)))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast_compute(x)
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)

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
        self.data_group = None

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, group=None,
                activation: Optional[str] = None) -> torch.Tensor:
        """``group``: take the batch statistics over it, in place of
        ``data_group``; ``activation``: apply it to the result."""
        _check_activation(activation)
        group = self.data_group if group is None else group
        with annotate("norm"):
            if not self.training and norm_act.engages(
                    x, self.running_mean, self.running_var, self.weight,
                    self.bias):
                return norm_act.bn_act(x, self.running_mean,
                                       self.running_var, self.weight,
                                       self.bias, self.eps, activation)
            NORM_ACT_COUNTS["plain_calls"] += 1
            if self.training:
                dims = tuple(range(x.ndim - 1))
                xf = _stats(x)
                if group is None:
                    mean = xf.mean(dim=dims)
                    var = (xf - mean).square().mean(dim=dims)
                    n = x.numel() // x.shape[-1]
                    factor = n / max(n - 1, 1)
                else:
                    mean, var, factor = _global_moments(xf, dims, group)
                with torch.no_grad():
                    unbiased = var * factor
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
            else:
                mean, var = self.running_mean, self.running_var
            dt = x.dtype
            inv = torch.rsqrt(var + self.eps).to(dt)
            return _activate_((x - mean.to(dt)) * inv * self.weight.to(dt)
                              + self.bias.to(dt), activation)


def _global_moments(xf, dims, group):
    """(mean, biased variance, n / (n - 1)) of xf over ``dims`` and the
    ranks of ``group``, two-pass; n stays on the device."""
    n_local = xf.numel() // xf.shape[-1]
    sums = all_reduce_sum(torch.cat([xf.sum(dim=dims),
                                     xf.new_full((1,), n_local)]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    var = all_reduce_sum((xf - mean).square().sum(dim=dims), group) / n
    return mean, var, (n / (n - 1).clamp_min(1)).detach()


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  seg: Optional[Segments] = None,
                  activation: Optional[str] = None) -> torch.Tensor:
    """torch.nn.InstanceNorm2d defaults on (B, N, C): per (b, c) over N,
    then ``activation``.

    On a (B, 1, C) input the output is all zeros, as in the JAX package.
    With ``seg`` (the nodes of a flat x (N_flat, C) grouped by sample, the
    last bin the padding) the statistics are per (sample, c)."""
    _check_activation(activation)
    with annotate("norm"):
        if seg is None and norm_act.engages(x):
            return norm_act.in_act(x, eps, activation)
        NORM_ACT_COUNTS["plain_calls"] += 1
        xf = _stats(x)
        if seg is None:
            mean = xf.mean(dim=-2, keepdim=True)
            var = (xf - mean).square().mean(dim=-2, keepdim=True)
            y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        else:
            cnt = seg.count.to(xf.dtype).clamp_min(1.0)[:, None]
            dev = xf - gather(segment_sum(xf, seg) / cnt, seg)
            var = segment_sum(dev.square(), seg) / cnt
            y = (dev * torch.rsqrt(gather(var, seg) + eps)).to(x.dtype)
        return _activate_(y, activation)


class InstanceNorm(nn.Module):
    """``instance_norm`` as a module, with no parameters: the JAX module
    ``InstanceNorm`` (torch.nn.InstanceNorm2d's defaults)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, seg: Optional[Segments] = None
                ) -> torch.Tensor:
        return instance_norm(x, self.eps, seg)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def _check_activation(activation) -> None:
    if activation not in norm_act.ACTIVATIONS:
        raise ValueError(f"activation is one of "
                         f"{sorted(map(str, norm_act.ACTIVATIONS))}; got "
                         f"{activation!r}")


def _activate_(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """y, or ReLU or leaky ReLU applied to it in place, for ``activation``
    None, "relu" or "leaky_relu".  y is a norm's result, which no autograd
    node saved: the in-place ops save their output, as ``torch.relu``
    does, and ``leaky_relu``'s gradient from its output equals the one from
    its input for a positive slope."""
    if activation == "relu":
        return torch.relu_(y)
    return y if activation is None else F.leaky_relu(
        y, norm_act.LEAKY_SLOPE, inplace=True)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``module`` from the JAX init's distributions,
    reproducibly from ``seed`` (the numbers differ from JAX's)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return module
