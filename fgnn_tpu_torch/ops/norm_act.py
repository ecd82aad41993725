"""Eval BatchNorm and instance norm with their activation in one pass on
Hopper: the wrappers of ``csrc/norm_act.cu``.

The norms of ``models/norm.py`` run as separate PyTorch kernels, each a
full pass over the tensor, and so does the ReLU or leaky ReLU after them.
Two hand-written kernels read the norm's input once and write its activated
output once:

* ``bn_act``: eval BatchNorm, ``((x - mean) * inv) * weight + bias`` on x
  viewed as (rows, C), with ``inv = rsqrt(running_var + eps)`` computed
  here as the plain version computes it.  Bit-equal to the plain version.
* ``in_act``: instance norm on (B, N, C), statistics per (b, c) over N in
  f32 with the two-pass variance.  Not bit-equal (another order of
  summation and a correctly rounded 1 / sqrt for rsqrt).

``engages`` is the rule under which the norms take them: an f32,
contiguous CUDA input, and parameters beside it, for which no autograd
graph is being recorded.  The norms decide the rest (BatchNorm not training,
instance norm without ``seg``) and count every call they run in plain
PyTorch under ``fused_mp.NORM_ACT_COUNTS["plain_calls"]``; the wrappers
count their launches there.  ``ACTIVATIONS`` names the activations both
take, as the plain versions do.

The library is built with the typed-mp kernels (``fused_mp.KERNELS``) and
launched on PyTorch's current stream; a launch error raises.
"""

from __future__ import annotations

import torch

from ..utils.debug import check_kernel_outputs
from . import fused_mp

ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
LEAKY_SLOPE = 0.01  # F.leaky_relu's default, the models' leaky ReLU


def engages(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether a norm of ``x`` with ``params`` takes the kernels: x and
    the params f32 and contiguous on one CUDA device, and no autograd graph
    recorded for them."""
    ts = (x, *params)
    return (x.is_cuda
            and all(t.dtype == torch.float32 and t.is_contiguous()
                    and t.device == x.device for t in ts)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts)))


def _check_vectors(x, C, **vectors):
    for name, t in vectors.items():
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != (C,)):
            raise ValueError(
                f"{name} must be a contiguous f32 ({C},) on {x.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def bn_act(x, mean, var, weight, bias, eps: float,
           activation=None) -> torch.Tensor:
    """Eval BatchNorm of x (..., C) with running ``mean`` and ``var``,
    ``weight`` and ``bias``, then ``activation``, in one launch."""
    C = x.shape[-1]
    inv = torch.rsqrt(var + eps)
    _check_vectors(x, C, mean=mean, inv=inv, weight=weight, bias=bias)
    out = torch.empty_like(x)
    vec4 = int(C % 4 == 0 and x.data_ptr() % 16 == 0)
    fused_mp._launch("norm_act", "bn_act", x.device, tuple(x.shape),
                     x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                     weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     x.numel() // max(C, 1), C, vec4, ACTIVATIONS[activation],
                     LEAKY_SLOPE)
    fused_mp.NORM_ACT_COUNTS["kernel_launches"] += 1
    check_kernel_outputs("bn_act", out)
    return out


def in_act(x, eps: float, activation=None) -> torch.Tensor:
    """Instance norm of x (..., N, C) per leading index and channel over N,
    then ``activation``, in one launch."""
    N, C = x.shape[-2:]
    out = torch.empty_like(x)
    fused_mp._launch("norm_act", "in_act", x.device, tuple(x.shape),
                     x.data_ptr(), out.data_ptr(), x.numel() // max(N * C, 1),
                     N, C, eps, ACTIVATIONS[activation], LEAKY_SLOPE)
    fused_mp.NORM_ACT_COUNTS["kernel_launches"] += 1
    check_kernel_outputs("in_act", out)
    return out

