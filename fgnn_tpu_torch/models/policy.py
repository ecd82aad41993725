"""The compute-dtype policy (counterpart of ``fgnn_tpu/models/policy.py``).

The default is float32 end to end.  Under ``compute_dtype(torch.bfloat16)``
(the trainers' ``--bf16``) every ``Dense`` casts its input to bf16, so the
activations, and with them the typed-mp convs (``ops/typed_mp.py``), run in
bf16; parameters, optimizer state and normalisation statistics stay f32.
The casts are explicit, as in the JAX package, and not ``torch.autocast``,
which picks its own dtype per op: with explicit casts each op of the port
runs in the dtype its JAX counterpart runs in.

The policy is a process global.  Set it for a scope with the
``compute_dtype`` context manager, which restores the previous one.
"""

from __future__ import annotations

import contextlib

import torch

_COMPUTE_DTYPE = None  # None: float32 end to end


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def get_compute_dtype():
    return _COMPUTE_DTYPE


def cast_compute(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the compute dtype (unchanged under the f32 policy)."""
    if _COMPUTE_DTYPE is not None and x.dtype != _COMPUTE_DTYPE:
        return x.to(_COMPUTE_DTYPE)
    return x


@contextlib.contextmanager
def compute_dtype(dtype):
    """Run the body under compute dtype ``dtype`` (None: f32)."""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev


def bf16_policy(bf16: bool):
    """The policy of a trainer's ``--bf16`` flag, as a context manager:
    bf16 compute, or f32 end to end."""
    return compute_dtype(torch.bfloat16 if bf16 else None)
