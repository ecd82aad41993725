"""Numerics debugging helpers (counterpart of ``fgnn_tpu/utils/debug.py``).

* ``nan_debug``: a context manager under which an op that produces a NaN
  raises ``FloatingPointError``, as ``jax_debug_nans`` does (NaN only, not
  Inf).
* ``check_finite``: raise on the non-finite leaves of nested dicts, lists
  and tuples of tensors (a ``state_dict`` included), naming their paths.
* ``deterministic``: seed numpy's global generator and return a seeded
  ``torch.Generator``, the explicit generator in place of a ``PRNGKey``.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import numpy as np
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

# factories whose output is memory not yet written: a NaN there is garbage
_UNWRITTEN = frozenset(
    getattr(torch.ops.aten, name) for name in (
        "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "resize_", "set_"))


def _nan_tensors(out):
    """The floating tensors of an op's output that hold a NaN."""
    if isinstance(out, torch.Tensor):
        out = (out,)
    if not isinstance(out, (tuple, list)):
        return []
    return [t for t in out if isinstance(t, torch.Tensor)
            and t.is_floating_point() and bool(torch.isnan(t).any())]


class NanCheckMode(TorchDispatchMode):
    """Checks the floating outputs of every dispatched op for NaN while
    ``enabled``.  Autograd carries the mode into the backward's threads,
    so the backward's ops are checked too."""

    def __init__(self):
        super().__init__()
        self.enabled = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.enabled and func.overloadpacket not in _UNWRITTEN \
                and _nan_tensors(out):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


def nan_checks_on() -> bool:
    """Whether a ``nan_debug`` block is active in this thread (or the
    backward of a graph built in one)."""
    return any(isinstance(m, NanCheckMode) and m.enabled
               for m in _get_current_dispatch_mode_stack())


def check_kernel_outputs(name: str, *tensors, enabled=None) -> None:
    """Raise ``FloatingPointError`` where a hand-written kernel wrote a
    NaN into one of ``tensors`` and ``nan_debug`` is active (or
    ``enabled``: a backward passes whether its forward ran under it).
    The kernels launch through ``ctypes``, past the dispatcher, so their
    autograd node calls this after each launch (``ops/fused_mp.py``)."""
    if enabled is None:
        enabled = nan_checks_on()
    if enabled and _nan_tensors([t for t in tensors if t is not None]):
        raise FloatingPointError(f"NaN in the output of the {name} kernel")


@contextlib.contextmanager
def nan_debug(enabled: bool = True):
    """Inside the block, an op that produces a NaN raises
    ``FloatingPointError``; ``enabled=False`` switches an enclosing
    block's checks off until this one ends.

    Covered: every op that goes through the PyTorch dispatcher, forward
    and backward (its floating outputs), and the outputs of the port's
    CUDA kernels (out, dh, d_etype; ``check_kernel_outputs``), which write
    outside the dispatcher.  Not covered: Inf, and memory written by
    other native code outside the dispatcher.  Each check reads a flag
    back to the host, so the block runs synchronously on the card."""
    outer = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, NanCheckMode)]
    prev = [m.enabled for m in outer]
    for m in outer:
        m.enabled = enabled
    try:
        with NanCheckMode() if enabled and not outer \
                else contextlib.nullcontext():
            yield
    finally:
        for m, e in zip(outer, prev):
            m.enabled = e


def _leaves(tree, path=""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the path of every floating
    tensor leaf of ``tree`` that holds a NaN or an Inf."""
    bad = [path for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def deterministic(seed: int = 0) -> torch.Generator:
    """Seed numpy's global generator; return a ``torch.Generator`` seeded
    with ``seed`` (pass it where the JAX package passes a key)."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
