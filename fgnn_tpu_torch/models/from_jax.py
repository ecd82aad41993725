"""Carry a flax ``{params, batch_stats}`` tree into the port's modules.

The port names its submodules after the flax module names, so a flax leaf
path ``(..., module, leaf)`` is the port module ``"...module"`` and one of
its parameters or buffers:

  Dense      kernel (in, out)  -> weight (out, in), transposed;  bias -> bias
  BatchNorm  scale -> weight,  bias -> bias,
             batch_stats mean -> running_mean,  var -> running_var
  MPConv     filters -> filters (same layout, column c * T + t), bias -> bias

The load is strict: a flax leaf that finds no port tensor, a shape that
differs, or a port parameter or buffer left unfilled raises ``KeyError`` or
``ValueError``.  The tree is nested mappings of numpy arrays (or anything
``np.asarray`` takes); nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .mp_conv import MPConv
from .norm import BatchNorm, Dense

_LEAF_NAMES = {
    ("params", Dense): {"kernel": "weight", "bias": "bias"},
    ("params", BatchNorm): {"scale": "weight", "bias": "bias"},
    ("batch_stats", BatchNorm): {"mean": "running_mean", "var": "running_var"},
    ("params", MPConv): {"filters": "filters", "bias": "bias"},
}


def _leaves(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``module`` in place from ``{"params": ..., "batch_stats": ...}``."""
    state = module.state_dict()
    unfilled = set(state)
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected flax collection {collection!r}")
        for path, value in _leaves(tree):
            mod_path, leaf = ".".join(path[:-1]), path[-1]
            try:
                sub = module.get_submodule(mod_path)
            except AttributeError:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)}: no "
                               f"port module {mod_path!r}") from None
            names = next((v for (c, cls), v in _LEAF_NAMES.items()
                          if c == collection and isinstance(sub, cls)), {})
            if leaf not in names:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has "
                               f"no counterpart in {type(sub).__name__}")
            key = f"{mod_path}.{names[leaf]}" if mod_path else names[leaf]
            if key not in state:
                raise KeyError(f"flax leaf {collection}/{'/'.join(path)}: "
                               f"port tensor {key} does not exist")
            arr = np.asarray(value, dtype=np.float32)
            if isinstance(sub, Dense) and leaf == "kernel":
                arr = arr.T
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: flax shape {arr.shape}, port shape "
                                 f"{tuple(state[key].shape)}")
            with torch.no_grad():
                state[key].copy_(torch.from_numpy(np.array(arr)))
            unfilled.discard(key)
    if unfilled:
        raise KeyError(f"port tensors left unfilled by the flax tree: "
                       f"{sorted(unfilled)}")
    return module
