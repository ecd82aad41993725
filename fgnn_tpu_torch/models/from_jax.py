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
``ValueError``.  ``flax_leaf`` is the map of one leaf and
``flax_tensors`` that of a tree, which the import of a JAX checkpoint's
Adam moments (``train/jax_checkpoint.py``) shares.
The tree is nested mappings of numpy arrays (or anything ``np.asarray``
takes); nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .mp_conv import MPConv
from .norm import BatchNorm, Dense

_COLLECTIONS = ("params", "batch_stats")
_LEAF_NAMES = {
    ("params", Dense): {"kernel": "weight", "bias": "bias"},
    ("params", BatchNorm): {"scale": "weight", "bias": "bias"},
    ("batch_stats", BatchNorm): {"mean": "running_mean", "var": "running_var"},
    ("params", MPConv): {"filters": "filters", "bias": "bias"},
}


def flax_leaves(tree: Mapping, prefix=()):
    """(path, value) of every leaf of a nested mapping, in its order."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from flax_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_leaf(module: nn.Module, collection: str, path,
              state: Mapping = None):
    """The port tensor of the flax leaf ``collection/path``: (its key in
    ``module.state_dict()``, whether the flax array is its transpose).
    Raises ``KeyError`` where the leaf has no counterpart."""
    if state is None:
        state = module.state_dict()
    mod_path, leaf = ".".join(path[:-1]), path[-1]
    name = f"{collection}/{'/'.join(path)}"
    try:
        sub = module.get_submodule(mod_path)
    except AttributeError:
        raise KeyError(f"flax leaf {name}: no port module "
                       f"{mod_path!r}") from None
    names = next((v for (c, cls), v in _LEAF_NAMES.items()
                  if c == collection and isinstance(sub, cls)), {})
    if leaf not in names:
        raise KeyError(f"flax leaf {name} has no counterpart in "
                       f"{type(sub).__name__}")
    key = f"{mod_path}.{names[leaf]}" if mod_path else names[leaf]
    if key not in state:
        raise KeyError(f"flax leaf {name}: port tensor {key} does not "
                       "exist")
    return key, isinstance(sub, Dense) and leaf == "kernel"


def flax_tensors(module: nn.Module, collection: str, tree,
                 state: Mapping = None) -> dict:
    """Every leaf of a flax tree of ``collection`` (a nested mapping, or
    (path, value) pairs) as port key -> f32 CPU tensor in the port's
    layout, each checked against the shape of its port tensor.  The Adam
    moments of the parameters (``train/jax_checkpoint.py``) take the
    parameters' map."""
    if collection not in _COLLECTIONS:
        raise KeyError(f"unexpected flax collection {collection!r}")
    if state is None:
        state = module.state_dict()
    out = {}
    for path, value in (flax_leaves(tree) if isinstance(tree, Mapping)
                        else tree):
        key, transpose = flax_leaf(module, collection, path, state)
        arr = np.asarray(value, dtype=np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: flax shape {arr.shape}, port shape "
                             f"{tuple(state[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr))
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``module`` in place from ``{"params": ..., "batch_stats": ...}``."""
    state = module.state_dict()
    unfilled = set(state)
    for collection, tree in variables.items():
        for key, value in flax_tensors(module, collection, tree,
                                       state).items():
            with torch.no_grad():
                state[key].copy_(value)
            unfilled.discard(key)
    if unfilled:
        raise KeyError(f"port tensors left unfilled by the flax tree: "
                       f"{sorted(unfilled)}")
    return module
