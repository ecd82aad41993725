"""Containers (counterpart of ``fgnn_tpu/models/containers.py``).

* ``MPSequential``: pass (x, table, etype) to message-passing children
  (``_is_mp``), x alone to per-node ones.
* ``IIDBlock``: Dense + BatchNorm + ReLU.
* ``ParallelNet``: fan x through several modules and sum the outputs (or
  aggregate them with a given function).
* ``MPEnsemble``: model1(x, graph) and model2(x, *extra), channels
  concatenated, through model3.
* ``GlobalPooling``: max-pool over the nodes, map, broadcast back and
  concatenate onto the (mapped) node features.

The children carry the flax attribute names (``branches_{i}``, ``model1``
to ``model3``, ``orig_mapper``, ``gfeature_mapper``), so that
``load_flax_variables`` fills them from a flax tree.  No model of the
repository uses the last three.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.typed_mp import GatherTable
from .base import MessagePassing
from .mp_conv import MPConv, MPConvResidual
from .norm import BatchNorm, Dense


class IIDBlock(nn.Module):
    """Dense + BatchNorm + ReLU, the block the reference's mp_sequential
    models put between message-passing layers."""

    def __init__(self, nin: int, features: int):
        super().__init__()
        self.conv = Dense(nin, features)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), activation="relu")


class MPSequential(nn.Module):
    """Run ``layers`` in order, layout (B, N, C).

    A child is named as flax names a module built in its parent's compact
    scope, ``{class name}_{i}`` counted per class (``MPConv_0``,
    ``MPConvResidual_0``, ``IIDBlock_0``, ``Dense_0``, ...), so that the
    JAX model's parameters carry across by path.  A child that returns a
    tuple passes its first element on; the rest are collected, and then
    the container returns (x, the collected list), as the JAX one."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        counts: dict = {}
        self.order = []
        for mod in layers:
            cls = type(mod).__name__
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            self.add_module(name, mod)
            self.order.append(name)

    def forward(self, x: torch.Tensor, table: GatherTable = None,
                etype: torch.Tensor = None):
        extra = []
        for name in self.order:
            x = _apply(getattr(self, name), x, table, etype)
            if isinstance(x, tuple):
                extra.extend(x[1:])
                x = x[0]
        return (x, extra) if extra else x


def _is_mp(mod: nn.Module) -> bool:
    """Whether a child takes the graph, by the JAX package's rule: a
    ``MessagePassing``, ``MPConv`` or ``MPConvResidual``, or a module with
    a true ``takes_graph``.  ``GConvResidual`` is none of these, there as
    here, so a container gives it x alone."""
    return isinstance(mod, (MessagePassing, MPConv, MPConvResidual)) or \
        getattr(mod, "takes_graph", False)


def _apply(mod: nn.Module, x, table, etype):
    """A message-passing child gets the graph, any other x alone."""
    if _is_mp(mod):
        return mod(x, table, etype)
    return mod(x)


class ParallelNet(nn.Module):
    """Fan x through ``branches`` and sum their outputs, or pass them to
    ``aggregator``."""

    def __init__(self, branches: Sequence[nn.Module],
                 aggregator: Optional[Callable] = None):
        super().__init__()
        self.n_branches = len(branches)
        for i, mod in enumerate(branches):
            self.add_module(f"branches_{i}", mod)
        self.aggregator = aggregator

    def forward(self, x: torch.Tensor, table: GatherTable = None,
                etype: torch.Tensor = None) -> torch.Tensor:
        outs = [_apply(getattr(self, f"branches_{i}"), x, table, etype)
                for i in range(self.n_branches)]
        if self.aggregator is not None:
            return self.aggregator(*outs)
        res = outs[0]
        for o in outs[1:]:
            res = res + o
        return res


class MPEnsemble(nn.Module):
    """model3(concat(model1(x, table, etype), model2(x, *extra)))."""

    def __init__(self, model1: nn.Module, model2: nn.Module,
                 model3: nn.Module):
        super().__init__()
        self.model1, self.model2, self.model3 = model1, model2, model3

    def forward(self, x: torch.Tensor, table: GatherTable,
                etype: torch.Tensor, *extra) -> torch.Tensor:
        x1 = self.model1(x, table, etype)
        x2 = self.model2(x, *extra)
        return self.model3(torch.cat([x1, x2], dim=-1))


class GlobalPooling(nn.Module):
    """Concatenate onto the node features (mapped by ``orig_mapper``) their
    max over the nodes (mapped by ``gfeature_mapper``), broadcast to every
    node."""

    def __init__(self, orig_mapper: Optional[nn.Module] = None,
                 gfeature_mapper: Optional[nn.Module] = None):
        super().__init__()
        self.orig_mapper = orig_mapper
        self.gfeature_mapper = gfeature_mapper

    def forward(self, x: torch.Tensor, table: GatherTable = None,
                etype: torch.Tensor = None) -> torch.Tensor:
        n = x.shape[-2]
        g = x.amax(dim=-2, keepdim=True)
        if self.orig_mapper is not None:
            x = _apply(self.orig_mapper, x, table, etype)
        if self.gfeature_mapper is not None:
            g = self.gfeature_mapper(g)
        g = g.expand(*x.shape[:-2], n, g.shape[-1])
        return torch.cat([x, g], dim=-1)
