"""MPConv: the module around the typed-edge conv (counterpart of
``fgnn_tpu/models/mp_conv.py``, its dense-table, COO and halo branches).

Given a ``GatherTable`` the conv runs ``typed_mp_conv`` on (B, N, C)
features; given an ``ops.segment.CooGraph`` (a flat disjoint union) it runs
``typed_mp_conv_coo`` on (N_flat, C) features and (E, T) edge weights,
with the extension mapped as the JAX package's ``_COO_EXT``; given a
``parallel.halo.HaloGraph`` (one large graph whose sources and
destinations are row-sharded over a mesh's data axis) it runs
``halo_typed_mp_coo`` on this rank's (Ns, C) source rows and the whole
(E, T) edge weights in the original edge order, returns this rank's
(Nd, nout) rows, and takes the BatchNorm statistics over every rank's
rows.  The halo branch implements NO_EXTENSION only, as the JAX one.
On every branch the message passing (``x @ W``, gather-mix-aggregate,
bias) runs inside a ``conv`` span (``utils.profiling.annotate``), the
BatchNorm after it outside, with the ReLU in its ``norm`` span.

The JAX modules default to ``ORIG_WITH_DIFF``; the port's default is
``NO_EXTENSION``, the LDPC models' mode, and the synthetic models
(``factor_mpnn.py``, ``synthetic.py``) name their extension.
``GConvResidual`` is the bottleneck block with ReLU nonlinearities and a
softmax DIFF conv."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.segment import CooGraph, typed_mp_conv_coo
from ..ops.typed_mp import Extension, typed_mp_conv
from ..parallel.halo import HaloGraph, halo_typed_mp_coo
from ..utils.profiling import annotate
from .norm import BatchNorm, Dense, uniform_

_COO_EXT = {Extension.NO_EXTENSION: "none",
            Extension.ORIG_WITH_DIFF: "diff",
            Extension.ORIG_WITH_NEIGHBOR: "neighbor"}


class MPConv(nn.Module):
    """gather -> filter bank -> etype mix -> aggregate -> bias -> BatchNorm
    -> ReLU.  ``filters`` (nin, nout * T), or (2 nin, nout * T) for the
    extensions, keeps the JAX column layout c * T + t.

    ``use_bias``, ``use_bn``, ``activation`` ("relu" or None) and ``gamma``
    (the softmax aggregator's temperature) have the JAX module's meaning
    and defaults on every branch: with ``use_bias=False`` there is no
    ``bias`` and with ``use_bn=False`` no ``bn`` child, so that a flax tree
    without them loads strictly."""

    def __init__(self, nin: int, nout: int, nedge_types: int, *,
                 extension: Extension = Extension.NO_EXTENSION,
                 aggregator: str = "softmax", use_bias: bool = True,
                 use_bn: bool = True, activation: Optional[str] = "relu",
                 gamma: float = 3.0):
        super().__init__()
        if activation not in ("relu", None):
            raise ValueError(f"activation is 'relu' or None; got "
                             f"{activation!r}")
        self.nout = nout
        self.extension = extension
        self.aggregator = aggregator
        self.activation = activation
        self.gamma = gamma
        cin = nin if extension == Extension.NO_EXTENSION else 2 * nin
        self.filters = nn.Parameter(torch.empty(cin, nout * nedge_types))
        self.bias = nn.Parameter(torch.empty(nout)) if use_bias else None
        self.bn = BatchNorm(nout) if use_bn else None

    def init_(self, generator: torch.Generator) -> None:
        uniform_(self.filters, -0.01, 0.01, generator)
        if self.bias is not None:
            uniform_(self.bias, 0.0, 0.05, generator)

    def forward(self, x: torch.Tensor, table, etype: torch.Tensor
                ) -> torch.Tensor:
        group = None
        if isinstance(table, HaloGraph):
            if self.extension != Extension.NO_EXTENSION:
                raise NotImplementedError(
                    "halo mode implements NO_EXTENSION message passing")
            with annotate("conv"):
                et_loc, et_rem = table.shard_etype(etype)
                y = halo_typed_mp_coo(x, et_loc, et_rem, self.filters,
                                      self.nout, table,
                                      aggregator=self.aggregator,
                                      gamma=self.gamma, bias=self.bias)
            mesh = table.mesh
            group = mesh.data_group if mesh.dp > 1 else None
        elif isinstance(table, CooGraph):
            with annotate("conv"):
                y = typed_mp_conv_coo(x, table, etype, self.filters,
                                      self.nout, aggregator=self.aggregator,
                                      gamma=self.gamma, bias=self.bias,
                                      extension=_COO_EXT[self.extension])
        else:
            with annotate("conv"):
                y = typed_mp_conv(x, table, etype, self.filters, self.nout,
                                  extension=self.extension,
                                  aggregator=self.aggregator,
                                  gamma=self.gamma, bias=self.bias)
        if self.bn is not None:
            return self.bn(y, group=group, activation=self.activation)
        return torch.relu(y) if self.activation == "relu" else y


class MPConvResidual(nn.Module):
    """Bottleneck block: Dense(nin->nmed)+BN+LeakyReLU -> MPConv(nmed->nmed)
    -> Dense(nmed->nout)+BN+LeakyReLU [+ x when ``with_residual``]."""

    def __init__(self, nin: int, nmed: int, nedge_types: int, *,
                 extension: Extension = Extension.NO_EXTENSION,
                 with_residual: bool = True, aggregator: str = "max",
                 nout: Optional[int] = None):
        super().__init__()
        nout = nin if nout is None else nout
        self.with_residual = with_residual
        self.conv1 = Dense(nin, nmed)
        self.bn1 = BatchNorm(nmed)
        self.mp_conv = MPConv(nmed, nmed, nedge_types, extension=extension,
                              aggregator=aggregator)
        self.conv2 = Dense(nmed, nout)
        self.bn2 = BatchNorm(nout)

    def forward(self, x: torch.Tensor, table, etype: torch.Tensor
                ) -> torch.Tensor:
        """``table``: a ``GatherTable`` or a ``CooGraph``, passed through."""
        h = self.bn1(self.conv1(x), activation="leaky_relu")
        h = self.mp_conv(h, table, etype)
        h = self.bn2(self.conv2(h), activation="leaky_relu")
        if self.with_residual:
            h = h + x
        return h


class GConvResidual(nn.Module):
    """The reference's gconv_residual: Dense(nin->nmed)+BN+ReLU ->
    MPConv(nmed->nmed) -> Dense(nmed->nin)+BN+ReLU [+ x when
    ``with_residual``].  Its MPConv takes the JAX module's defaults,
    softmax and ``ORIG_WITH_DIFF``, named here since the port's MPConv
    defaults to ``NO_EXTENSION``.  The JAX containers give it x alone, as
    they do not list it among the message-passing modules; so do the
    port's (``containers._is_mp``)."""

    def __init__(self, nin: int, nmed: int, nedge_types: int, *,
                 with_residual: bool = True):
        super().__init__()
        self.with_residual = with_residual
        self.conv1 = Dense(nin, nmed)
        self.bn1 = BatchNorm(nmed)
        self.mp_conv = MPConv(nmed, nmed, nedge_types,
                              extension=Extension.ORIG_WITH_DIFF,
                              aggregator="softmax")
        self.conv2 = Dense(nmed, nin)
        self.bn2 = BatchNorm(nin)

    def forward(self, x: torch.Tensor, table, etype: torch.Tensor
                ) -> torch.Tensor:
        h = self.bn1(self.conv1(x), activation="relu")
        h = self.mp_conv(h, table, etype)
        h = self.bn2(self.conv2(h), activation="relu")
        if self.with_residual:
            h = h + x
        return h
