"""Carry a reference PyTorch ``state_dict`` into the port's modules (the
port's own copy of ``fgnn_tpu/models/torch_import.py``).

Users of the reference implementation (the upstream PyTorch repository)
can move trained models over.  The importers map the tensors of a
reference ``state_dict`` (numpy arrays or CPU tensors; a trained file's
``torch.load(...)['model_state_dict']``) onto the flax-layout
``(params, batch_stats)`` tree that the JAX package's importers return,
converting layouts:

  * Conv2d 1x1 ``(out, in, 1, 1)``  -> Dense kernel ``(in, out)``
  * Linear ``(out, in)``            -> Dense kernel ``(in, out)``
  * mp_conv_v2 ``filters``          -> identical (C_in, C_out*T) layout
  * BatchNorm2d/1d weight/bias/running_mean/running_var ->
    scale/bias + batch_stats mean/var

and ``load_reference_state_dict`` puts that tree into a port module
through ``load_flax_variables`` (strict).  Covered: the reference
``FactorNN`` (factor_mpnn_sp.py:25-113) under any prefix, ``factor_mpnn``
layers, the emodel MLPs, and the full ``LDPCModel`` of
train_ldpc.py:19-65 (8 layers).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .factor_nn import FactorNN
from .from_jax import load_flax_variables
from .ldpc_model import LDPCModel

Array = np.ndarray
StateDict = Mapping[str, Array]


def _conv(sd: StateDict, prefix: str) -> Dict[str, Array]:
    p = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"][:, :, 0, 0].T)}
    if f"{prefix}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _linear(sd: StateDict, prefix: str) -> Dict[str, Array]:
    p = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _bn(sd: StateDict, prefix: str):
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def _mp_conv(sd: StateDict, prefix: str):
    params = {"filters": np.asarray(sd[f"{prefix}.filters"])}
    stats = {}
    if f"{prefix}.bias" in sd:
        params["bias"] = np.asarray(sd[f"{prefix}.bias"])
    if f"{prefix}.bn.weight" in sd:
        params["bn"], stats["bn"] = _bn(sd, f"{prefix}.bn")
    return params, stats


def _mp_conv_residual(sd: StateDict, prefix: str):
    mp_p, mp_s = _mp_conv(sd, f"{prefix}.mp_conv")
    bn1_p, bn1_s = _bn(sd, f"{prefix}.conv1.1")
    bn2_p, bn2_s = _bn(sd, f"{prefix}.conv2.1")
    params = {"conv1": _conv(sd, f"{prefix}.conv1.0"), "bn1": bn1_p,
              "mp_conv": mp_p, "conv2": _conv(sd, f"{prefix}.conv2.0"),
              "bn2": bn2_p}
    stats = {"bn1": bn1_s, "mp_conv": mp_s, "bn2": bn2_s}
    return params, stats


def _mp_module(sd: StateDict, prefix: str):
    """Dispatch mp_conv_v2 vs mp_conv_residual vs pointwise by key shape."""
    if f"{prefix}.filters" in sd:
        return _mp_conv(sd, prefix)
    if f"{prefix}.mp_conv.filters" in sd:
        return _mp_conv_residual(sd, prefix)
    # pointwise fallback (Sequential Conv/IN/ReLU)
    return {"conv": _conv(sd, f"{prefix}.0")}, {}


def import_factor_nn(sd: StateDict, prefix: str = "",
                     n_factor_types: int = 2, n_layers: int = 8):
    """Reference FactorNN state_dict -> (params, batch_stats) in the flax
    layout of ``FactorNN``."""
    pre = f"{prefix}." if prefix else ""
    params: Dict = {}
    stats: Dict = {}

    def put(name, pair):
        p, s = pair
        params[name] = p
        if s:
            stats[name] = s

    put("node_mapping",
        ({"conv": _conv(sd, f"{pre}node_mapping_module.main.0")}, {}))
    for j in range(n_factor_types):
        bn_p, bn_s = _bn(sd, f"{pre}factor_mapping_modules_{j}.main.1")
        put(f"factor_mapping_{j}",
            ({"conv": _conv(sd, f"{pre}factor_mapping_modules_{j}.main.0"),
              "bn": bn_p}, {"bn": bn_s}))
    for i in range(n_layers):
        put(f"v2v_{i}", ({"conv": _conv(sd, f"{pre}v2v_{i}.main.0")}, {}))
        for j in range(n_factor_types):
            put(f"f2f_{i}_{j}",
                ({"conv": _conv(sd, f"{pre}f2f_{i}_{j}.main.0")}, {}))
            put(f"f2v_{i}_{j}", _mp_module(sd, f"{pre}f2v_{i}_{j}"))
            put(f"v2f_{i}_{j}", _mp_module(sd, f"{pre}v2f_{i}_{j}"))
    params["final_conv1"] = _conv(sd, f"{pre}final_classifier.0")
    params["final_conv2"] = _conv(sd, f"{pre}final_classifier.3")
    return params, stats


def import_mlp(sd: StateDict, prefix: str, layer_ids=(0, 2)):
    """Sequential Conv/ReLU/Conv emodel -> the flax layout of ``MLP``."""
    return {f"dense_{i}": _conv(sd, f"{prefix}.{lid}")
            for i, lid in enumerate(layer_ids)}


def import_ldpc_model(sd: StateDict):
    """Full reference LDPCModel (train_ldpc.py:19-65) state_dict ->
    (params, batch_stats) in the flax layout of ``LDPCModel``."""
    main_p, main_s = import_factor_nn(sd, "main")
    bn_p, bn_s = _bn(sd, "nhop_regressor.1")
    params = {
        "main": main_p,
        "emodel_f2v": import_mlp(sd, "emodel_f2v"),
        "emodel_v2f": import_mlp(sd, "emodel_v2f"),
        "nhop_regressor": {
            "fc1": _linear(sd, "nhop_regressor.0"),
            "bn": bn_p,
            "fc2": _linear(sd, "nhop_regressor.3"),
            "fc3": _linear(sd, "nhop_regressor.5"),
        },
    }
    stats = {"main": main_s, "nhop_regressor": {"bn": bn_s}}
    return params, stats


def load_reference_state_dict(model: nn.Module, sd: StateDict) -> nn.Module:
    """Fill a port ``LDPCModel`` (8 layers, as the reference's) or
    ``FactorNN`` in place from a reference ``state_dict``: the importers'
    tree through ``load_flax_variables``."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in sd.items()}
    if isinstance(model, LDPCModel):
        params, stats = import_ldpc_model(sd)
    elif isinstance(model, FactorNN):
        params, stats = import_factor_nn(sd, n_factor_types=model.ntypes,
                                         n_layers=model.n_layers)
    else:
        raise TypeError(f"no reference importer for {type(model).__name__}")
    return load_flax_variables(model, {"params": params,
                                       "batch_stats": stats})
