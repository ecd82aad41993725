"""Sharding rules for the port's models, optimizers and batches
(counterpart of ``fgnn_tpu/parallel/sharding.py``).

Data-parallel: every array of a batch whose leading dim is the batch size
gives each rank its rows (``shard_batch``); anything else (shared graph
tables, a flat ``--coo`` union) is replicated.

Tensor-parallel: a parameter whose last dim, in the JAX package's layout,
is at least 128 * tp and divisible by tp is stored as a shard of that dim
on each rank of the ``model`` axis (``param_shard_dim``): the filter banks
(C_in, C_out * T), whose contiguous slices are whole output channels
(columns c * T + t), and the wide Dense kernels, which the port keeps as
(out, in), the transpose of flax's (in, out), so they shard dim 0.  1-D
parameters and the BatchNorm statistics are replicated.  A sharded
parameter is a ``torch.nn.utils.parametrize`` of its module: the module's
attribute gathers the shards (``comm.gather_shards``) at each use, so the
compute and the kernels see the whole, plain tensor, and the gradient of
the shard is its slice of the replicated gradient.  Adam keeps the state
of what the rank holds.  ``full_state_dict`` and ``full_optimizer_state``
gather it back into the unmeshed format (the port's checkpoints), and
``unshard`` turns a model back into an unmeshed one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.nn.utils import parametrize

from .comm import gather_shards, group_size


def param_shard_dim(shape, transposed: bool, tp: int) -> Optional[int]:
    """The dim of a parameter of ``shape`` that the model axis shards, or
    None: the JAX package's ``_param_spec`` rule on the JAX layout, whose
    last dim is the port's dim 0 where the port stores the transpose
    (``transposed``, a Dense weight)."""
    if tp == 1 or len(shape) < 2:
        return None
    last = shape[0] if transposed else shape[-1]
    if last % tp or last < 128 * tp:
        return None
    return 0 if transposed else len(shape) - 1


def _transposed(module: nn.Module, name: str) -> bool:
    # the port's only nn.Linear is models.norm.Dense
    return isinstance(module, nn.Linear) and name == "weight"


def batch_sharding(mesh, batch_size: int) -> slice:
    """This rank's rows of a batch: its data coordinate's block.  Raises
    ``ValueError`` unless the data axis divides the batch."""
    if batch_size % mesh.dp:
        raise ValueError(
            f"batch size {batch_size} must divide the data axis "
            f"({mesh.dp}) of the mesh")
    n = batch_size // mesh.dp
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def shard_batch(batch: dict, mesh, batch_size: int) -> dict:
    """This rank's rows (``batch_sharding``) of every array of ``batch``
    whose leading dim is ``batch_size``; every other value as it is."""
    mine = batch_sharding(mesh, batch_size)

    def rows(v):
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == batch_size:
            return v[mine]
        return v

    return {k: rows(v) for k, v in batch.items()}


def replicate(tensors) -> None:
    """Give every rank global rank 0's values of ``tensors``, in place: one
    broadcast per dtype and device."""
    if dist.get_world_size() == 1:
        return
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t.data)
    with torch.no_grad():
        for ts in groups.values():
            flat = _flatten_dense_tensors(ts)
            dist.broadcast(flat, src=0)
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


class Shards(nn.Module):
    """The parametrization of a sharded parameter: this rank's shard
    (``right_inverse``) and the whole tensor from the model axis' shards
    (``forward``)."""

    def __init__(self, dim: int, mesh):
        super().__init__()
        self.dim, self.group = dim, mesh.model_group
        self.n, self.index = mesh.tp, mesh.model_rank

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return gather_shards(shard, self.dim, self.group)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.shard(full)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.n, self.dim)[self.index].clone()

    def extra_repr(self) -> str:
        return f"dim={self.dim}, shards={self.n}, index={self.index}"


def sharded(model: nn.Module):
    """(module, name, Shards) of every sharded parameter of ``model``."""
    for module in model.modules():
        if parametrize.is_parametrized(module):
            for name, plist in module.parametrizations.items():
                yield module, name, plist[0]


def shard_originals(model: nn.Module) -> list:
    """The parameters of ``model`` that hold shards."""
    return [module.parametrizations[name].original
            for module, name, _ in sharded(model)]


def shard_params(model: nn.Module, mesh) -> int:
    """``shard_state`` of a model without an optimizer."""
    return shard_state(model, None, mesh)


def shard_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
                mesh) -> int:
    """Shard ``model``'s wide parameters over the model axis in place, and
    the optimizer state of each with it (the parameter objects stay the
    optimizer's).  Returns the number of sharded parameters."""
    if mesh.tp == 1:
        return 0
    count = 0
    for module in list(model.modules()):
        for name, p in list(module.named_parameters(recurse=False)):
            dim = param_shard_dim(tuple(p.shape), _transposed(module, name),
                                  mesh.tp)
            if dim is None:
                continue
            full_shape = p.shape
            shards = Shards(dim, mesh)
            parametrize.register_parametrization(module, name, shards,
                                                 unsafe=True)
            state = {} if optimizer is None else optimizer.state.get(p, {})
            for k, v in state.items():
                if torch.is_tensor(v) and v.shape == full_shape:
                    state[k] = shards.shard(v)
            count += 1
    return count


def _shard_keys(model: nn.Module) -> dict:
    """The state-dict key of each shard -> (the unmeshed key, Shards)."""
    keys = {}
    for name, module in model.named_modules():
        if parametrize.is_parametrized(module):
            pre = f"{name}." if name else ""
            for pname, plist in module.parametrizations.items():
                keys[f"{pre}parametrizations.{pname}.original"] = (
                    f"{pre}{pname}", plist[0])
    return keys


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` in the unmeshed format: each sharded
    parameter gathered under its own name.  A collective: every rank of
    the mesh calls it."""
    keys = _shard_keys(model)
    out = {}
    for k, v in model.state_dict().items():
        if k in keys:
            full, shards = keys[k]
            out[full] = shards(v)
        else:
            out[k] = v
    return out


def full_grads(model: nn.Module) -> dict:
    """The gradient of every parameter, by its unmeshed name (None where
    it has none), each sharded one gathered.  A collective, as
    ``full_state_dict``."""
    keys = _shard_keys(model)
    out = {}
    for k, p in model.named_parameters():
        if k in keys:
            full, shards = keys[k]
            out[full] = None if p.grad is None else shards(p.grad)
        else:
            out[k] = p.grad
    return out


def full_optimizer_state(model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the state of each sharded parameter
    gathered.  A collective, as ``full_state_dict``."""
    by_param = {id(module.parametrizations[name].original): shards
                for module, name, shards in sharded(model)}
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        shards, state = by_param.get(id(p)), sd["state"].get(i)
        if shards is None or state is None:
            continue
        sd["state"][i] = {k: shards(v) if torch.is_tensor(v)
                          and v.shape == p.shape else v
                          for k, v in state.items()}
    return sd


def unshard(model: nn.Module) -> nn.Module:
    """Turn a model of ``shard_state`` back into an unmeshed one: each
    sharded parameter gathered into a plain parameter, every BatchNorm's
    data group dropped.  A collective, as ``full_state_dict``."""
    for module, name, _ in list(sharded(model)):
        parametrize.remove_parametrizations(module, name,
                                            leave_parametrized=True)
    set_data_group(model, None)
    return model


def set_data_group(model: nn.Module, group) -> None:
    """Take every BatchNorm's statistics over ``group`` (None: this
    rank's rows alone).  A group of one rank is None."""
    if group_size(group) == 1:
        group = None
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = group
