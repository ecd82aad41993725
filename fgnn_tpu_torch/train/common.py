"""Shared training pieces (counterpart of ``fgnn_tpu/train/common.py``):
the per-epoch LR schedules, the optimizer, gradient clipping and the port's
checkpoints.

* Adam with the L2 weight decay folded into the gradient, as the reference
  (``torch.optim.Adam(weight_decay=...)``): the same update as the JAX
  package's ``optax.add_decayed_weights`` followed by ``adam`` (b1 0.9,
  b2 0.999, eps 1e-8).  The LDPC trainer decays by 1e-8, the synthetic
  trainers not at all.
* Clipping by global norm with optax's rule (``clip_grad_norm``).
* The LR is set once per epoch: ``base * Schedules.ldpc()(epoch)``,
  ``base * Schedules.exp_decay(0.98)(epoch)`` or, for ECCT,
  ``base * Schedules.cosine(n_epochs, floor)(epoch)``.
* A checkpoint is a ``torch.save`` of {format_version, model, optimizer,
  epoch, gcnt} (state dicts), written atomically, resumed with
  ``load_checkpoint``.  ``read_checkpoint`` and ``load_checkpoint`` also
  take the JAX package's pickle checkpoints (``jax_checkpoint.py``: its
  params, batch_stats and Adam state, in either optimizer layout); a
  params-only JAX file decodes but does not resume.
* ``--mesh DPxTP`` (``prepare_mesh_training``, the counterpart of the JAX
  package's): one process per rank over ``torch.distributed``
  (``parallel/``).  Each rank trains on its rows of every batch, the
  BatchNorm statistics are global, the wide parameters are sharded over
  the model axis; after backward ``reduce_gradients`` takes the mean over
  the data axis, clipping counts each shard once, and checkpoints are
  written by rank 0 in the unmeshed format (the shards gathered), so a
  mesh run resumes unmeshed and the reverse.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import pickle

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..parallel import make_mesh, parse_mesh_spec, process_group, \
    replicate, shard_batch, shard_state
from ..parallel.mesh import check_mesh
from ..parallel.sharding import full_optimizer_state, full_state_dict, \
    set_data_group
from .jax_checkpoint import is_jax_checkpoint, read_jax_checkpoint, \
    restore_jax_payload

CKPT_FORMAT_VERSION = 1

log = logging.getLogger(__name__)


class Schedules:
    """Per-epoch LR multipliers (LambdaLR equivalents)."""

    @staticmethod
    def exp_decay(gamma: float = 0.98, floor: float = 1e-6):
        """gamma ** epoch, floor ``floor``."""
        return lambda epoch: max(gamma ** epoch, floor)

    @staticmethod
    def cosine(n_epochs: int, floor: float):
        """From 1 down to ``floor`` along half a cosine over ``n_epochs``
        (``torch.optim.lr_scheduler.CosineAnnealingLR`` with ``T_max``
        ``n_epochs`` and ``eta_min`` floor times the base)."""
        return lambda epoch: floor + (1.0 - floor) * 0.5 * (
            1.0 + math.cos(math.pi * min(epoch, n_epochs) / n_epochs))

    @staticmethod
    def ldpc(start: int = 10):
        """Linear warm-up to 1 over ``start`` epochs (floor 1e-2), then
        0.99 per epoch (floor 1e-6)."""
        def f(epoch):
            if epoch <= start:
                return max(1e-2, epoch / start)
            return max(0.99 ** (epoch - start), 1e-6)
        return f


def make_optimizer(params, base_lr: float, weight_decay: float = 1e-8):
    return torch.optim.Adam(params, lr=base_lr, weight_decay=weight_decay)


def clip_grad_norm(params, max_norm: float, mesh=None,
                   shards=()) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by max_norm / norm when
    their global L2 norm is ``max_norm`` or more, and return that norm.

    optax's ``clip_by_global_norm`` rule, which divides by the norm itself
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to it, and scales by a
    coefficient clamped to 1).  Stays on the device: no host sync.  Under
    a model axis (``mesh.tp`` > 1) each shard counts once: the squares of
    the gradients of ``shards`` (the sharded parameters, ``parallel.
    sharding.shard_originals``) are summed over the model axis, the
    replicated ones' taken as they are, so the norm is the unmeshed one."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is not None and mesh.tp > 1:
        norm = _sharded_norm(params, mesh, {id(p) for p in shards})
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _sharded_norm(params, mesh, shard_ids):
    """The global L2 norm of the gradients with each shard counted once."""
    sq = []
    for sharded in (True, False):
        gs = [p.grad for p in params
              if p.grad is not None and (id(p) in shard_ids) == sharded]
        sq.append(torch.stack(torch._foreach_norm(gs)).square().sum() if gs
                  else torch.zeros((), device=params[0].device))
    dist.all_reduce(sq[0], group=mesh.model_group)
    return torch.sqrt(sq[0] + sq[1])


def mesh_group(args, device):
    """The process group of ``args.mesh`` around a block, yielding this
    rank's device (``parallel.process_group``; without ``--mesh``,
    ``device``).  Raises ``ValueError`` first, before anything is written,
    when the spec is not the world size."""
    if not getattr(args, "mesh", ""):
        return contextlib.nullcontext(device)
    check_mesh(parse_mesh_spec(args.mesh))
    return process_group(device)


def prepare_mesh_training(mesh_spec: str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer,
                          batch_size: int, device=None):
    """Set up sharded training for a trainer's ``--mesh DPxTP`` flag, in
    the initialised process group (``parallel.process_group``).

    Builds the (data, model) mesh (``ValueError`` unless dp * tp is the
    world size, or unless the data axis divides ``batch_size``), gives
    every rank rank 0's parameters and buffers, shards the wide
    parameters and their optimizer state over the model axis, and takes
    every BatchNorm's statistics over the data axis.  Returns (mesh, put):
    ``put`` gives a (host) batch's rows of this rank.  ``unshard`` undoes
    it once training ends."""
    dp, tp = parse_mesh_spec(mesh_spec)
    if batch_size % dp:
        raise ValueError(
            f"batch size {batch_size} must divide the data axis ({dp}) "
            f"of mesh {mesh_spec!r}")
    mesh = make_mesh((dp, tp), None if device is None
                     else torch.device(device).type)
    replicate(model.state_dict().values())
    shard_state(model, optimizer, mesh)
    set_data_group(model, mesh.data_group)

    def put(batch):
        return shard_batch(batch, mesh, batch_size)

    return mesh, put


def reduce_gradients(params, mesh) -> None:
    """The mean over the data axis of every gradient of ``params``, in
    place, in one all-reduce (after backward, before clipping)."""
    if mesh is None or mesh.dp == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.dp
    torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))


def mean_metrics(pending: list, mesh) -> dict:
    """The mean of each metric over ``pending`` steps (dicts of device
    scalars) and, under a mesh, over the data axis: one host sync."""
    keys = list(pending[0])
    m = torch.stack([torch.stack([p[k] for p in pending]).double().mean()
                     for k in keys])
    if mesh is not None and mesh.dp > 1:
        dist.all_reduce(m, group=mesh.data_group)
        m = m / mesh.dp
    return dict(zip(keys, m.tolist()))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def is_train_checkpoint(payload) -> bool:
    return isinstance(payload, dict) and "format_version" in payload


def read_checkpoint(path: str):
    """The checkpoint at ``path``: a ``torch.save`` zip (tensors and plain
    values only) holding a port trainer checkpoint of this format version
    or a bare state dict, or else a JAX pickle checkpoint
    (``jax_checkpoint.read_jax_checkpoint``: a dict with ``params``).
    Raises ``ValueError`` for anything else."""
    with open(path, "rb") as f:
        zipped = f.read(2) == b"PK"
    if not zipped:
        return read_jax_checkpoint(path)
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        raise ValueError(f"{path} is not a port checkpoint (a torch.save "
                         "of a state dict)") from e
    if is_train_checkpoint(payload) \
            and payload["format_version"] != CKPT_FORMAT_VERSION:
        raise ValueError(f"{path} has format version "
                         f"{payload['format_version']}; this build reads "
                         f"{CKPT_FORMAT_VERSION}")
    return payload


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int,
                    gcnt: int, mesh=None) -> None:
    """Write the checkpoint; under a mesh every rank gathers the shards
    (a collective) and rank 0 writes the unmeshed format."""
    if mesh is not None:
        model_sd = full_state_dict(model)
        opt_sd = full_optimizer_state(model, optimizer)
        if mesh.rank != 0:
            return
    else:
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format_version": CKPT_FORMAT_VERSION,
               "model": model_sd, "optimizer": opt_sd,
               "epoch": int(epoch), "gcnt": int(gcnt)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    log.info("saved checkpoint to %s (epoch %d)", path, epoch)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer):
    """Restore model and optimizer in place from a port trainer checkpoint
    or a JAX trainer's; returns (epoch, gcnt)."""
    payload = read_checkpoint(path)
    if is_jax_checkpoint(payload):
        epoch, gcnt = restore_jax_payload(payload, model, optimizer)
    elif is_train_checkpoint(payload):
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        epoch, gcnt = payload["epoch"], payload["gcnt"]
    else:
        raise ValueError(f"{path} holds no optimizer state: resume needs a "
                         "checkpoint written by a trainer")
    log.info("restored checkpoint from %s (epoch %d)", path, epoch)
    return epoch, gcnt

