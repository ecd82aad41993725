"""Shared training pieces (counterpart of ``fgnn_tpu/train/common.py``):
the per-epoch LR schedules, the optimizer, gradient clipping and the port's
checkpoints.

* Adam with the L2 weight decay folded into the gradient, as the reference
  (``torch.optim.Adam(weight_decay=...)``): the same update as the JAX
  package's ``optax.add_decayed_weights`` followed by ``adam`` (b1 0.9,
  b2 0.999, eps 1e-8).  The LDPC trainer decays by 1e-8, the synthetic
  trainers not at all.
* Clipping by global norm with optax's rule (``clip_grad_norm``).
* The LR is set once per epoch: ``base * Schedules.ldpc()(epoch)`` or
  ``base * Schedules.exp_decay(0.98)(epoch)``.
* A checkpoint is a ``torch.save`` of {format_version, model, optimizer,
  epoch, gcnt} (state dicts), written atomically, resumed with
  ``load_checkpoint``.  ``read_checkpoint`` and ``load_checkpoint`` also
  take the JAX package's pickle checkpoints (``jax_checkpoint.py``: its
  params, batch_stats and Adam state, in either optimizer layout); a
  params-only JAX file decodes but does not resume.
"""

from __future__ import annotations

import logging
import os
import pickle

import torch

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
    def ldpc(start: int = 10):
        """Linear warm-up to 1 over ``start`` epochs (floor 1e-2), then
        0.99 per epoch (floor 1e-6)."""
        def f(epoch):
            if epoch <= start:
                return max(1e-2, epoch / start)
            return max(0.99 ** (epoch - start), 1e-6)
        return f


def check_ported(args, unported: dict) -> None:
    """Raise for any flag of the JAX trainer that the port does not carry
    yet (``unported``: flag -> (its value when unused, the ROADMAP.md
    port-queue item it waits for)): none is silently ignored."""
    for flag, (unused, item) in unported.items():
        if getattr(args, flag, unused) != unused:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP.md, "
                f"port queue {item}")


def make_optimizer(params, base_lr: float, weight_decay: float = 1e-8):
    return torch.optim.Adam(params, lr=base_lr, weight_decay=weight_decay)


def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by max_norm / norm when
    their global L2 norm is ``max_norm`` or more, and return that norm.

    optax's ``clip_by_global_norm`` rule, which divides by the norm itself
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to it, and scales by a
    coefficient clamped to 1).  Stays on the device: no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


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
                    gcnt: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format_version": CKPT_FORMAT_VERSION,
               "model": model.state_dict(),
               "optimizer": optimizer.state_dict(),
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

