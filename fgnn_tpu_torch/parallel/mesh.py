"""The (data, model) mesh of a multi-process run (counterpart of
``fgnn_tpu/parallel/mesh.py``).

The JAX package is one process that drives every device of its mesh; the
port runs one process per rank over ``torch.distributed``:

* ``data``  — batch (DP): each rank takes its rows of every batch, runs
  the typed-mp kernels on them unchanged, and the BatchNorm statistics are
  all-reduced over this axis (``models/norm.py``: SyncBatchNorm, which jit
  over a mesh gives the JAX package for free);
* ``model`` — tensor axis (TP): the wide filter banks and Dense kernels are
  stored as shards over this axis and gathered for the (replicated)
  compute (``parallel/sharding.py``).

A ``Mesh`` is an object that the caller builds and passes: there is no
process-global registry of it.  Start the processes with ``torchrun``
(``init_distributed`` reads its environment), or ``launch.run_ranks``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    """The ranks of this run: those of the initialised process group, else
    torchrun's ``WORLD_SIZE`` (1 without it)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse a trainer ``--mesh`` flag value "DPxTP" (e.g. "8x1", "4x2").

    ``"auto"`` means pure DP over all ranks of the run."""
    if spec == "auto":
        return world_size(), 1
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec must be DPxTP (e.g. 8x1 or 4x2), got {spec!r}")
    dp, tp = int(parts[0]), int(parts[1])
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return dp, tp


def check_mesh(shape: Tuple[int, int]) -> None:
    """Raise ``ValueError`` unless dp * tp is the world size."""
    dp, tp = shape
    n = world_size()
    if dp * tp != n:
        raise ValueError(f"a {dp}x{tp} mesh needs {dp * tp} ranks; the "
                         f"world size is {n}")


class Mesh:
    """The run's ranks as a (data, model) grid, row-major: rank
    ``data_rank * tp + model_rank``, as the JAX package reshapes its
    devices.  ``data_group`` holds the ranks of this rank's model
    coordinate (they hold the same shards and see different rows),
    ``model_group`` those of its data coordinate (the same rows, other
    shards)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.dp, self.tp = device_mesh.shape
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.data_rank = device_mesh.get_local_rank("data")
        self.model_rank = device_mesh.get_local_rank("model")
        self.rank = dist.get_rank()

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.dp}, model={self.tp}, rank={self.rank}: "
                f"data {self.data_rank}, model {self.model_rank})")


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over every rank of the initialised process
    group; ``shape=None`` is (world size, 1), pure DP.  Raises
    ``ValueError`` when dp * tp is not the world size.  ``device_type``
    defaults to the current CUDA device's type where one is set up, else
    "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        shape = (world_size(), 1)
    check_mesh(shape)
    if device_type is None:
        device_type = "cuda" if (torch.cuda.is_available()
                                 and torch.cuda.is_initialized()) else "cpu"
    return Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=("data", "model")))


def local_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of every rank with a model axis of ``model_parallel``."""
    return make_mesh((world_size() // model_parallel, model_parallel))


def init_distributed(device, backend: Optional[str] = None,
                     init_method: str = "env://") -> torch.device:
    """Initialise the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and return this rank's
    device.

    The backend follows the device: NCCL on ``cuda:LOCAL_RANK``, gloo on
    the CPU.  A CUDA run that asks for more ranks than there are cards
    raises, unless the caller names gloo, which lets ranks share a card
    (rank ``LOCAL_RANK % cards``).  A world of one without torchrun's
    rendezvous address gets a store in this process."""
    dev = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if dev.type == "cuda":
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        if local >= cards and backend != "gloo":
            raise RuntimeError(
                f"local rank {local} needs a card of its own; this host has "
                f"{cards} (ranks share a card over gloo only, by name)")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        # a context before the device mesh, which would otherwise pick the
        # card from LOCAL_RANK itself
        torch.zeros((), device=dev)
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    if (init_method == "env://" and world == 1
            and "MASTER_ADDR" not in os.environ):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    return dev


@contextlib.contextmanager
def process_group(device):
    """The run's process group around a block, yielding this rank's
    device: an initialised group is used as it is (and ``device`` with
    it); else one is initialised from torchrun's environment
    (``init_distributed``) and destroyed when the block ends."""
    if dist.is_initialized():
        yield torch.device(device)
        return
    dev = init_distributed(device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
