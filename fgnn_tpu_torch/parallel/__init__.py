"""Data and tensor parallelism over ``torch.distributed``, one process per
rank (counterpart of ``fgnn_tpu/parallel/``): the (data, model) mesh,
the sharding rules, the port's collectives, the edge-partitioned and halo
convs, and a launcher of ranks."""

from .mesh import (
    Mesh,
    init_distributed,
    local_mesh,
    make_mesh,
    parse_mesh_spec,
    process_group,
)
from .sharding import (
    batch_sharding,
    param_shard_dim,
    replicate,
    shard_batch,
    shard_params,
    shard_state,
)
from .edge_partition import pad_edges, partitioned_typed_mp_coo
from .halo import HaloGraph, HaloPlan, build_halo_plan, halo_typed_mp_coo
from .launch import run_ranks

__all__ = [
    "Mesh", "make_mesh", "local_mesh", "parse_mesh_spec", "init_distributed",
    "process_group", "shard_batch", "shard_params", "shard_state",
    "replicate", "batch_sharding", "param_shard_dim",
    "pad_edges", "partitioned_typed_mp_coo",
    "HaloGraph", "HaloPlan", "build_halo_plan", "halo_typed_mp_coo",
    "run_ranks",
]
