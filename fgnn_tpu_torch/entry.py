"""Entry points of the port: one forward of the flagship decoder, and a dry
run of its training step on several ranks (counterpart of
``__graft_entry__.py``, which stays the JAX package's).

    python -m fgnn_tpu_torch.entry [--device cpu]
    python -m fgnn_tpu_torch.entry dryrun N [--device cpu] [--backend gloo]

``entry()`` returns (fn, example_args): the reference ``LDPCModel`` with
seeded weights, in eval mode, and the six arrays the JAX entry passes to
its model, from the same seeded batch.  ``dryrun_multichip(n)`` runs one
train step of that model on an (n // mp) x mp mesh of n ranks (mp = 2
where n is even) and then the halo conv over a 1-D mesh of all n, and
prints the JAX entry's line.  Both run on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .data import ContinuousCodesSP
from .models import LDPCModel, MPConv, init_weights
from .ops import Extension, fused_mp
from .parallel import HaloGraph, build_halo_plan, make_mesh, run_ranks
from .train.common import make_optimizer, mean_metrics, \
    prepare_mesh_training
from .train.ldpc import BASE_LR, check_tables, train_step

# the JAX entry's order of the model's inputs
ARG_NAMES = ("node_feature", "hop_feature", "nn_idx_f2v", "nn_idx_v2f",
             "efeature_f2v", "efeature_v2f")
EXAMPLE_BATCH = 8
ROWS_PER_RANK = 8   # the JAX dryrun's rows per data shard
HALO_NODES_PER_RANK = 64
HALO_EDGES_PER_RANK = 512


def example_batch(batch_size: int, seed: int = 0) -> dict:
    """The first batch of ``ContinuousCodesSP(length=batch_size, seed)``,
    as the JAX entry draws it."""
    return next(ContinuousCodesSP(length=batch_size, seed=seed)
                .batches(batch_size))


def example_args(model: LDPCModel, batch: dict, device) -> tuple:
    """The six arrays of ``ARG_NAMES`` on ``device``: the batch's features
    and, in place of its per-sample tables, the model's shared (2-D,
    int32) code tables once the batch's are found equal to them, as the
    JAX trainer's ``_model_inputs`` passes them."""
    check_tables(model, batch)
    st = model.structure
    arrays = {**batch, "nn_idx_f2v": st.var_checks.astype(np.int32),
              "nn_idx_v2f": st.factors.astype(np.int32)}
    return tuple(torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
                 for k in ARG_NAMES)


class DecoderForward:
    """fn of ``entry``: fn(*example_args) -> (logits (B, 48), sigma_b
    (B, 1)) under ``no_grad``.  The tables must be the model's (checked on
    the host, as ``train.ldpc.check_tables`` checks a batch): the model
    holds them as its own gather tables."""

    def __init__(self, model: LDPCModel):
        self.model = model

    def __call__(self, node_feature, hop_feature, nn_idx_f2v, nn_idx_v2f,
                 efeature_f2v, efeature_v2f):
        check_tables(self.model, {"nn_idx_f2v": nn_idx_f2v.cpu().numpy(),
                                  "nn_idx_v2f": nn_idx_v2f.cpu().numpy()})
        with torch.no_grad():
            return self.model(node_feature, hop_feature, efeature_f2v,
                              efeature_v2f)


def entry(device=None):
    """(fn, example_args): the flagship decoder at the JAX ``LDPCModel()``
    defaults, weights from ``init_weights(model, 0)``, in eval mode on
    ``resolve_device(device)``, and a batch of 8 words on that device."""
    dev = resolve_device(device)
    model = init_weights(LDPCModel(), 0).to(dev).eval()
    return DecoderForward(model), example_args(
        model, example_batch(EXAMPLE_BATCH), dev)


def mesh_spec(n_devices: int) -> str:
    """The dry run's mesh: a model axis of 2 where ``n_devices`` is even."""
    mp = 2 if n_devices % 2 == 0 else 1
    return f"{n_devices // mp}x{mp}"


def halo_case(n_shards: int):
    """The dry run's halo graph and inputs, drawn as the JAX entry draws
    them: (src, dst, n_nodes, et_feat (E, 4), x (n_nodes, 8))."""
    rng = np.random.RandomState(0)
    n_nodes = HALO_NODES_PER_RANK * n_shards
    n_edges = HALO_EDGES_PER_RANK * n_shards
    src = rng.randint(0, n_nodes, n_edges)
    dst = np.clip(src + rng.randint(-8, 9, n_edges), 0, n_nodes - 1)
    et_feat = rng.randn(n_edges, 4).astype(np.float32)
    x = rng.randn(n_nodes, 8).astype(np.float32)
    return src, dst, n_nodes, et_feat, x


def halo_conv() -> MPConv:
    """The dry run's halo conv, seeded alike on every rank."""
    return init_weights(MPConv(8, 8, 4, aggregator="max",
                               extension=Extension.NO_EXTENSION,
                               use_bn=False), 0).eval()


def _halo_loss(dev, n_shards: int) -> float:
    """sum(out[:n_dst] ** 2) of the halo conv over a 1-D mesh of every
    rank, with its backward; each rank computes its destination rows."""
    src, dst, n_nodes, et_feat, x = halo_case(n_shards)
    mesh = make_mesh((n_shards, 1), dev.type)
    plan = build_halo_plan(src, dst, n_nodes, n_nodes, n_shards)
    graph = HaloGraph(plan, mesh).to(dev)
    conv = halo_conv().to(dev)
    xl = torch.tensor(graph.local_src(x), device=dev, requires_grad=True)
    et = torch.tensor(et_feat, device=dev, requires_grad=True)
    out = conv(xl, graph, et)
    valid = max(0, min(plan.dst_block,
                       plan.n_dst - mesh.data_rank * plan.dst_block))
    loss = (out[:valid] ** 2).sum()
    loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.data_group)
    grads = [xl.grad, et.grad] + [p.grad for p in conv.parameters()]
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise FloatingPointError("non-finite halo gradients")
    return float(total)


def _dryrun_rank(dev, n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``: the train step on the mesh (its
    typed-mp launches counted from 0), then the halo conv."""
    spec = mesh_spec(n_devices)
    batch_size = ROWS_PER_RANK * int(spec.split("x")[0])
    model = init_weights(LDPCModel(), 0).to(dev)
    optimizer = make_optimizer(model.parameters(), BASE_LR)
    mesh, rows = prepare_mesh_training(spec, model, optimizer, batch_size,
                                       dev)
    batch = rows(example_batch(batch_size))
    fused_mp.reset_counts()
    metrics = train_step(model, optimizer, batch, dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = {"fwd": dict(fused_mp.COUNTS),
              "bwd": dict(fused_mp.BWD_COUNTS)}
    metrics = mean_metrics([metrics], mesh)
    return {"rank": dist.get_rank(), "device": str(dev),
            "mesh": mesh.shape, "loss": metrics["loss"],
            "acc": metrics["acc"], "halo_loss": _halo_loss(dev, n_devices),
            "counts": counts}


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """One train step of the flagship ``LDPCModel`` (BCE + MSE, Adam with
    weight decay, BatchNorm statistics over the data axis) through
    ``prepare_mesh_training`` and ``train.ldpc.train_step`` on
    ``n_devices`` ranks, a mesh of ``mesh_spec(n_devices)`` and a batch of
    8 rows per data rank; then the halo conv over all ranks.  Prints the
    JAX entry's line and returns {mesh, loss, acc, halo_loss, ranks (each
    rank's record, with its launch counts)}.

    The ranks are spawned processes (``parallel.launch.run_ranks``): on
    the card NCCL with a card per rank, or gloo where ``backend`` names it
    (ranks then share cards); on ``device="cpu"`` gloo."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    ranks = run_ranks(_dryrun_rank, n_devices, backend, dev.type, n_devices)
    r0 = ranks[0]
    for key in ("loss", "acc", "halo_loss"):
        if not np.isfinite(r0[key]):
            raise FloatingPointError(f"non-finite {key} {r0[key]}")
    print(f"dryrun_multichip({n_devices}): mesh={r0['mesh']} "
          f"loss={r0['loss']:.4f} acc={r0['acc']:.4f} "
          f"halo_loss={r0['halo_loss']:.4f}", flush=True)
    return {"mesh": r0["mesh"], "loss": r0["loss"], "acc": r0["acc"],
            "halo_loss": r0["halo_loss"], "backend": backend,
            "ranks": ranks}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m fgnn_tpu_torch.entry")
    p.add_argument("mode", nargs="?", choices=("dryrun",))
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: cuda)")
    p.add_argument("--backend", default=None,
                   help="gloo to let the dry run's ranks share cards")
    args = p.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n_devices, args.device, args.backend)
        return
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok:", tuple(tuple(o.shape) for o in out))


if __name__ == "__main__":
    main()
