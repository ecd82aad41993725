"""Rank workers of the port's multi-process tests (``test_torch_mesh.py``,
``test_torch_halo.py``, ``test_torch_edge_partition.py``).

``parallel.launch.run_ranks`` spawns the ranks, and spawn imports the
worker's module anew in every child: so this module imports torch, numpy
and the port only, never JAX (the test files compute the JAX references
in the parent and pass numpy arrays in).  Each worker runs all of its
file's checks in one spawn and returns numpy results; the tests assert.
"""

import contextlib
import os
from argparse import Namespace

import torch
import torch.distributed as dist

from fgnn_tpu_torch.models import LDPCModel, MPConv, load_flax_variables
from fgnn_tpu_torch.models.norm import BatchNorm
from fgnn_tpu_torch.ops import Extension, fused_mp
from fgnn_tpu_torch.parallel import (
    HaloGraph,
    halo_typed_mp_coo,
    make_mesh,
    partitioned_typed_mp_coo,
)
from fgnn_tpu_torch.parallel.sharding import full_grads, full_state_dict, \
    shard_originals, sharded
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train import synthetic as t_syn
from fgnn_tpu_torch.utils.logging import MetricsWriter


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def _np_dict(d):
    return {k: _np(v) for k, v in d.items()}


def subworld(tmp, size):
    """Split the world into worlds of ``size`` consecutive ranks (each its
    own process group, met through a file in ``tmp``); returns this
    rank's index of its world."""
    rank = dist.get_rank()
    dist.destroy_process_group()
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(
            tmp, f"world{rank // size}of{size}"),
        rank=rank % size, world_size=size)
    return rank // size


# --------------------------------------------------------------------------
# test_torch_mesh.py


def ldpc_steps(dev, spec, dims, variables, batches, lr, clean_weight=0.0):
    """Train steps of an LDPCModel of ``dims`` (skip_link {}) from flax
    ``variables`` on ``batches`` under ``spec``: per step the global
    metrics, after the first its gradients and state, unmeshed."""
    model = load_flax_variables(LDPCModel(dim_mapping_list=dims,
                                          skip_link={}), variables)
    opt = t_common.make_optimizer(model.parameters(), lr)
    bsz = batches[0]["label"].shape[0]
    mesh, rows = t_common.prepare_mesh_training(spec, model, opt, bsz, dev)
    names = {m: n for n, m in model.named_modules()}
    out = {"metrics": [], "shards": sorted(
        f"{names[m]}.{n}" for m, n, _ in sharded(model))}
    fused_mp.reset_counts()
    for i, b in enumerate(batches):
        m = t_ldpc.train_step(model, opt, t_ldpc.stage_batch(
            model, rows(b), dev), dev, clean_weight, mesh=mesh)
        out["metrics"].append(t_common.mean_metrics([m], mesh))
        if i == 0:
            out["grads"] = _np_dict(full_grads(model))
            out["state"] = _np_dict(full_state_dict(model))
    out["counts"] = (dict(fused_mp.COUNTS), dict(fused_mp.BWD_COUNTS))
    return out


def syncbn(dev, x, g):
    """BatchNorm over this rank's rows of x with the data group: output
    rows, running statistics, the input gradient of sum(out * g)."""
    mesh = make_mesh((dist.get_world_size(), 1))
    rows = slice(mesh.data_rank * (x.shape[0] // mesh.dp),
                 (mesh.data_rank + 1) * (x.shape[0] // mesh.dp))
    bn = BatchNorm(x.shape[-1])
    bn.data_group = mesh.data_group
    xl = torch.tensor(x[rows], requires_grad=True)
    y = bn(xl)
    (y * torch.from_numpy(g[rows])).sum().backward()
    return {"out": _np(y), "grad": _np(xl.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


def hop_train(dev, tmp):
    """The hop trainer's ``train_and_eval`` under --mesh 2x1, 2 steps
    (test_synthetic_trainer_mesh_flag's arguments)."""
    args = Namespace(
        chain_length=10, hop_cap=3, hop_order=5, neighbour=4,
        model_name="mp_nn_factor", dims=None, seed=0, train_epoches=1,
        model_path="", train_size=16, test_size=8, batch_size=8,
        work_dir=os.path.join(tmp, "hop"), workers=0, train_path="",
        test_path="", bf16=False, mesh="2x1")
    acc, lp_acc = t_syn.train_and_eval("hop", args, device=dev)
    return {"acc": acc, "lp_acc": lp_acc}


def ldpc_resume(dev, tmp, dims, ckpt, seed):
    """``train.ldpc.train`` under --mesh 1x2 from the unmeshed checkpoint
    ``ckpt`` (one epoch in it) for a second epoch of 2 steps; rank 0 writes
    the final checkpoint."""
    args = Namespace(samples_per_epoch=16, snr=None, seed=seed,
                     batch_size=8, n_epochs=2, steps_per_epoch=2,
                     model_path=ckpt, clean_weight=0.0, mesh="1x2")
    work = os.path.join(tmp, "resume")
    model = LDPCModel(dim_mapping_list=dims, skip_link={})
    with (MetricsWriter(os.path.join(work, "tf_logs"))
          if dist.get_rank() == 0 else contextlib.nullcontext()) as writer:
        model = t_ldpc.train(args, model, writer, work, device=dev)
    return {"state": _np_dict(model.state_dict()),
            "files": sorted(os.listdir(work)) if dist.get_rank() == 0
            else None}


def clip_norm(dev, dims, variables, batch, lr):
    """The global gradient norm of one step under --mesh 1x2 (the sharded
    filter banks counted once), as clip_grad_norm takes it."""
    model = load_flax_variables(LDPCModel(dim_mapping_list=dims,
                                          skip_link={}), variables)
    opt = t_common.make_optimizer(model.parameters(), lr)
    mesh, rows = t_common.prepare_mesh_training(
        "1x2", model, opt, batch["label"].shape[0], dev)
    t_ldpc.train_step(model, opt, rows(batch), dev, mesh=mesh)
    norm = t_common.clip_grad_norm(model.parameters(), 1e30, mesh,
                                   shard_originals(model))
    return float(norm)


def divisibility(dev, dims):
    model = LDPCModel(dim_mapping_list=dims, skip_link={})
    opt = t_common.make_optimizer(model.parameters(), 1e-2)
    try:
        t_common.prepare_mesh_training("2x1", model, opt, 7, dev)
    except ValueError as e:
        return str(e)
    return None


def mesh_worker(dev, tmp, case):
    """test_torch_mesh.py's ranks: 2x2 on the world of 4, then two worlds
    of 2, the first for 2x1 and its checks, the second for 1x2 and the
    resume."""
    dims, variables, batches, lr = (case["dims"], case["variables"],
                                    case["batches"], case["lr"])
    out = {"2x2": ldpc_steps(dev, "2x2", dims, variables, batches, lr)}
    if subworld(tmp, 2) == 0:
        out["2x1"] = ldpc_steps(dev, "2x1", dims, variables, batches, lr)
        out["clean"] = ldpc_steps(dev, "2x1", dims, variables, batches[:1],
                                  lr, clean_weight=case["clean_weight"])
        out["syncbn"] = syncbn(dev, case["bn_x"], case["bn_g"])
        out["divisibility"] = divisibility(dev, dims)
        out["hop"] = hop_train(dev, tmp)
    else:
        out["1x2"] = ldpc_steps(dev, "1x2", dims, variables, batches, lr)
        out["clip"] = clip_norm(dev, dims, variables, batches[0], lr)
        out["resume"] = ldpc_resume(dev, tmp, dims, case["ckpt"],
                                    case["seed"])
    return out


# --------------------------------------------------------------------------
# test_torch_halo.py


def halo_conv(dev, case, plan):
    """One halo conv on this rank: its output rows, and with ``grad`` the
    gradients of x's rows and of the filters (this rank's part)."""
    mesh = case["mesh"]
    graph = HaloGraph(plan, mesh)
    x = torch.tensor(graph.local_src(case["x"]), requires_grad=True)
    w = torch.tensor(case["w"], requires_grad=True)
    et_loc, et_rem = graph.shard_etype(torch.from_numpy(case["et"]))
    bias = None if case.get("bias") is None else torch.from_numpy(
        case["bias"])
    out = halo_typed_mp_coo(x, et_loc, et_rem, w, case["cout"], graph,
                            aggregator=case["aggregator"], bias=bias)
    res = {"out": _np(out)}
    if case.get("grad"):
        n_dst, r, nd = plan.n_dst, mesh.data_rank, plan.dst_block
        valid = max(0, min(nd, n_dst - r * nd))
        (out[:valid] ** 2).sum().backward()
        res["gx"], res["gw"] = _np(x.grad), _np(w.grad)
    return res


def halo_mpconv(dev, case, plan):
    """MPConv's halo branch on this rank, in train and eval mode, from the
    flax variables: output rows, running statistics."""
    mesh = case["mesh"]
    graph = HaloGraph(plan, mesh)
    res = {}
    for train in (True, False):
        conv = MPConv(case["x"].shape[1], case["nout"], 4,
                      extension=Extension.NO_EXTENSION,
                      aggregator=case["aggregator"])
        load_flax_variables(conv, case["variables"])
        conv.train(train)
        with torch.no_grad():
            y = conv(torch.from_numpy(graph.local_src(case["x"])), graph,
                     torch.from_numpy(case["et"]))
        res[train] = {"out": _np(y), "mean": _np(conv.bn.running_mean),
                      "var": _np(conv.bn.running_var)}
    return res


def halo_worker(dev, cases, plans):
    mesh = make_mesh((dist.get_world_size(), 1))
    out = {}
    for name, case in cases.items():
        case = dict(case, mesh=mesh)
        fn = halo_mpconv if name.startswith("mpconv") else halo_conv
        out[name] = fn(dev, case, plans[name])
    return out


# --------------------------------------------------------------------------
# test_torch_edge_partition.py


def edge_worker(dev, cases):
    mesh = make_mesh((dist.get_world_size(), 1))
    out = {}
    for name, c in cases.items():
        x = torch.tensor(c["x"], requires_grad=True)
        w = torch.tensor(c["w"], requires_grad=True)
        et = torch.tensor(c["etype"], requires_grad=True)
        y = partitioned_typed_mp_coo(
            x, c["src"], c["dst"], et, c["mask"], w, c["cout"], c["nd"],
            mesh, aggregator=c["aggregator"])
        res = {"out": _np(y)}
        if c.get("grad"):
            try:
                (y ** 2).sum().backward()
                res["grads"] = (_np(x.grad), _np(w.grad), _np(et.grad))
            except NotImplementedError as e:
                res["raised"] = str(e)
        out[name] = res
    return out
