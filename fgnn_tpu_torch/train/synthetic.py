"""Synthetic chain-MRF MAP trainers (counterpart of
``fgnn_tpu/train/synthetic.py``).

One engine, three workloads:
  * fixed: ``SynFixedModel`` over the variable chain
  * pw:    ``SynPwFactorModel``, learned pairwise factors
  * hop:   ``SynHopFactorModel``, learned pairwise and budget factors;
           with ``--coo`` ``SynHopFactorModelCoo``, each batch one flat
           disjoint union of its chains (``graph.build_joint_coo``)

The JAX trainer's recipe: Adam (no weight decay) at lr 3e-3 times 0.98 per
epoch, gradients clipped to global norm 1.0 (optax's rule,
``train.common.clip_grad_norm``), cross-entropy over 2 classes, batch 32;
accuracy against the exact MAP labels, with the LP relaxation's accuracy
as the baseline.  Samples come with their oracle labels (``data.rpgm``),
in the JAX trainer's order for one seed, from one of three sources:

* ``--train-path``: a written dataset (``data.generate``), every epoch in
  a new shuffled order (seed + 1 for the init batch, then seed + 2, ...);
* ``--workers N`` (default ``max(1, min(8, cpus - 1))``, the JAX
  trainer's): N worker processes (``data.loader.PoolBatcher``), each
  sample seeded by (seed, index): one batch for the parameter init, then
  the epochs' batches;
* ``--workers 0``: inline, from one generator: one batch for the init,
  the epochs' batches, then the eval batches.

The ragged ``--coo`` modes synthesise inline, whatever ``--workers``
says, from their own generators (``data.rpgm``): ``--mixed-lengths
24,30,36`` puts one chain of each length into every sample
(``MixedLengthHopData``), and ``--length-dist 0.5,0.3,0.2`` draws each
batch's length from that distribution (``BucketedHopData``, one table set
per length).  The eval batches come from ``--test-path`` in file order, or
else inline from a generator of the seed (after the training batches when
those were inline too).  The train loop stages each batch on the device from a
prefetch thread (``data.loader.device_prefetch``).  Besides the JAX
trainer's scalars (``syn_train/loss``,
``acc``, ``lp_acc`` every 10 steps, ``syn_test/acc``, ``lp_acc``) the run's
``tf_logs/metrics.jsonl`` has ``syn_train/samples_per_s`` per epoch and
``syn_test/samples_per_s``, host synthesis included.

    python -m fgnn_tpu_torch.train.syn_hop_factor --work-dir runs
    python -m fgnn_tpu_torch.train.syn_hop_factor --device cpu \\
        --train-size 64 --test-size 32 --train-epoches 1
    python -m fgnn_tpu_torch.train.syn_hop_factor --coo \\
        --mixed-lengths 24,30,36 [--length-dist 0.5,0.3,0.2]

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--bf16`` trains and
tests under the bf16 compute policy (``models/policy.py``), as the JAX
trainer's flag.  ``--model-path`` names a trainer checkpoint to resume
from when it exists: the port's (``latest.ckpt``, a ``torch.save``) or the
JAX trainer's pickle of the same workload, either optimizer layout
(``jax_checkpoint.py``); a JAX hop checkpoint also resumes ``--coo``,
whose model has the dense model's parameters.

``--mesh DPxTP`` trains on dp * tp ranks started by ``torchrun``, as the
LDPC trainer does (``train/ldpc.py``): each rank takes its rows of every
batch (a ``--coo`` batch, a flat union, is replicated, as the JAX package
replicates it), the gradients are averaged over the data axis before
clipping (which counts each shard once), rank 0 alone logs and writes
the checkpoints (unmeshed), and the test runs replicated on the gathered
parameters.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import logging
import os
import time
from itertools import islice

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import resolve_device
from ..data import (
    BucketedHopData,
    MixedLengthHopData,
    PoolBatcher,
    RandomPGM,
    RandomPGMHop,
    RandomPGMPw,
    batches,
    chain_knn_table,
    device_prefetch,
    global_factor_table,
    high_factor_table,
    pw_factor_table,
)
from ..models import (
    SynFixedModel,
    SynHopFactorModel,
    SynHopFactorModelCoo,
    SynPwFactorModel,
    init_weights,
)
from ..data.generate import NpzRPGMData
from ..data.loader import to_device
from ..graph import build_joint_coo
from ..models.policy import bf16_policy
from ..ops.typed_mp import GatherTable
from ..parallel.sharding import set_data_group, shard_originals, unshard
from ..utils.logging import MetricsWriter, init_logger
from ..utils.profiling import annotate
from .common import (
    Schedules,
    clip_grad_norm,
    load_checkpoint,
    make_optimizer,
    mean_metrics,
    mesh_group,
    prepare_mesh_training,
    reduce_gradients,
    save_checkpoint,
    set_lr,
)

BASE_LR = 3e-3
CLIP_NORM = 1.0
LR_DECAY = 0.98

log = logging.getLogger(__name__)


def make_syn_dataset(workload: str, args):
    """The per-workload sample generator (numpy, seeded)."""
    L = args.chain_length
    if workload == "fixed":
        return RandomPGM(L, args.hop_cap, hop_order=args.hop_order,
                         seed=args.seed)
    if workload == "pw":
        return RandomPGMPw(L, args.hop_cap, hop_order=args.hop_order,
                           ret_efeature=False, seed=args.seed)
    if workload == "hop":
        return RandomPGMHop(L, hop_order=args.hop_order,
                            ret_efeature_pw=False, seed=args.seed)
    raise ValueError(f"unknown workload {workload!r}")


def _joint_tables(lengths, hop_order: int) -> dict:
    """The COO model's graph arguments for a batch of chains of
    ``lengths``, in order: each type's joint CooGraph and edge features."""
    pw = [pw_factor_table(L) for L in lengths]
    high = [high_factor_table(L, hop_order) for L in lengths]
    coo_pw, ef_pw, _ = build_joint_coo([t for t, _ in pw],
                                       [e for _, e in pw], lengths)
    coo_high, ef_high, _ = build_joint_coo([t for t, _ in high],
                                           [e for _, e in high], lengths)
    return {"coo_pw": coo_pw, "ef_pw": ef_pw, "coo_high": coo_high,
            "ef_high": ef_high}


class SynWorkload:
    """Model, dataset and the static tables of one workload.

    Each static table is a ``GatherTable`` (a ``CooGraph`` under ``--coo``)
    built once, here; ``to(device)`` moves the tables and their edge
    features with the model.  ``static`` holds the model's table and
    edge-feature arguments; ``batch_keys`` maps the model's per-sample
    arguments to the batch's keys.  Under ``--coo`` (workload
    ``hop_coo``) ``buckets`` holds one such set per sample width (the
    nodes of one sample: L, the sum of ``--mixed-lengths``, or each
    length of ``--length-dist``), each a disjoint union of B samples in
    batch-major order, and a batch takes the set of its width."""

    def __init__(self, workload: str, args):
        L = args.chain_length
        dims = getattr(args, "dims", None)  # None: the reference widths
        dim_kw = {"dims": tuple(dims)} if dims else {}
        self.workload = workload
        self.dataset = make_syn_dataset(workload, args)
        self.buckets = None
        if workload == "hop" and getattr(args, "coo", False):
            self._init_coo(args, dim_kw)
            return
        if workload == "fixed":
            self.model = SynFixedModel(variant=args.model_name)
            nn_idx, ef = chain_knn_table(L, args.neighbour)
            self.static = {"table": GatherTable(nn_idx, L),
                           "efeature": torch.from_numpy(ef)}
            self.batch_keys = {"node_feature": "node_feature"}
            return
        nn_pw, ef_pw = pw_factor_table(L)
        if workload == "pw":
            self.model = SynPwFactorModel(**dim_kw)
            nn_high, ef_high, _ = global_factor_table(L, args.neighbour)
            self.batch_keys = {"node_feature": "node_feature", "pws": "pws"}
        elif workload == "hop":
            self.model = SynHopFactorModel(hop_order=args.hop_order, **dim_kw)
            nn_high, ef_high = high_factor_table(L, args.hop_order)
            self.batch_keys = {"node_feature": "node_feature", "pws": "pws",
                               "hops": "efeature_hop"}
        else:
            raise ValueError(f"unknown workload {workload!r}")
        self.static = {
            "table_pw": GatherTable(nn_pw, nn_pw.shape[0]),
            "ef_pw": torch.from_numpy(ef_pw),
            "table_high": GatherTable(nn_high, nn_high.shape[0]),
            "ef_high": torch.from_numpy(ef_high)}

    def _init_coo(self, args, dim_kw) -> None:
        """``--coo``: flat disjoint-union batches through the COO IR, with
        the dense model's parameters.  ``--mixed-lengths`` gives every
        batch chains of each length (composite samples), ``--length-dist``
        draws each batch's length; both with no padding."""
        B = args.batch_size
        mixed = getattr(args, "mixed_lengths", "")
        lengths = ([int(x) for x in mixed.split(",") if x] if mixed
                   else [args.chain_length])
        dist = getattr(args, "length_dist", "")
        if dist:
            self.dataset = BucketedHopData(
                lengths, [float(x) for x in dist.split(",") if x],
                hop_order=args.hop_order, ret_efeature_pw=False,
                seed=args.seed)
            self.buckets = {L: _joint_tables([L] * B, args.hop_order)
                            for L in lengths}
        else:
            if mixed:
                self.dataset = MixedLengthHopData(
                    lengths, hop_order=args.hop_order,
                    ret_efeature_pw=False, seed=args.seed)
            # composite order, batch-major
            self.buckets = {sum(lengths): _joint_tables(lengths * B,
                                                        args.hop_order)}
        self.static = next(iter(self.buckets.values()))
        self.model = SynHopFactorModelCoo(hop_order=args.hop_order,
                                          **dim_kw)
        self.workload = "hop_coo"
        self.batch_keys = {"node_feature": "node_feature", "pws": "pws",
                           "hops": "efeature_hop"}

    def to(self, device) -> "SynWorkload":
        self.model = self.model.to(device)
        if self.buckets is None:
            self.static = {k: v.to(device) for k, v in self.static.items()}
        else:
            self.buckets = {n: {k: v.to(device) for k, v in s.items()}
                            for n, s in self.buckets.items()}
            self.static = next(iter(self.buckets.values()))
        return self

    def stage(self, batch: dict, device) -> dict:
        """The model's arguments and the labels of a numpy batch, on
        ``device``; under ``--coo`` the model's arguments flat over the
        batch's samples, the labels (B, width)."""
        with annotate("stage"):
            keep = {arg: batch[key] for arg, key in self.batch_keys.items()}
            if self.buckets is not None:
                keep = {k: v.reshape((-1,) + v.shape[2:])
                        for k, v in keep.items()}
            for key in ("label", "lp_label"):
                keep[key] = batch[key]
            return to_device(keep, device, non_blocking=True)

    def logits(self, staged: dict) -> torch.Tensor:
        """(B, L, 2) logits of a staged batch; under ``--coo`` flat,
        (B * width, 2), over the tables of the batch's width."""
        static = (self.static if self.buckets is None
                  else self.buckets[staged["label"].shape[1]])
        return self.model(**{a: staged[a] for a in self.batch_keys},
                          **static)


def train_step(wl: SynWorkload, optimizer: torch.optim.Optimizer,
               batch: dict, device, mesh=None) -> dict:
    """One clipped Adam step on one batch (numpy, or staged by
    ``wl.stage``): the JAX ``make_train_step``.  Returns {loss, acc,
    lp_acc} as device scalars and leaves the clipped gradients in the
    parameters' ``.grad``.  Under a ``mesh``: this rank's rows and
    metrics, the gradients averaged over the data axis.  Its spans are
    those of ``train.ldpc.train_step``, with ``clip`` inside
    ``optimizer``."""
    with annotate("step"):
        if not isinstance(batch["label"], torch.Tensor):
            batch = wl.stage(batch, device)
        model = wl.model.train()
        with annotate("forward"):
            logits = wl.logits(batch)
        with annotate("loss"):
            # the labels in the logits' layout: (B, L), or flat under --coo
            label = batch["label"].long().reshape(logits.shape[:-1])
            loss = F.cross_entropy(logits.reshape(-1, 2), label.reshape(-1))
        with annotate("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with annotate("optimizer"):
            reduce_gradients(model.parameters(), mesh)
            with annotate("clip"):
                clip_grad_norm(model.parameters(), CLIP_NORM, mesh,
                               shard_originals(model) if mesh is not None
                               else ())
            optimizer.step()
        with annotate("metrics"):
            with torch.no_grad():
                acc = (logits.argmax(dim=-1) == label).float().mean()
                lp_acc = (batch["lp_label"].long().reshape(
                    logits.shape[:-1]) == label).float().mean()
        return {"loss": loss.detach(), "acc": acc, "lp_acc": lp_acc}


def eval_step(wl: SynWorkload, batch: dict, device) -> torch.Tensor:
    """MAP predictions of a numpy batch in its labels' shape, on the
    running statistics (the JAX ``make_eval_step``), left on ``device``."""
    wl.model.eval()
    with torch.inference_mode():
        return wl.logits(wl.stage(batch, device)).argmax(dim=-1).reshape(
            batch["label"].shape)


def train_and_eval(workload: str, args, *, device=None):
    """Train ``workload`` for ``args.train_epoches`` epochs of
    ``train_size // batch_size`` steps (fewer where ``args.train_path``
    holds fewer samples; resuming from ``args.model_path`` when it
    exists), saving ``latest.ckpt`` after each epoch, then test on
    ``max(test_size // batch_size, 1)`` batches (of ``args.test_path``, or
    fresh), all under the bf16 compute policy when ``args.bf16``.  Returns
    (acc, lp_acc) against the exact MAP labels.  With ``args.mesh``, over
    its ranks (in the caller's process group, else in one of torchrun's
    that this starts and ends); every rank returns the same."""
    dev = resolve_device(device if device is not None
                         else getattr(args, "device", None))
    with bf16_policy(getattr(args, "bf16", False)), \
            mesh_group(args, dev) as dev:
        return _train_and_eval(workload, args, dev)


def _npz_source(args):
    """(batch source, steps per epoch) of ``--train-path``: every call
    shuffles the file anew, by seed + 1, seed + 2, ..."""
    npz = NpzRPGMData(args.train_path, size=args.train_size)
    draws = [0]

    def source(n):
        draws[0] += 1
        return npz.batches(args.batch_size, shuffle=True,
                           seed=args.seed + draws[0])

    return source, min(args.train_size // args.batch_size,
                       len(npz) // args.batch_size)


def _batches(wl: SynWorkload, batch_size: int, n: int):
    """n fresh batches of the workload's generator: its own ``batches``
    where it has one (``BucketedHopData``), else stacked samples."""
    if hasattr(wl.dataset, "batches"):
        return wl.dataset.batches(batch_size, n)
    return batches(wl.dataset, batch_size, n)


def _eval_source(args, wl):
    """(batches, count) of the test: ``--test-path`` in file order, or
    fresh batches from the workload's generator."""
    n = max(args.test_size // args.batch_size, 1)
    if not getattr(args, "test_path", ""):
        return _batches(wl, args.batch_size, n), n
    npz = NpzRPGMData(args.test_path, size=args.test_size)
    n = min(n, len(npz) // args.batch_size)
    if n < 1:
        raise ValueError(
            f"test set {args.test_path!r} has {len(npz)} samples, fewer "
            f"than one batch of {args.batch_size}: lower --batch-size or "
            "use a larger test set")
    return islice(npz.batches(args.batch_size, shuffle=False), n), n


def _train_and_eval(workload: str, args, dev):
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    work = os.path.join(args.work_dir,
                        f"syn_{workload}_{args.model_name}_at_{stamp}")
    if not getattr(args, "mesh", "") or dist.get_rank() == 0:
        init_logger(os.path.join(work, "logs"), "train", print_log=True)
    log.info("%s", args)

    # The training batches' source, as the JAX trainer chooses it: a
    # written dataset, else a worker pool, else inline synthesis.  The
    # pool forks before this process's first CUDA call (wl.to below), as
    # the JAX trainer forks before its backend starts
    # (data.loader.PoolBatcher).
    steps_per_epoch = args.train_size // args.batch_size
    pool = batch_source = None
    workers = getattr(args, "workers", 0)
    if getattr(args, "mixed_lengths", "") or getattr(args, "length_dist",
                                                     ""):
        # the ragged modes own their sampler; a worker pool would
        # synthesise chains of one length and defeat them
        if workers:
            log.info("--mixed-lengths/--length-dist: inline synthesis "
                     "(worker pool does not apply)")
        workers = 0
    if getattr(args, "train_path", ""):
        batch_source, steps_per_epoch = _npz_source(args)
    elif workers:
        pool = PoolBatcher(functools.partial(make_syn_dataset, workload,
                                             args),
                           args.batch_size, n_workers=workers,
                           seed=args.seed)
        batch_source = pool.batches
    try:
        wl = SynWorkload(workload, args)
        if batch_source is None:
            def batch_source(n):
                return _batches(wl, args.batch_size, n)
        return _run(wl, workload, args, dev, work, batch_source,
                    steps_per_epoch)
    finally:
        if pool is not None:
            pool.close()


def _run(wl, workload, args, dev, work, batch_source, steps_per_epoch):
    init_weights(wl.model, args.seed)
    wl.to(dev)
    # The JAX trainer draws one batch of its source for its parameter
    # init before it trains (fgnn_tpu/train/synthetic.py:300); drawing and
    # dropping it gives both trainers the same batches for one seed.
    next(batch_source(1))
    optimizer = make_optimizer(wl.model.parameters(), BASE_LR,
                               weight_decay=0.0)
    sched = Schedules.exp_decay(LR_DECAY)

    start_epoch, gcnt = 0, 0
    if args.model_path and os.path.exists(args.model_path):
        start_epoch, gcnt = load_checkpoint(args.model_path, wl.model,
                                            optimizer)
    mesh, rows = None, (lambda b: b)
    if getattr(args, "mesh", ""):
        mesh, rows = prepare_mesh_training(args.mesh, wl.model, optimizer,
                                           args.batch_size, dev)
        if wl.buckets is not None:
            # a flat union's tables cover the whole batch: every rank
            # computes all of it, as the JAX package replicates it
            rows = lambda b: b  # noqa: E731
            set_data_group(wl.model, None)
        log.info("sharded training over mesh %s", mesh.shape)
    main_rank = mesh is None or mesh.rank == 0
    log.info("training %s: %d epochs x %d steps on %s", workload,
             args.train_epoches, steps_per_epoch, dev)
    with (MetricsWriter(os.path.join(work, "tf_logs")) if main_rank
          else contextlib.nullcontext()) as writer:
        for epoch in range(start_epoch, args.train_epoches):
            set_lr(optimizer, BASE_LR * sched(epoch))
            t0 = time.time()
            # batches staged on the device from a prefetch thread; metrics
            # stay there until the logging boundary
            pending = []
            with device_prefetch(batch_source(steps_per_epoch), dev,
                                 put=lambda b: wl.stage(rows(b), dev)
                                 ) as staged:
                for bcnt, batch in enumerate(staged):
                    pending.append(train_step(wl, optimizer, batch, dev,
                                              mesh=mesh))
                    gcnt += 1
                    if gcnt % 10 == 0:
                        mm = mean_metrics(pending, mesh)
                        pending = []
                        if main_rank:
                            for k, v in mm.items():
                                writer.add_scalar(f"syn_train/{k}", v, gcnt)
                        log.info("epoch=%d bcnt=%d %s", epoch, bcnt,
                                 {k: round(v, 4) for k, v in mm.items()})
            save_checkpoint(os.path.join(work, "latest.ckpt"), wl.model,
                            optimizer, epoch + 1, gcnt, mesh)
            # the checkpoint copied the weights to the host: the device is
            # done, so the epoch's wall time holds all of its work
            seconds = time.time() - t0
            if main_rank:
                writer.add_scalar("syn_train/samples_per_s",
                                  steps_per_epoch * args.batch_size / seconds,
                                  gcnt)
            log.info("epoch %d done in %.1fs", epoch, seconds)
        if mesh is not None:
            unshard(wl.model)

        # ---- test: the test set, or fresh oracle-labelled batches
        t0 = time.time()
        eval_source, eval_batches = _eval_source(args, wl)
        preds, hosts = [], []
        for batch in eval_source:
            preds.append(eval_step(wl, batch, dev))
            hosts.append(batch)
        accs, lp_accs = [], []
        for pred, batch in zip([p.cpu().numpy() for p in preds], hosts):
            accs.append((pred == batch["label"]).mean())
            lp_accs.append((batch["lp_label"] == batch["label"]).mean())
        acc, lp_acc = float(np.mean(accs)), float(np.mean(lp_accs))
        log.info("testing result: acc = %.4f, acc_lp = %.4f", acc, lp_acc)
        if main_rank:
            writer.add_scalar("syn_test/acc", acc, gcnt)
            writer.add_scalar("syn_test/lp_acc", lp_acc, gcnt)
            writer.add_scalar("syn_test/samples_per_s",
                              eval_batches * args.batch_size
                              / (time.time() - t0), gcnt)
    return acc, lp_acc


def parse_args(argv=None, workload: str = "fixed"):
    """The JAX trainer's flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        description=f"fgnn_tpu_torch synthetic trainer ({workload})")
    p.add_argument("--chain-length", "--chain_length", type=int, default=30)
    p.add_argument("--hop-cap", "--hop_cap", type=int, default=5)
    p.add_argument("--hop-order", "--hop_order", type=int, default=9)
    p.add_argument("--train-epoches", "--train_epoches", type=int, default=10)
    p.add_argument("--model-path", "--model_path", type=str, default="",
                   help="the port or JAX trainer checkpoint to resume from "
                        "when it exists")
    p.add_argument("--model-name", "--model_name", type=str,
                   default="mp_nn" if workload == "fixed" else "mp_nn_factor")
    p.add_argument("--neighbour", type=int, default=8)
    p.add_argument("--train-size", "--train_size", type=int, default=90000)
    p.add_argument("--test-size", "--test_size", type=int, default=10000)
    p.add_argument("--batch-size", "--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--work-dir", type=str, default="runs")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--workers", type=int,
                   default=max(1, min(8, (os.cpu_count() or 2) - 1)),
                   help="multiprocess sample-synthesis workers, each "
                        "sample seeded by (seed, index); 0 = inline "
                        "synthesis from one generator")
    p.add_argument("--train-path", "--train_path", type=str, default="",
                   help="pre-generated .npz dataset "
                        "(python -m fgnn_tpu_torch.data.generate rpgm)")
    p.add_argument("--test-path", "--test_path", type=str, default="",
                   help="pre-generated .npz eval dataset; empty = fresh "
                        "oracle-labelled samples synthesised inline")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 compute policy (f32 params/stats)")
    p.add_argument("--mesh", type=str, default="",
                   help="DPxTP mesh of the ranks torchrun starts (e.g. 2x1, "
                        "1x2, or 'auto'); empty = one process")
    p.add_argument("--coo", action="store_true", default=False,
                   help="(hop) batch via the FactorGraph COO disjoint union "
                        "instead of dense (B, N, K) tables")
    p.add_argument("--mixed-lengths", "--mixed_lengths", type=str, default="",
                   help="(hop --coo) comma list of chain lengths; every "
                        "batch holds batch-size groups with one chain per "
                        "length, flat-batched with zero padding")
    p.add_argument("--length-dist", "--length_dist", type=str, default="",
                   help="(hop --coo, with --mixed-lengths) comma list of "
                        "probabilities, one per length: chains draw their "
                        "length from this distribution and batches are "
                        "BUCKETED per length (one compile per bucket, "
                        "zero padding)")
    return p.parse_args(argv)


def main(workload: str, argv=None):
    return train_and_eval(workload, parse_args(argv, workload))
