"""LDPC neural-decoder training and evaluation (counterpart of
``fgnn_tpu/train/ldpc.py``).

Decodes the MacKay 96.3.963 code under AWGN + burst noise.  Training
synthesises batches on the fly (``ContinuousCodesSP``) and runs the
reference recipe: Adam, lr 1e-2 times the per-epoch warm-up/decay
schedule, weight decay 1e-8, loss = BCE-with-logits over the 48 info bits
+ 0.1 * MSE of the predicted 10^(sigma_b/20).  Evaluation reports the
5 SNR x 6 sigma_b bit-error matrix over a pre-generated grid.

    python -m fgnn_tpu_torch.train.ldpc --train --work-dir runs
    python -m fgnn_tpu_torch.train.ldpc --model-path model.pt \\
        --test-path dataset/ldpc_valid.npz

Runs on ``cuda`` unless ``--device cpu`` is given.  For training,
``--model-path`` names a trainer checkpoint to resume from when it exists:
the port's, or the JAX trainer's pickle (its params, batch_stats and Adam
state, either optimizer layout; ``jax_checkpoint.py``).  For decoding it
is any of those, a JAX pickle of params and batch_stats alone, or a
``torch.save`` of ``LDPCModel.state_dict()``; without it the decoder runs
a seeded random init.  ``--bf16`` runs decoding or training under the
bf16 compute policy (``models/policy.py``: bf16 activations and typed-mp
kernels, f32 parameters, optimizer state and normalisation statistics),
as the JAX trainer's flag.

Also as the JAX trainer: a missing eval grid is written with the
classical sum-product decoder's error matrix (``--eval-bp-baseline``, on
by default; ``--eval-bp-baseline 0`` writes zeros), which the decoder
prints beside its own.  ``--bp-features`` decodes each batch with the
batched sum-product decoder on the device (``ops/bp.py``, 50 loops) inside
the train and decode steps and appends its centred posterior and
convergence flag to the node features (a model of node-feature width 4).
``--workers N`` synthesises the training samples in N worker processes
(``data.loader.PoolBatcher``, default 0: inline); the train loop stages
batches on the device from a prefetch thread (``device_prefetch``) and
the decoder synthesises its batches in one (``prefetch``).

``--mesh DPxTP`` trains on dp * tp ranks, one process each, started by
``torchrun`` (``torch.distributed``: NCCL on one card per rank, gloo with
``--device cpu``):

    torchrun --nproc-per-node 2 -m fgnn_tpu_torch.train.ldpc --train \
        --mesh 2x1

Every rank synthesises the same global batch from the seed and keeps its
rows (``train.common.prepare_mesh_training``), so the run sees the
single-device run's data; the BatchNorm statistics are those of the
global batch, the wide parameters are sharded over the model axis, the
gradients averaged over the data axis.  Rank 0 alone logs and writes the
checkpoints, in the unmeshed format.  A spec that is not the world size
raises ``ValueError`` before anything is written.
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
    Codes,
    ContinuousCodesSP,
    PoolBatcher,
    decode_graph,
    device_prefetch,
    generate_eval_set,
    prefetch,
)
from ..data.loader import to_device
from ..models import LDPCModel, init_weights
from ..models.ldpc_model import BP_FEATURE_DIM, NODE_FEATURE_DIM
from ..models.policy import bf16_policy
from ..ops.bp import BPGraphArrays, bp_decode_batch
from ..parallel.comm import mean_over
from ..parallel.sharding import unshard
from ..utils.logging import MetricsWriter, init_logger
from ..utils.profiling import annotate
from .common import (
    Schedules,
    is_train_checkpoint,
    load_checkpoint as load_train_checkpoint,
    make_optimizer,
    mean_metrics,
    mesh_group,
    prepare_mesh_training,
    read_checkpoint,
    reduce_gradients,
    save_checkpoint,
    set_lr,
)
from .jax_checkpoint import is_jax_checkpoint, restore_jax_payload

N_INFO = 48
BASE_LR = 1e-2
SNRS = (0, 1, 2, 3, 4)
SIGMA_BS = (0, 1, 2, 3, 4, 5)
_INPUTS = ("node_feature", "hop_feature", "efeature_f2v", "efeature_v2f")
BP_FEATURE_LOOPS = 50

log = logging.getLogger(__name__)


def check_tables(model: LDPCModel, batch: dict) -> None:
    """Raise unless the batch's (host) tables are the model's code tables:
    a batch built for another parity-check matrix must not be decoded on
    this one's graph."""
    st = model.structure
    for key, ref in (("nn_idx_f2v", st.var_checks),
                     ("nn_idx_v2f", st.factors)):
        got = np.asarray(batch[key])
        if got.shape[-2:] != ref.shape or not np.array_equal(
                got, np.broadcast_to(ref, got.shape)):
            raise ValueError(f"batch {key} differs from the decoder's "
                             f"{ref.shape} table of its code structure")


@functools.lru_cache(maxsize=None)
def bp_arrays(device) -> BPGraphArrays:
    """The [s ; t] code's sum-product index tensors on ``device``, built
    once per device."""
    return BPGraphArrays.from_ref(decode_graph(), device)


def bp_bias(node_feature: torch.Tensor) -> torch.Tensor:
    """The nominal channel's bit posteriors P(1) = 1 / (1 + exp(-2 gcx y)),
    gcx = 10^(snr_db/20), of node features (B, 96, 2+), as f32.

    Computed in f64 and rounded once: f32 exp differs by an ulp between
    libraries (the card's, the CPU's, XLA's), and 50 loops of a decode that
    does not converge grow an ulp of its bias to 1e-2 in its posterior.
    Rounded from f64, the bias has the same bits on every device but where
    f64 lands within an f64 ulp of a rounding boundary of f32."""
    y = node_feature[..., 0].double()
    gcx = torch.pow(10.0, node_feature[..., 1].double() / 20.0)
    return (1.0 / (1.0 + torch.exp(-2.0 * gcx * y))).float()


def augment_bp_features(node_feature: torch.Tensor,
                        max_loops: int = BP_FEATURE_LOOPS) -> torch.Tensor:
    """``--bp-features``: append the sum-product decoder's view of each
    bit to the node features (B, 96, 2) -> (B, 96, 4), on their device.

    The batched decoder (``ops/bp.py``) runs ``max_loops`` iterations from
    ``bp_bias``, and its centred posterior 2 q1 - 1 and its convergence
    flag become two more channels, in node_feature's dtype.  No gradient
    flows through."""
    with torch.no_grad():
        _, ok, _, q1 = bp_decode_batch(bp_arrays(node_feature.device),
                                       bp_bias(node_feature),
                                       max_loops=max_loops,
                                       return_posterior=True)
        extra = torch.stack([2.0 * q1 - 1.0,
                             ok[:, None].float().expand_as(q1)], dim=-1)
        return torch.cat([node_feature, extra.to(node_feature.dtype)], -1)


def model_inputs(model: LDPCModel, batch: dict, device,
                 bp_features: bool = False) -> dict:
    """Check the tables on the host, copy the features to ``device`` and,
    with ``bp_features``, append the sum-product features there."""
    with annotate("stage"):
        check_tables(model, batch)
        inputs = to_device({k: batch[k] for k in _INPUTS}, device,
                           non_blocking=True)
        if bp_features:
            inputs["node_feature"] = augment_bp_features(
                inputs["node_feature"])
        return inputs


def decode_logits(model: LDPCModel, batch: dict, device,
                  bp_features: bool = False) -> torch.Tensor:
    """Info-bit logits (B, 48) of one numpy batch, left on ``device``."""
    if model.training:
        raise ValueError("decoding uses the running statistics: call "
                         "model.eval() first")
    with torch.inference_mode():
        inputs = model_inputs(model, batch, device, bp_features)
        with annotate("forward"):
            logits, _ = model(**inputs)
    return logits


def decode_step(model: LDPCModel, batch: dict, device,
                bp_features: bool = False) -> torch.Tensor:
    """Hard decisions (B, 48) int32: bit 1 where the logit is >= 0, in a
    ``decode`` span holding ``stage`` and ``forward``."""
    with annotate("decode"):
        return (decode_logits(model, batch, device, bp_features) >= 0).to(
            torch.int32)


def load_checkpoint(path: str, model: LDPCModel) -> LDPCModel:
    """Load a trainer checkpoint's model (the port's, or a JAX trainer's
    params and batch_stats, either optimizer layout), or a bare state
    dict."""
    payload = read_checkpoint(path)
    if is_jax_checkpoint(payload):
        restore_jax_payload(payload, model)
    else:
        model.load_state_dict(payload["model"] if is_train_checkpoint(
            payload) else payload)
    return model


def new_model(args) -> LDPCModel:
    """The decoder the flags describe, its weights not yet set."""
    width = NODE_FEATURE_DIM + (BP_FEATURE_DIM if getattr(
        args, "bp_features", False) else 0)
    return LDPCModel(aggregator=args.aggregator, node_feature_dim=width)


def build_model(args) -> LDPCModel:
    model = new_model(args)
    if args.model_path:
        return load_checkpoint(args.model_path, model)
    log.warning("no --model-path: decoding with random weights (seed %d)",
                args.seed)
    return init_weights(model, args.seed)


def evaluate(args, model: LDPCModel = None, *, device=None):
    """The BER matrix over ``args.test_path`` (generated there when
    missing, with the sum-product baseline unless
    ``args.eval_bp_baseline`` is false), with the sum-product features
    when ``args.bp_features``, under the bf16 compute policy when
    ``args.bf16``.  Returns (ber_total, err)."""
    with bf16_policy(getattr(args, "bf16", False)):
        return _evaluate(args, model, resolve_device(device))


def _evaluate(args, model, dev):
    if not os.path.exists(args.test_path):
        log.info("generating eval set at %s", args.test_path)
        generate_eval_set(args.test_path, n_per_cell=args.eval_per_cell,
                          with_bp_error=getattr(args, "eval_bp_baseline",
                                                True))
    ds = Codes(args.test_path)
    bp_feats = getattr(args, "bp_features", False)
    if model is None:
        model = build_model(args)
    model = model.to(dev).eval()

    # every batch is queued on the device first, synthesised in a
    # prefetch thread; one copy back at the end
    preds, hosts = [], []
    with prefetch(ds.batches(args.batch_size)) as source:
        for batch in source:
            preds.append(decode_step(model, batch, dev, bp_feats))
            hosts.append({k: batch[k]
                          for k in ("label", "snr_db", "sigma_b")})
    preds = torch.stack(preds).cpu().numpy() if preds else []

    acc_cnt = np.zeros((len(SNRS), len(SIGMA_BS)))
    acc_tot = np.zeros((len(SNRS), len(SIGMA_BS)))
    correct = total = 0
    for pred, hb in zip(preds, hosts):
        label = hb["label"][:, :N_INFO]
        for i, s in enumerate(SNRS):
            for j, b in enumerate(SIGMA_BS):
                sel = ((np.abs(hb["snr_db"] - s) < 1e-3)
                       & (hb["sigma_b"].astype(int) == b))
                acc_cnt[i, j] += np.sum(pred[sel, :N_INFO] == label[sel])
                acc_tot[i, j] += sel.sum() * N_INFO
        correct += np.sum(pred[:, :N_INFO] == label)
        total += label.size
    ber_total = 1.0 - correct / max(total, 1)
    err = 1.0 - np.divide(acc_cnt, np.maximum(acc_tot, 1))
    print(ber_total)
    print(np.array_str(err, precision=4, suppress_small=True))
    with np.load(args.test_path) as f:
        bp = f["bp_err_matrix"] if "bp_err_matrix" in f else None
    if bp is not None and bp.any():
        print("sum-product baseline:")
        print(np.array_str(bp, precision=4, suppress_small=True))
    return ber_total, err


def stage_batch(model: LDPCModel, batch: dict, device) -> dict:
    """``model_inputs`` (without the sum-product features) plus the
    info-bit labels and sigma_b, on ``device``."""
    with annotate("stage"):
        check_tables(model, batch)
        keep = {k: batch[k] for k in _INPUTS}
        keep["label"] = batch["label"][:, :N_INFO]
        keep["sigma_b"] = batch["sigma_b"]
        return to_device(keep, device, non_blocking=True)


def train_step(model: LDPCModel, optimizer: torch.optim.Optimizer,
               batch: dict, device, clean_weight: float = 0.0,
               bp_features: bool = False, mesh=None) -> dict:
    """One Adam step on one batch: a numpy batch, or one that
    ``stage_batch`` already put on ``device``; with ``bp_features`` the
    sum-product features are appended on the device first.  Returns the
    JAX trainer's metrics as device scalars, {loss (the BCE),
    sigma_b_loss, acc}, and leaves the step's gradients in the
    parameters' ``.grad``.  Under a ``mesh`` the batch is this rank's
    rows, and the returned metrics and the gradients are this rank's:
    the mean of each over the data axis is the global batch's (the
    weighted BCE of ``clean_weight`` divides by the data-axis mean of the
    weights' sums, so it too).  A ``step`` span holds the phases' spans
    (``utils.profiling.annotate``): ``stage`` (a numpy batch, the
    sum-product features), ``forward``, ``loss``, ``backward``
    (``zero_grad`` and ``.backward()``), ``optimizer`` (the gradients'
    reduce and Adam) and ``metrics``."""
    with annotate("step"):
        if not isinstance(batch["label"], torch.Tensor):
            batch = stage_batch(model, batch, device)
        model.train()
        inputs = {k: batch[k] for k in _INPUTS}
        if bp_features:
            with annotate("stage"):
                inputs["node_feature"] = augment_bp_features(
                    inputs["node_feature"])
        with annotate("forward"):
            logits, sb_pred = model(**inputs)
        with annotate("loss"):
            label = batch["label"].float()
            sigma_b = batch["sigma_b"].float().reshape(-1)
            per_bit = F.binary_cross_entropy_with_logits(
                logits.reshape(label.shape), label, reduction="none")
            if clean_weight:
                # --clean-weight: upweight the sigma_b <= 1 samples, where
                # classical BP is near-ML
                w = 1.0 + clean_weight * (sigma_b <= 1.0).float()
                bce = (w * per_bit.mean(dim=-1)).sum() / mean_over(
                    w.sum(), None if mesh is None else mesh.data_group)
            else:
                bce = per_bit.mean()
            mse = (sb_pred.reshape(-1)
                   - torch.pow(10.0, sigma_b / 20.0)).square().mean()
            objective = bce + 0.1 * mse
        with annotate("backward"):
            optimizer.zero_grad(set_to_none=True)
            objective.backward()
        with annotate("optimizer"):
            reduce_gradients(model.parameters(), mesh)
            optimizer.step()
        with annotate("metrics"):
            with torch.no_grad():
                acc = ((logits > 0).to(batch["label"].dtype)
                       == batch["label"]).float().mean()
        return {"loss": bce.detach(), "sigma_b_loss": mse.detach(),
                "acc": acc}


def train(args, model: LDPCModel, writer: MetricsWriter, model_dir: str, *,
          device=None) -> LDPCModel:
    """Train ``model`` (already initialised) for ``args.n_epochs`` epochs,
    resuming from ``args.model_path`` when that checkpoint exists, with
    the sum-product features when ``args.bp_features``, the samples
    synthesised by ``args.workers`` processes (0: inline), under the bf16
    compute policy when ``args.bf16``, over the ranks of ``args.mesh``
    when it is set (in the caller's process group, else in one of
    torchrun's that ``train`` starts and ends).  Saves
    ``ldpc_latest.ckpt`` after each epoch and ``ldpc_final.ckpt`` at the
    end, in ``model_dir`` (under a mesh: rank 0, which alone writes to
    ``writer``).  Returns the trained model, unmeshed."""
    dev = resolve_device(device)
    # The pool forks before this process's first CUDA call, as the JAX
    # trainer forks before its backend starts (data.loader.PoolBatcher).
    pool = None
    if getattr(args, "workers", 0):
        pool = PoolBatcher(
            functools.partial(ContinuousCodesSP,
                              length=args.samples_per_epoch, snr=args.snr,
                              seed=args.seed),
            args.batch_size, n_workers=args.workers, seed=args.seed)
    try:
        with bf16_policy(getattr(args, "bf16", False)), \
                mesh_group(args, dev) as dev:
            return _train(args, model, writer, model_dir, dev, pool)
    finally:
        if pool is not None:
            pool.close()


def _train(args, model, writer, model_dir, dev, pool):
    model = model.to(dev)
    dataset = ContinuousCodesSP(length=args.samples_per_epoch, snr=args.snr,
                                seed=args.seed)
    # The JAX trainer draws one batch for its parameter init before it
    # trains (fgnn_tpu/train/ldpc.py:236), from the inline generator also
    # when a pool synthesises the training batches; drawing and dropping
    # it here gives both trainers the same batches for one seed.
    next(dataset.batches(args.batch_size))
    bp_feats = getattr(args, "bp_features", False)
    optimizer = make_optimizer(model.parameters(), BASE_LR)
    sched = Schedules.ldpc()

    start_epoch, gcnt = 0, 0
    if args.model_path and os.path.exists(args.model_path):
        start_epoch, gcnt = load_train_checkpoint(args.model_path, model,
                                                  optimizer)
    mesh, rows = None, (lambda b: b)
    if getattr(args, "mesh", ""):
        mesh, rows = prepare_mesh_training(args.mesh, model, optimizer,
                                           args.batch_size, dev)
        log.info("sharded training over mesh %s", mesh.shape)
    main_rank = mesh is None or mesh.rank == 0
    steps_per_epoch = (args.steps_per_epoch
                       or len(dataset) // args.batch_size)
    log.info("training: %d epochs x %d steps on %s", args.n_epochs,
             steps_per_epoch, dev)
    ckpt_path = os.path.join(model_dir, "ldpc_latest.ckpt")
    for epoch in range(start_epoch, args.n_epochs):
        set_lr(optimizer, BASE_LR * sched(epoch))
        t0 = time.time()
        # batches staged on the device from a prefetch thread; metrics
        # stay there until the logging boundary.  The source is capped
        # with islice, so that the thread ends with the epoch.
        source = (pool.batches(steps_per_epoch) if pool is not None
                  else islice(dataset.batches(args.batch_size),
                              steps_per_epoch))
        pending = []
        with device_prefetch(source, dev, put=lambda b: stage_batch(
                model, rows(b), dev)) as staged:
            for bcnt, batch in enumerate(staged):
                pending.append(train_step(model, optimizer, batch, dev,
                                          args.clean_weight, bp_feats,
                                          mesh=mesh))
                gcnt += 1
                if gcnt % 10 == 0:
                    mm = mean_metrics(pending, mesh)
                    pending = []
                    if main_rank:
                        for k in ("loss", "sigma_b_loss", "acc"):
                            writer.add_scalar(f"syn_train/{k}", mm[k], gcnt)
                    log.info("epoch=%d bcnt=%d loss=%.4f acc=%.4f", epoch,
                             bcnt, mm["loss"], mm["acc"])
        log.info("epoch %d done in %.1fs", epoch, time.time() - t0)
        save_checkpoint(ckpt_path, model, optimizer, epoch + 1, gcnt, mesh)
    save_checkpoint(os.path.join(model_dir, "ldpc_final.ckpt"), model,
                    optimizer, args.n_epochs, gcnt, mesh)
    return model if mesh is None else unshard(model)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fgnn_tpu_torch LDPC trainer "
                                            "and decoder")
    p.add_argument("--train", action="store_true", default=False)
    p.add_argument("--n-epochs", "--n_epochs", type=int, default=10)
    p.add_argument("--model-path", "--model_path", type=str, default="",
                   help="decoding: a port or JAX checkpoint (empty = "
                        "seeded random init); training: the port or JAX "
                        "trainer checkpoint to resume from when it exists")
    p.add_argument("--model-name", "--model_name", type=str,
                   default="FactorNN")
    p.add_argument("--snr", type=int, default=None)
    p.add_argument("--test-path", "--test_path", type=str,
                   default="dataset/ldpc_valid.npz")
    p.add_argument("--batch-size", "--batch_size", type=int, default=32)
    p.add_argument("--aggregator", type=str, default="max")
    p.add_argument("--samples-per-epoch", type=int, default=10000)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override for smoke tests")
    p.add_argument("--eval-per-cell", type=int, default=1000)
    p.add_argument("--eval-bp-baseline", type=lambda s: s != "0",
                   default=True,
                   help="write a missing eval grid with the sum-product "
                        "decoder's error matrix (0: zeros)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--work-dir", type=str, default="runs")
    p.add_argument("--workers", type=int, default=0,
                   help="multiprocess sample-synthesis workers (0 = inline)")
    p.add_argument("--clean-weight", "--clean_weight", type=float,
                   default=0.0,
                   help="extra loss weight on sigma_b<=1 samples; 0=off")
    p.add_argument("--bp-features", "--bp_features", action="store_true",
                   default=False,
                   help="append on-device sum-product posteriors and the "
                        "BP convergence flag to the node features")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 compute policy (f32 params/stats)")
    p.add_argument("--mesh", type=str, default="",
                   help="DPxTP mesh of the ranks torchrun starts (e.g. 2x1, "
                        "1x2, or 'auto'); empty = one process")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if not args.train:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s [%(levelname)s] %(message)s")
        log.info("%s", args)
        evaluate(args, device=dev)
        return
    with mesh_group(args, dev) as dev:
        # under a mesh rank 0 alone makes the run's directory and writes
        main_rank = not args.mesh or dist.get_rank() == 0
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        work = os.path.join(
            args.work_dir, f"ldpc_{args.model_name}_snr_{args.snr}_at_{stamp}")
        if main_rank:
            init_logger(os.path.join(work, "logs"), "train", print_log=True)
        log.info("%s", args)
        model = init_weights(new_model(args), args.seed)
        with (MetricsWriter(os.path.join(work, "tf_logs")) if main_rank
              else contextlib.nullcontext()) as writer:
            train(args, model, writer, work, device=dev)


if __name__ == "__main__":
    main()
