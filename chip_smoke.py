#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100
    python3 chip_smoke.py --unrounded   # the bf16 checks' readings, then
                                 # those of kernels without the bf16 roundings
                                 # (rnd<TH> and the packed mul_rnd2)

Phases, one JSON line each:

  device           the card (nvidia-smi name and power limit); TF32 off
  build            nvcc builds every kernel of the port from csrc/, one
                   process per source, all started together
  kernel_check     the forward kernel against its plain PyTorch version on
                   the card, at the LDPC shapes and two ragged ones, all
                   four aggregators; kernel (with and without the argmax),
                   plain and bound times at each LDPC shape
  norm_act         the norm kernels (ops/norm_act.py) at a decode batch of
                   4096 words: bn_act_kernel on (4096 * 96, 256) with leaky
                   ReLU, bit-equal to the plain path on the card, and
                   in_act_kernel on (4096, 96, 256) with ReLU, within
                   KERNEL_TOL of it; each timed with its bound (bytes over
                   3.35 TB/s) and the plain path's time
  code_attention   ECCT's masked attention (ops/code_attention.py) at the
                   cell's batch: 4096 words, 8 heads of 16, 144 tokens, q,
                   k, v and dO as the model's views of (B, 144, 128) maps;
                   the forward and backward kernels against the plain route
                   on the card (out and the gradients of q, k, v within
                   ATTENTION_REL_L2) and both against the plain route in
                   f64; each kernel timed behind the spin kernel beside its
                   byte floor, the plain route's forward and backward, and
                   torch's memory-efficient attention as ``library_ms``
                   (a yardstick only: the port never calls it); then an
                   ECCT train step at the reference width: 6 forward and 6
                   backward launches, no plain call
  kernel_check_bwd both routes of the backward (the staged kernel with its
                   planned slab, and the kept kernels) against the plain
                   version, fed the same cotangent and argmax, at the same
                   shapes and aggregators, and the kept route at a graph too
                   wide to stage; two launches must give the same bits; at
                   each LDPC shape the two routes timed in turns (kept,
                   staged, staged, kept), the plain and bound times, and
                   every slab the staged kernel takes there (each checked)
  decode           the LDPC decoder at the reference width (seeded random
                   weights) through ``train.ldpc.evaluate`` with the decode
                   CLI's defaults: it writes the missing 3840-word eval grid
                   with the sum-product baseline (the host C++ decoder, no
                   numpy fallback), then decodes it in 15 batches of 256;
                   every kernel of the path must have run there, and no
                   plain version; the grid equal, array for array, to the
                   one the port's writer CLI gives on the CPU, its
                   sum-product matrix non-zero and printed; the host
                   decoder's seconds; words/s on the written grid
  decode_vs_cpu    one batch through the same weights on the port's CPU path
  bp_decode        ``ops.bp.bp_decode_batch`` on the card over the grid's
                   3840 words, 100 loops, with the posterior, in one call,
                   against the port's CPU path on the same bias: decisions
                   and iterations equal on every word both solve, at most
                   BP_ONE_SIDED of the words solved by one side only (each
                   printed with its smallest |q1 - 0.5|), two card runs
                   bit-equal; words/s, ms and kernels per call, and the
                   card's per-cell BER beside the host decoder's matrix
  train            ``train.ldpc.train`` at the reference width: one epoch of
                   TRAIN_STEPS steps at B=256, seeded random init; every
                   step launches the forward and the staged backward, and
                   neither the kept backward nor a plain version; finite
                   logged losses and a checkpoint; the step time on one
                   staged batch
  train_vs_cpu     one train step from the same weights and batch on the
                   card and on the port's CPU path: losses and gradients
  train_bp_features  ``train.ldpc.train`` with ``--bp-features`` (the
                   50-loop sum-product decode on the card inside each step),
                   TRAIN_STEPS steps at B=256 from a seeded init, then
                   ``evaluate --bp-features`` on the decode grid: the same
                   kernel launches per step as ``train`` and per batch as
                   ``decode``, no plain version, finite losses, a
                   checkpoint; the step time beside ``train``'s
  train_bp_features_vs_cpu  ``train_vs_cpu`` with ``--bp-features``, from the
                   weights BP_WARM_STEPS card steps leave
  kernel_check_ext both routes of the DIFF/NEIGHBOR forward (the staged
                   kernel with its planned slab, and the kept kernel)
                   against the plain version at the synthetic models'
                   shapes (B=32) and a ragged one, all four aggregators,
                   max with and without the argmax; max's out and argmax
                   bit-equal between the routes, two launches bit-equal,
                   and an all-ties case; at each path shape the two routes
                   timed in turns (kept, staged, staged, kept), the plain
                   and bound times, and every slab the staged kernel takes
                   there (each checked)
  kernel_check_ext_bwd  the same for the backward's DIFF/NEIGHBOR mode,
                   timed at each path shape
  syn_train        ``train.synthetic.train_and_eval("hop", ...)`` at the
                   reference width: one epoch of 20 steps at B=32 and an
                   eval of 4 batches, seeded random init; every step
                   launches the staged extension forward and backward 12
                   times, and neither kept route nor a plain version;
                   finite losses, a checkpoint, accuracies in [0, 1]; the
                   step time on one staged batch
  syn_train_vs_cpu one hop train step from the same weights (after
                   SYN_WARM_STEPS steps on the card) and batch on the card,
                   on the port's CPU path and in f64 on the CPU, from each
                   seed pair of SYN_VS_CPU_SEEDS: every ReLU and max
                   decision an f32 run takes otherwise than f64 lies at
                   its kink, each f32 run's gradients against f64 on those
                   flipped decisions, the card's against the CPU's on the
                   card's decisions, and their spread
  syn_fixed        ``train_and_eval("fixed", ...)`` (mp_nn), 5 steps at
                   B=32 and one eval batch: the NEIGHBOR mode on a path
  syn_workers      ``train_and_eval("hop", ...)`` with the default
                   ``--workers`` (a spawned pool: this process holds CUDA)
                   and with ``--workers 0``, 20 steps each: the pool's first
                   3 batches bit-equal to a PoolBatcher built here with the
                   same seed, ``device_prefetch``'s staged batches bit-equal
                   to batches staged inline; samples/s of both runs
  syn_train_path   ``python -m fgnn_tpu_torch.data.generate rpgm`` writes 640
                   hop samples; 20 steps and a 4-batch eval from them
                   (``--train-path``, ``--test-path``)
  syn_coo          the hop trainer over flat disjoint unions (the COO IR,
                   PyTorch ops): ``train_and_eval("hop", ...)`` with ``--coo
                   --mixed-lengths 24,30,36`` at the reference width, 10
                   steps at B=32 and 2 eval batches (inline synthesis, as
                   the ragged modes force); no typed-mp kernel and no plain
                   version; finite losses, samples/s, accuracies; the COO
                   step on a staged batch (ms, kernels per step, device
                   busy, peak memory); then 6 steps with ``--length-dist
                   0.5,0.3,0.2`` (the buckets each step saw) and 5 with
                   ``--bf16``, finite losses
  syn_coo_vs_dense at uniform length 30 (``--coo``), B=32, from the weights
                   SYN_WARM_STEPS dense card steps leave, the COO and dense
                   hop models on one state dict: logits within
                   COO_LOGITS_TOL of the largest (train and eval mode),
                   losses within LOSS_RTOL; two COO steps bit-equal (loss,
                   every gradient, the running statistics); the COO and
                   dense steps timed in turns (dense, COO, COO, dense),
                   kernels and device busy per step; then at each seed
                   pair of SYN_VS_CPU_SEEDS the card's COO step against
                   the port's CPU COO step and f64 as syn_train_vs_cpu
                   holds the dense step (a ``syn_coo_vs_cpu`` line each;
                   a COO max's decision is its set of edges at the max,
                   among which amax splits the gradient), the readings
                   by seed and the worst
  jax_checkpoint   the JAX package's checkpoints: the committed fixture
                   (``fgnn_tpu_torch/testdata/``, LDPC and a hop model in
                   both optimizer layouts, written by the JAX trainers)
                   read through ``read_checkpoint`` on the card, eval
                   logits within JAX_LOGITS_TOL of JAX's and one step of
                   the restored Adam within JAX_STEP_TOL of optax's; then
                   the reference-width decoder after JAX_WARM_STEPS card
                   steps written as a JAX payload in each layout
                   (``jax_payload``, the leaf map inverted) and restored
                   through ``restore_jax_payload`` into a fresh model and
                   Adam: ``evaluate`` over the decode grid gives the same
                   BER matrix, logits and one more step bit-equal, through
                   the typed-mp kernels and no plain version
  kernel_check_bf16     the bf16 mode of the NO_EXTENSION forward (the
                   sample route and the kept kernel, slab=0) and of the
                   staged backward (packed products and the kept scalar
                   ones, packed=False) against their plain versions at the
                   LDPC and ragged shapes, all four aggregators (out within
                   one bf16 ulp, out, dh and d_etype within
                   BF16_KERNEL_REL_L2, the readings emitted), each new
                   route bit-equal to its kept route wherever the plan
                   takes it (the forward's sample route at the LDPC
                   shapes; the packed products for max, sum and mean at
                   C % 4 == 0), each launch counted under the route that
                   ran, two launches bit-equal, an all-ties case; at each
                   LDPC shape the f32 instantiation and both bf16 routes
                   timed in turns (f32, kept, new, new, kept, f32), the
                   bf16 plain and bound times and GB/s, and every bf16
                   slab of the backward (each checked); the sums per bf16
                   forward and per bf16 LDPC step; both new routes against
                   the kept ones at the smaller batches of BATCH_SWEEP
  kernel_check_ext_bf16 the same for the DIFF/NEIGHBOR mode's bf16 routes
                   (EXT_BF16_FWD_ROUTES, EXT_BF16_BWD_ROUTES): the bf16
                   designs, the kept staged routes (kept=True), the first
                   forward kernel (slab=0) and the scalar products
                   (packed=False), each launch counted under its route; max
                   bit-equal across the forward's three routes, dh across
                   the backward's for max, sum and mean; at the path shapes
                   f32, kept and design timed in turns (f32, kept, new,
                   new, kept, f32) with every slab of the designs, bound
                   and GB/s, and the sums per bf16 hop step
  decode_bf16      ``evaluate`` with ``--bf16`` on the decode phase's
                   weights and grid: 15 of the 16 launches per batch in the
                   bf16 mode (layer 6's v2f conv gets an f32 x), all on the
                   sample route, none on the kept kernel, no plain
                   version; words/s; the bf16 logits within
                   DECODE_BF16_REL_L2 of the f32 logits
  train_bf16       20 LDPC steps (``train.ldpc.train``) and 20 hop steps
                   with 4 eval batches (``train_and_eval``) with ``--bf16``:
                   finite losses, the bf16 launches per step the CPU
                   dtype-flow test implies (LDPC 15 forward and 14
                   backward, hop 12 and 12), all on the new routes and
                   none on the kept ones: the hop step's 12 forwards on the
                   staged forward's bf16 design, its 10 max backwards on
                   ext_bwd_kernel and its 2 softmax backwards on the staged
                   kernel in tiles of rows; f32 parameters; step times

  mesh_nccl_1      ``train.ldpc.train --mesh 1x1`` through NCCL at world
                   size 1 (one rank spawned by ``parallel.launch.run_ranks``),
                   MESH_STEPS steps at B=256 from ``train``'s seeded init,
                   and the same run unmeshed in that rank: losses,
                   parameters and running statistics bit-equal; 16 forward
                   and 15 backward launches a step
  mesh_dp          2 ranks on cuda:0 over gloo (NCCL takes one card per
                   rank), ``--mesh 2x1`` and ``--mesh 1x2`` at the reference
                   width, global B=256, MESH_STEPS steps each, against the
                   unmeshed run of ``mesh_nccl_1``: each step's loss within
                   LOSS_RTOL of one process's on the same weights and
                   batch, the trajectories within LOSS_RTOL over
                   MESH_TRAJECTORY_STEPS steps (printed beyond), first-step
                   gradients within GRAD_REL_L2 (``train_vs_cpu``'s rule),
                   on each rank 16 forward and 15 backward launches a step
                   and no plain version; step ms
                   per rank, the collectives of one step replayed alone
                   (gloo's host staging on one card, not NVLink), the
                   shards each rank holds under 1x2
  mesh_halo        2 ranks over gloo: the halo conv (``parallel.halo``) of
                   the decoder's v2f conv at full width over 1024 words as
                   one flat graph, max and softmax, against
                   ``typed_mp_conv_coo`` on one rank (out, x and filter
                   gradients at tests/test_halo.py's tolerances), and the
                   edge-partitioned conv's forward for the four
                   aggregators; H, comm_rows_per_device, ms of each conv
  mesh_cards       where the machine has 2 cards or more, mesh_dp's check
                   through NCCL, one rank per card: ``--mesh {n}x1``, n =
                   min(count, 4), and ``2x2`` at four; on one card it
                   prints the count and that it did not run
  joint            FactorMPNN (the synthetic widths, the JAX defaults) on a
                   ContinuousCodesJoint batch of 256 over the joint
                   [96 ; 48] table (N = Nd = 144, K = 6, T = 2): the eval
                   forward against the CPU on the same weights
                   (``decode_vs_cpu``'s rule), one train-mode forward and
                   backward counted from 0 (6 DIFF/NEIGHBOR launches each
                   way on the staged routes, nothing else), every conv's h,
                   table and etype of that run through both kernels and
                   their plain versions in f32 and bf16; forward and step
                   ms; each joint kernel shape by ``device_ms`` beside its
                   bound, in both dtypes
  entry            ``fgnn_tpu_torch.entry.entry()`` on cuda:0: 16 forward
                   launches, outputs against ``entry(device="cpu")``; ms
                   per call
  dryrun           ``dryrun_multichip(1)`` over NCCL and ``(4,
                   backend="gloo")``, four ranks sharing cuda:0 on a 2x2
                   mesh: the printed line's numbers finite, on every rank
                   16 forward and 15 backward launches, each loss within
                   LOSS_RTOL of one process's step on the same weights and
                   batch; with 2 cards or more ``dryrun_multichip(cards)``
                   over NCCL
  utils            ``nan_debug`` on the card (a NaN planted in the input, a
                   NaN that only a kernel writes, a NaN cotangent: each
                   raises; the clean forward passes with 16 launches),
                   ``check_finite``, ``device_memory_stats``, ``trace``
                   with an ``annotate`` range

The phases that train the synthetic workloads without naming
``--workers`` pass ``--workers 0``: inline synthesis, as they ran before the
pool was ported.  Then the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}`` line.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before any phase.
"""

import contextlib
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from argparse import Namespace

# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): HBM3 rate and
# float32 outside the tensor cores, the rate this kernel's FMAs run at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# (name, B, N_src, Nd, K, T, C, launches per decode forward, backward
# launches per train step): the LDPC type-0 convs at B=256 (C=128 in layer
# 2, C=64 in the other seven), and ragged shapes (C=30 takes the scalar
# path).  A train step runs the 16 forwards and 15 backwards: the last
# layer's v2f conv feeds no loss, so autograd skips its backward.
SHAPES = [
    ("f2v_c64", 256, 48, 96, 3, 4, 64, 7, 7),
    ("f2v_c128", 256, 48, 96, 3, 4, 128, 1, 1),
    ("v2f_c64", 256, 96, 48, 6, 4, 64, 7, 6),
    ("v2f_c128", 256, 96, 48, 6, 4, 128, 1, 1),
    ("ragged_c24", 5, 136, 8, 5, 3, 24, 0, 0),
    ("ragged_c30", 3, 17, 11, 2, 1, 30, 0, 0),
]
AGGS = ("max", "sum", "mean", "softmax")
FWD_PER_STEP = sum(s[7] for s in SHAPES)   # 16
BWD_PER_STEP = sum(s[8] for s in SHAPES)   # 15
EDGES_PER_WORD = (96 * 3 + 48 * 6 + 96 + 96) * 8  # 6144, as bench.py
EVAL_PER_CELL = 128
BATCH = 256
TRAIN_STEPS = 20
# the norms of one LDPC decode forward, each one launch of the norm
# kernels (ops/norm_act.py): 83 eval BatchNorms and 25 instance norms
NORMS_PER_FORWARD = 108
# the norm kernels timed at a decode batch of 4096 words: a BatchNorm over
# the variables' 256 channels with its leaky ReLU, and an instance norm
# of the same (B, N, C) with its ReLU
NORM_ACT_WORDS = 4096
# ECCT's attention at the ECCT cell's shape, and the card's kernels against
# the plain route: f32 round-off of two summation orders (SDPA's
# memory-efficient kernels read 1.2e-7 to 4.2e-7 from f64 at this shape)
ATTENTION_WORDS, ATTENTION_HEADS, ATTENTION_TOKENS, ATTENTION_DH = \
    4096, 8, 144, 16
ATTENTION_REL_L2 = 2e-6
# Kernel against plain version on the card: the same f32 arithmetic in
# another order (fmaf, sums over c and over in-edges), so 1e-5 of the
# largest reference value.
KERNEL_TOL = 1e-5
# Train step, card against CPU: cuBLAS and the CPU sum in other orders, and
# a near-tie in max can route one element's cotangent to another k; both
# grow through the 8 layers down to the edge MLPs.  So the loss to 1e-4 of
# itself, and each gradient tensor to 3e-3 relative L2 error: on an H100
# the worst of 192 tensors read 1.4e-3 and 14 read above 1e-3, all of them
# in the first layers and the edge MLPs.  Gradients that are zero in exact
# arithmetic (a bias before a norm)
# are rounding noise on both sides: a tensor whose largest element is under
# 100x GRAD_FLOOR of the model's largest gradient is held, element by
# element, to GRAD_FLOOR of that largest gradient instead.
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 3e-3
GRAD_FLOOR = 1e-5

# The synthetic paths (train.synthetic) at the reference width, B=32, chain
# length 30: the hop model runs its 12 convs on the joint [30 vars ; 30
# factors] graphs, 5 DIFF max convs (C=64) and 1 DIFF softmax conv (C=2) on
# each of the pw table (60, 2) and the hop table (60, 9); the fixed model
# (mp_nn) runs 1 NEIGHBOR softmax conv and 5 DIFF max convs on the chain
# table (30, 8), C=64.  All with T=16.  (name, B, N = Nd, K, T, C, the
# path's aggregator, forward = backward launches per step of the hop model,
# of the fixed model); a ragged shape on the scalar path.  Each step
# launches the forward with the argmax for every max conv: 10 of 12 (hop),
# 5 of 6 (fixed).
SYN_BATCH = 32
EXT_SHAPES = [
    ("hop_pw_c64", 32, 60, 2, 16, 64, "max", 5, 0),
    ("hop_high_c64", 32, 60, 9, 16, 64, "max", 5, 0),
    ("hop_pw_c2", 32, 60, 2, 16, 2, "softmax", 1, 0),
    ("hop_high_c2", 32, 60, 9, 16, 2, "softmax", 1, 0),
    ("fixed_nbr_c64", 32, 30, 8, 16, 64, "softmax", 0, 1),
    ("fixed_diff_c64", 32, 30, 8, 16, 64, "max", 0, 5),
    ("ragged_c6", 3, 13, 3, 5, 6, None, 0, 0),
]
HOP_PER_STEP = sum(s[7] for s in EXT_SHAPES)     # 12
# of them the backwards that the bf16 mode's design runs on ext_bwd_kernel:
# the max convs (C=64); the softmax convs (f32 dm, C=2) run the staged
# kernel in tiles of rows
HOP_EXT_PER_STEP = sum(s[7] for s in EXT_SHAPES if s[6] == "max")  # 10
# the two routes of the backward and of the extension forward: the staged
# kernel with the slab that fused_mp.bwd_slab (fwd_slab) plans, and the
# kept kernels of the first port (slab 0);
# and a graph too wide for any slab of h in shared memory, which the plan
# sends to the kept kernels (name, B, N_src, Nd, K, T, C)
ROUTES = (("staged", None), ("kept", 0))
KEPT_SHAPE = ("wide_n", 2, 4096, 64, 3, 4, 64)
FIXED_PER_STEP = sum(s[8] for s in EXT_SHAPES)   # 6
SYN_STEPS = 20
SYN_EVAL_BATCHES = 4
FIXED_STEPS = 5
# The hop model's gradient at a random init is ill-conditioned: max
# near-ties between factors with the same features flip the first-win
# argmax, and with it the routing of the cotangent, under rounding, and
# BatchNorm channels that are nearly constant over the batch amplify
# rounding.  There the CPU's own f32 gradients lie up to 0.8% (relative L2)
# from an f64 run, and moving the node features by one ulp moves them by up
# to 2.2%.  After SYN_WARM_STEPS train steps the same f32 paths lie within
# 1e-4 of f64 on every tensor.  So the hop step is compared from the weights
# those steps leave, each gradient tensor on the card and on the CPU held to
# GRAD_REL_L2 of an f64 run, as the LDPC step is.
SYN_WARM_STEPS = 10
# Even there the step is piecewise smooth: among the millions of ReLU,
# leaky ReLU and max decisions of a hop step a few sit so near their kink
# (an activation near 0, two messages near a tie) that f32 rounding takes
# one branch and f64 the other, and the gradients of every layer below move
# with it: at one of four seed pairs the card and the CPU alike lay 6.4e-3
# from f64 on one tensor (PERF.md), and the card, rounding in other
# orders, flips other decisions than the CPU.  So the f64 run records its
# own decisions, and every decision an f32 run takes otherwise must lie at
# its kink: within KINK_TOL of the largest magnitude of its input (the
# pre-activation, or the gap from the top message to the message taken).
# Each f32 run is then held to an f64 run that flips those decisions, and
# only those (``_branches``, ``_flips``): the same piece of the function,
# where only rounding separates the two.  A wrong argmax where the gap is
# clear fails the kink check.
KINK_TOL = 1e-5
# (data seed, init seed) of each syn_train_vs_cpu reading: the spread over
# seeds says how much headroom the 3e-3 limit has
SYN_VS_CPU_SEEDS = ((3, 2), (11, 12), (21, 22), (31, 32))

# The sum-product decoder on the card (ops/bp.py): the host decoder's 100
# loops over the decode grid.  The card and the CPU multiply and divide in
# the same order with IEEE rounding, so the only differences are a library's
# ulps; a word that one side solves and the other does not sits at a
# decision boundary (|q1 - 0.5| near 0), and at most BP_ONE_SIDED of the
# words may.
BP_LOOPS = 100
BP_ONE_SIDED = 0.01
# train_bp_features_vs_cpu compares from the weights this many card steps
# leave.  At the seeded init the step is ill-conditioned (near ties in max
# flip under rounding): with the features the card and the CPU each lay
# 6.4e-3 to 6.7e-3 relative L2 from an f64 run on the CPU, and 4.3e-3 from
# each other; after 10 steps 4.8e-4 from f64 and 5.5e-5 from each other
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6, PR 7).
BP_WARM_STEPS = 10
# syn_train_path: the hop samples the writer CLI writes (20 steps of 32)
SYN_PATH_SAMPLES = 640
# The COO path (--coo, ROADMAP item 5): the hop trainer over flat disjoint
# unions.  With --mixed-lengths 24,30,36 at B=32 each batch is 32
# composite samples of three chains (COO_WIDTH nodes each): 2880
# variables, 2880 factors of each type, 11520 pairwise and 51840 hop
# edges.  The JAX package runs these ops as jax.ops.segment_* (no Pallas
# kernel), and so does the port with PyTorch ops: no typed-mp kernel may
# run on this path.  10 steps and 2 eval batches, then 6 steps with
# --length-dist and 5 with --bf16.
COO_LENGTHS = "24,30,36"
COO_WIDTH = sum(int(x) for x in COO_LENGTHS.split(","))   # 90
COO_DIST = "0.5,0.3,0.2"
COO_STEPS = 10
COO_EVAL_BATCHES = 2
COO_BUCKET_STEPS = 6
COO_BF16_STEPS = 5
# COO against dense logits on one state dict at uniform length: the same
# f32 arithmetic in other orders (segment sums against the kernels'), so
# 1e-4 of the largest logit, as the CPU tests hold the JAX pair
COO_LOGITS_TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
# The JAX package's checkpoints (jax_checkpoint): the committed fixture,
# written by tests/test_torch_jax_ckpt.py's write_fixture from the JAX
# trainers at these widths (one layer; the fixed 64-wide bottlenecks and
# 128-wide regressor keep a checkpoint near 0.8 MB): LDPC, and a hop model
# with the synthetic trainers' clip chain, each after 2 steps with the
# optimizer in each layout, with each one's eval batch, logits, a gradient
# tree and the params after one optax step on it.  The card's logits against JAX's to
# JAX_LOGITS_TOL (f32 in other orders, as the CPU tests hold the models);
# the restored Adam's step against optax's to JAX_STEP_TOL (one update of
# at most lr per element, as tests/test_torch_train.py holds the optimizer).
JAX_FIXTURE_DIR = os.path.join("fgnn_tpu_torch", "testdata")
JAX_FIXTURE = "jax_fixture.npz"
JAX_FIXTURE_LDPC = {"dim_mapping_list": (8, 8), "skip_link": {}}
JAX_FIXTURE_HOP = {"chain_length": 12, "hop_order": 5, "dims": (8, 2)}
JAX_LOGITS_TOL = 1e-4
JAX_STEP_TOL = 1e-6
# the full-width round trip: this many card train steps from a seeded
# reference-width decoder before its payload is written
JAX_WARM_STEPS = 10
# every leaf name of a flax tree the port's models carry
FLAX_LEAVES = ("kernel", "bias", "scale", "mean", "var", "filters")

# The bf16 compute policy (--bf16).  Every conv whose x is bf16 runs the
# kernels' bf16 mode.  Of the 16 type-0 convs of an LDPC forward, 15 get a
# bf16 x; layer 6's v2f conv (v2f_c64) gets an f32 x, since the skip link
# from layer 2 adds the global-factor conv's f32 output, and runs the f32
# mode; autograd skips layer 7's v2f backward (bf16).  Every conv of a hop
# step gets a bf16 x.  tests/test_torch_bf16.py::
# test_path_convs_take_the_bf16_mode_where_jax_does holds that dtype flow
# against the JAX package's on the CPU.  bf16 launches per forward (decode)
# and per train step, by LDPC shape:
BF16_FWD = {"f2v_c64": 7, "f2v_c128": 1, "v2f_c64": 6, "v2f_c128": 1}
BF16_BWD = {"f2v_c64": 7, "f2v_c128": 1, "v2f_c64": 5, "v2f_c128": 1}
BF16_FWD_PER_STEP = sum(BF16_FWD.values())   # 15
BF16_BWD_PER_STEP = sum(BF16_BWD.values())   # 14
# Kernel against plain version in the bf16 mode: both round at the same
# places and sum in f32 in other orders, so out lies within one bf16 ulp of
# the plain value per element plus KERNEL_TOL of the largest (values that
# cancel to near zero), and each of out, dh and d_etype within
# BF16_KERNEL_REL_L2 relative L2 of the plain version: above the largest
# reading of the sound kernels and below what kernels without the bf16
# mode's roundings of etype, of each backward product and of g/K read
# (``python3 chip_smoke.py --unrounded`` measures both; PERF.md section 2).
# On the H100 the sound kernels read at most 1.73e-4 (dh), the unrounded
# ones at least 1.58e-3 (d_etype), 2.91e-3 (dh), 1.95e-3 (out).
BF16_KERNEL_REL_L2 = 5e-4
# every relative L2 reading of those checks in this run, by quantity; the
# failed checks under --unrounded (None: a failed check raises)
BF16_READINGS = {"out": [], "dh": [], "d_etype": []}
BF16_FAILED = None
# The bf16 decode's logits against the f32 decode of the same weights: bf16
# keeps 8 significant bits (2^-9 of relative rounding a value) through the
# 8 layers; 5e-2 relative L2 allows about 25 such roundings in a row.
DECODE_BF16_REL_L2 = 5e-2


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, n, torch):
    """Mean time of ``fn`` over n calls on the card's clock, after a
    warm-up; host gaps between the calls count (wall time per call)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n, torch):
    """(device ms, host ms) per call of ``fn`` over n calls, after a warm-up.

    A call that takes the host longer than the card would leave the card
    waiting between calls, and the events would time the host.  So the n
    calls are queued behind a spin kernel that outlasts their host time,
    and the start event must still be pending once all are queued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for tries in range(4):
        torch.cuda._sleep(int(host_s * 4e9 * 2 ** tries))  # <= 2 GHz clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / n, host_s * 1e3 / n
    raise RuntimeError("could not queue the timed calls ahead of the card")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)


def phase_build(fused_mp):
    from fgnn_tpu_torch.data import ldpc_cpp

    t0 = time.perf_counter()
    built = fused_mp.build(force=True)
    seconds = time.perf_counter() - t0
    # the host sum-product decoder (g++), which the decode grid requires
    t0 = time.perf_counter()
    ldpc_cpp.get_lib()
    host = dict(seconds=time.perf_counter() - t0,
                library=os.path.relpath(ldpc_cpp._SO_PATH))
    require(sorted(built) == sorted(fused_mp.KERNELS), "every kernel built")
    libs = {}
    for name, (secs, log) in built.items():
        lines = [ln.strip() for ln in log.splitlines()]
        # the entry functions that spill, each with its ptxas lines
        spilling, kernel = {}, None
        for ln in lines:
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif re.search(r"\b[1-9]\d* bytes spill stores", ln):
                spilling[kernel] = ln
        libs[name] = dict(
            seconds=secs, library=os.path.relpath(fused_mp.library(name)),
            ptxas=[ln for ln in lines if "registers" in ln or "spill" in ln],
            spilling=spilling)
    emit("build", seconds=seconds, libraries=libs, host_decoder=host)


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def bound_by(nbytes, ops):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations")


def _inputs(torch, B, N, Nd, K, T, C, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(B, N, T, C, device="cuda", generator=g)
    idx = torch.randint(0, N, (Nd, K), device="cuda", generator=g,
                        dtype=torch.int32)
    et = torch.randn(B, Nd, K, T, device="cuda", generator=g)
    return h, idx, et


def phase_kernel_check(torch, fused_mp):
    worst = 0.0
    shapes = []
    for si, (name, B, N, Nd, K, T, C, per_fwd, _) in enumerate(SHAPES):
        h, idx, et = _inputs(torch, B, N, Nd, K, T, C, si)
        for agg in AGGS:
            want = agg == "max"
            got = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, want)
            ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0,
                                                      want)
            torch.cuda.synchronize()
            out, ref_out = (got[0], ref[0]) if want else (got, ref)
            require(torch.isfinite(out).all().item(), f"{name} {agg} finite")
            err = (out - ref_out).abs().max().item()
            scale = ref_out.abs().max().item()
            require(err <= KERNEL_TOL * scale,
                    f"{name} {agg}: max_abs_err {err} > {KERNEL_TOL} * "
                    f"{scale}")
            worst = max(worst, err)
            if want:
                msgs = (h[:, idx.long()] * et[..., None]).sum(dim=3)
                top2 = msgs.topk(2, dim=2).values if K > 1 else None
                clear = (torch.ones_like(out, dtype=torch.bool) if K == 1
                         else (top2[:, :, 0] - top2[:, :, 1])
                         > 1e-5 * top2[:, :, 0].abs())
                agree = (got[1] == ref[1])[clear].all().item()
                require(agree, f"{name}: argmax differs where the gap is "
                               "clear")
        if per_fwd == 0:
            continue
        # the decode path's call: max, no argmax
        t_kernel, host_kernel = device_ms(
            lambda: fused_mp.typed_gather_mix_agg(h, idx, et, "max"), 200,
            torch)
        t_plain, _ = device_ms(lambda: fused_mp.typed_gather_mix_agg_plain(
            h, idx, et, "max"), 20, torch)
        # the train path's call: max with the argmax
        t_argmax, _ = device_ms(
            lambda: fused_mp.typed_gather_mix_agg(h, idx, et, "max", 3.0,
                                                  True), 200, torch)
        t_plain_argmax, _ = device_ms(
            lambda: fused_mp.typed_gather_mix_agg_plain(h, idx, et, "max",
                                                        3.0, True), 20, torch)
        nbytes = 4 * (h.numel() + idx.numel() + et.numel() + B * Nd * C)
        ops = B * Nd * K * C * (2 * T + 1)
        nbytes_argmax = nbytes + B * Nd * C
        shapes.append(dict(
            name=name, B=B, N_src=N, Nd=Nd, K=K, T=T, C=C,
            launches_per_forward=per_fwd, ms=t_kernel, plain_ms=t_plain,
            wrapper_host_ms=host_kernel, bound_ms=bound_ms(nbytes, ops),
            bytes=nbytes, ops=ops, bound_by=bound_by(nbytes, ops),
            gbytes_per_s=nbytes / t_kernel / 1e6,
            ms_argmax=t_argmax, plain_ms_argmax=t_plain_argmax,
            bound_ms_argmax=bound_ms(nbytes_argmax, ops),
            bytes_argmax=nbytes_argmax,
            gbytes_per_s_argmax=nbytes_argmax / t_argmax / 1e6))
        emit("kernel_check", **shapes[-1], max_abs_err=worst)

    # all ties: every k slot equal, so the first-win argmax is 0 everywhere
    B, N, Nd, K, T, C = 8, 16, 16, 3, 2, 16
    h = torch.randn(1, 1, T, C, device="cuda").expand(B, N, T, C)
    idx = torch.zeros(Nd, K, dtype=torch.int32, device="cuda")
    et = torch.ones(B, Nd, K, T, device="cuda")
    _, am = fused_mp.typed_gather_mix_agg(h.contiguous(), idx, et, "max",
                                          want_argmax=True)
    require(am.max().item() == 0, "all-ties argmax is 0")
    emit("kernel_check", name="all_ties", argmax_max=int(am.max().item()),
         max_abs_err=worst)
    return worst, shapes


def phase_norm_act(torch, fused_mp):
    """The norm kernels at a decode batch's size, each timed behind the
    spin kernel beside its bound (bytes: x read once, the result written
    once, over 3.35 TB/s) and the plain path on the card (the module's
    plain code, taken where a graph is recorded for the parameters):
    BatchNorm bit-equal, instance norm within KERNEL_TOL of the largest."""
    from fgnn_tpu_torch.models.norm import BatchNorm, instance_norm

    rows, N, C = NORM_ACT_WORDS * 96, 96, 256
    g = torch.Generator(device="cuda").manual_seed(17)
    bn = BatchNorm(C).cuda().eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.1, 0.1, generator=g)
        bn.running_mean.normal_(0.0, 0.3, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    x = torch.randn(rows, C, device="cuda", generator=g) * 2 + 0.3
    xin = x.view(NORM_ACT_WORDS, N, C)
    xin_graph = xin.detach().requires_grad_()

    def bn_kernel():
        with torch.no_grad():
            return bn(x, activation="leaky_relu")

    def bn_plain():
        return bn(x, activation="leaky_relu")

    def in_kernel():
        with torch.no_grad():
            return instance_norm(xin, activation="relu")

    def in_plain():
        return instance_norm(xin_graph, activation="relu")

    out = {}
    for name, kernel, plain in (("bn_act_kernel", bn_kernel, bn_plain),
                                ("in_act_kernel", in_kernel, in_plain)):
        fused_mp.reset_counts()
        got = kernel()
        require(fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 1,
                                             "plain_calls": 0},
                f"{name}: one launch")
        want = plain().detach()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if name == "bn_act_kernel":
            require(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)),
                    f"{name}: bit-equal to the plain path")
        require(err <= KERNEL_TOL * scale,
                f"{name}: max_abs_err {err} > {KERNEL_TOL} * {scale}")
        del got, want
        ms, host_ms = device_ms(kernel, 200, torch)
        plain_ms, _ = device_ms(plain, 20, torch)
        nbytes = 2 * 4 * x.numel()
        out[name] = dict(
            shape=[rows, C] if name == "bn_act_kernel" else [
                NORM_ACT_WORDS, N, C],
            activation="leaky_relu" if name == "bn_act_kernel" else "relu",
            ms=ms, plain_ms=plain_ms, wrapper_host_ms=host_ms,
            bound_ms=bound_ms(nbytes, 0), bytes=nbytes,
            gbytes_per_s=nbytes / ms / 1e6, max_abs_err=err)
        emit("norm_act", name=name, **out[name])
    return out


def phase_code_attention(torch, fused_mp):
    """ECCT's masked attention at the cell's batch on the card: the kernels
    checked against the plain route (f32 on the card and f64), each timed
    behind the spin kernel beside its byte floor (the forward reads q, k,
    v and writes out and the log-sum-exp; the backward reads q, k, v, o,
    dO and the log-sum-exp and writes dq, dk, dv), beside the plain
    route's time and torch's memory-efficient attention's (library_ms);
    then one ECCT train step's launches."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops import code_attention as ca
    from fgnn_tpu_torch.train import ecct as T

    B, H, L, dh = (ATTENTION_WORDS, ATTENTION_HEADS, ATTENTION_TOKENS,
                   ATTENTION_DH)
    mask = torch.as_tensor(code_mask(parity_check()), device="cuda")
    tables = ca.CodeTables(mask).to("cuda")
    pairs = tables.pairs
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, go = (torch.randn(B, L, H * dh, device="cuda", generator=g)
                   .view(B, L, H, dh).transpose(1, 2) for _ in range(4))

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def forward_and_grads(fn, dtype=None):
        qs = [t.detach().to(dtype or t.dtype).requires_grad_(True)
              for t in (q, k, v)]
        out = fn(*qs, mask)
        grads = torch.autograd.grad(out, qs, go.to(out.dtype))
        return [out.detach()] + list(grads)

    fused_mp.reset_counts()
    got = forward_and_grads(lambda *a: ca.code_attention(*a, tables))
    counts = dict(fused_mp.CODE_ATTENTION_COUNTS)
    require(counts == {"kernel_launches": 1, "bwd_launches": 1,
                       "plain_calls": 0}, f"one launch each: {counts}")
    require(all(t.stride() == q.stride() for t in got),
            "out, dq, dk, dv in q's memory order")
    plain = forward_and_grads(ca.plain_attention)
    names = ("out", "dq", "dk", "dv")
    vs_plain = {n: rel(a, b) for n, a, b in zip(names, got, plain)}
    require(all(x < ATTENTION_REL_L2 for x in vs_plain.values()),
            f"kernels against the plain route: {vs_plain}")
    f64 = forward_and_grads(ca.plain_attention, torch.float64)
    kernel_vs_f64 = {n: rel(a, b) for n, a, b in zip(names, got, f64)}
    plain_vs_f64 = {n: rel(a, b) for n, a, b in zip(names, plain, f64)}
    del got, plain, f64
    bits = ca.attention_fwd(q, k, v, tables)[0]
    require(torch.equal(bits, ca.attention_fwd(q, k, v, tables)[0]),
            "two forward launches give the same bits")
    del bits
    emit("code_attention", name="check", counts=counts,
         kernel_vs_plain=vs_plain, kernel_vs_f64=kernel_vs_f64,
         plain_vs_f64=plain_vs_f64, tol_rel_l2=ATTENTION_REL_L2)

    out, lse = ca.attention_fwd(q, k, v, tables)
    fwd_ms, fwd_host = device_ms(lambda: ca.attention_fwd(q, k, v, tables),
                                 50, torch)
    bwd_ms, bwd_host = device_ms(
        lambda: ca.attention_bwd(q, k, v, out, lse, go, tables), 50, torch)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain_out = ca.plain_attention(qg, kg, vg, mask)
    plain_fwd_ms, _ = device_ms(lambda: ca.plain_attention(q, k, v, mask), 5,
                                torch)
    plain_bwd_ms, _ = device_ms(lambda: torch.autograd.grad(
        plain_out, (qg, kg, vg), go, retain_graph=True), 5, torch)
    del plain_out
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        lib_fwd_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20, torch)
        lib_bwd_ms, _ = device_ms(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), go, retain_graph=True), 20, torch)
    del lib_out
    elems = B * H * L * dh
    fwd_bytes = 4 * (4 * elems + B * H * L)
    bwd_bytes = 4 * (8 * elems + B * H * L)
    # per allowed pair: the forward's 4 d multiply-adds and 5 softmax
    # operations, one division per output element; the backward's dp, dq,
    # dk and dv products and the recomputed score (10 d) and 5 more
    fwd_ops = B * H * (pairs * (4 * dh + 5) + L * dh)
    bwd_ops = B * H * pairs * (10 * dh + 5)
    rows = {}
    for name, ms, host, plain_ms, lib_ms, nbytes, ops in (
            ("code_attn_fwd_kernel", fwd_ms, fwd_host, plain_fwd_ms,
             lib_fwd_ms, fwd_bytes, fwd_ops),
            ("code_attn_bwd_kernel", bwd_ms, bwd_host, plain_bwd_ms,
             lib_bwd_ms, bwd_bytes, bwd_ops)):
        rows[name] = dict(
            shape=[B, H, L, dh], pairs=pairs, ms=ms, wrapper_host_ms=host,
            bound_ms=bound_ms(nbytes, ops), bound_by=bound_by(nbytes, ops),
            bytes=nbytes, ops=ops, gbytes_per_s=nbytes / ms / 1e6,
            roofline_share=bound_ms(nbytes, ops) / ms, plain_ms=plain_ms,
            library_ms=lib_ms, per="one call (6 a train step)")
        emit("code_attention", name=name, **rows[name])
    del out, lse, q, k, v, go, qg, kg, vg

    # an ECCT train step at the reference width
    from fgnn_tpu_torch.models import init_weights

    model = init_weights(T.new_model(), 5).cuda()
    opt = T.make_optimizer(model.parameters(), T.BASE_LR, weight_decay=0.0)
    batch = T.words(np.random.RandomState(4), 512, T.TRAIN_SNRS)
    fused_mp.reset_counts()
    m = T.train_step(model, opt, batch, "cuda")
    step_counts = dict(fused_mp.CODE_ATTENTION_COUNTS)
    require(step_counts == {"kernel_launches": 6, "bwd_launches": 6,
                            "plain_calls": 0},
            f"an ECCT step: 6 and 6 launches, no plain call: {step_counts}")
    require(bool(torch.isfinite(m["loss"])), "a finite ECCT loss")
    emit("code_attention", name="ecct_train_step", batch=512,
         counts=step_counts, loss=float(m["loss"]))
    return rows


def _route_counts(fused_mp, route, ext):
    if route == "kept":
        return (fused_mp.KEPT_EXT_BWD_COUNTS if ext
                else fused_mp.KEPT_BWD_COUNTS)
    return fused_mp.EXT_BWD_COUNTS if ext else fused_mp.BWD_COUNTS


def _check_bwd_routes(torch, fused_mp, what, bwd, ref, ext, routes):
    """``bwd(slab)`` on each (route, slab) of ``routes`` against ``ref``,
    the plain version's (dh, d_etype): each call launches that route once,
    two launches give the same bits, and each output lies within
    KERNEL_TOL of the plain version's.  Returns the worst error."""
    worst = 0.0
    for route, slab in routes:
        counts = _route_counts(fused_mp, route, ext)
        before = counts["kernel_launches"]
        first, second = bwd(slab), bwd(slab)
        torch.cuda.synchronize()
        require(counts["kernel_launches"] == before + 2,
                f"{what}: two launches of the {route} route")
        require(all(torch.equal(a, b) for a, b in zip(first, second)),
                f"{what} {route}: two launches give the same bits")
        for name, got, want in zip(("dh", "d_etype"), first, ref):
            worst = max(worst, _check_close(torch, got, want,
                                            f"{what} {route} {name}"))
    return worst


def _time_routes(torch, call, plain, slabs, check):
    """``call(slab)`` on both routes timed in turns (kept, staged, staged,
    kept), the plain version, and every slab of ``slabs``, each checked by
    ``check(result, slab)`` (which returns its error) first.  Returns
    (timings, worst error of the slabs)."""
    runs = [device_ms(lambda s=slab: call(s), 200, torch)
            for slab in (0, None, None, 0)]
    plain_ms, _ = device_ms(plain, 20, torch)
    worst, slab_ms = 0.0, {}
    for cs in slabs:
        got = call(cs)
        torch.cuda.synchronize()
        worst = max(worst, check(got, cs))
        slab_ms[cs] = device_ms(lambda s=cs: call(s), 200, torch)[0]
    ms = (runs[1][0] + runs[2][0]) / 2
    previous_ms = (runs[0][0] + runs[3][0]) / 2
    return dict(ms=ms, previous_ms=previous_ms,
                ms_in_turns=[r[0] for r in runs], wrapper_host_ms=runs[1][1],
                plain_ms=plain_ms, speedup=previous_ms / ms,
                slab_ms=slab_ms), worst


def _time_bwd_routes(torch, fused_mp, what, bwd, plain, ref, B, rows, Nd, K,
                     T, C, agg):
    """Both routes of the backward timed in turns, the plain version, and
    every slab the staged kernel takes at this shape, each checked against
    ``ref`` first (``_time_routes``)."""
    def check(got, cs):
        return max(_check_close(torch, a, b, f"{what} slab {cs} {name}")
                   for name, a, b in zip(("dh", "d_etype"), got, ref))

    timing, worst = _time_routes(
        torch, bwd, plain, fused_mp.staged_slabs(rows, Nd, K, T, C, agg),
        check)
    slab = fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg)
    return dict(**timing, slab=slab, slabs_per_sample=C // slab,
                slab_bytes=fused_mp.staged_bytes(rows, Nd, K, T, slab,
                                                 agg)), worst


def phase_kernel_check_bwd(torch, fused_mp):
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    worst = 0.0
    shapes = []
    for si, (name, B, N, Nd, K, T, C, _, per_step) in enumerate(
            SHAPES + [KEPT_SHAPE + (0, 0)]):
        h, idx, et = _inputs(torch, B, N, Nd, K, T, C, 100 + si)
        table = GatherTable(idx.cpu().numpy(), N).to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(200 + si)
        g = torch.randn(B, Nd, C, device="cuda", generator=gen)
        kernels = {}
        for agg in AGGS:
            plan = fused_mp.bwd_slab(B, N, Nd, K, T, C, agg)
            require((plan == 0) == (name == KEPT_SHAPE[0]),
                    f"{name} {agg}: the planned slab is {plan}")
            routes = ROUTES if plan else (("kept", None),)
            res = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0,
                                                agg == "max")
            out, am = res if agg == "max" else (res, None)

            def bwd(slab, agg=agg, am=am, out=out):
                return fused_mp.typed_gather_mix_agg_bwd(
                    g, h, idx, table.src_ptr, table.src_edge, et, agg, 3.0,
                    argmax=am, out=out, slab=slab)

            def plain(agg=agg, am=am, out=out):
                return fused_mp.typed_gather_mix_agg_bwd_plain(
                    g, h, idx, et, agg, 3.0, argmax=am, out=out)

            ref = plain()
            worst = max(worst, _check_bwd_routes(
                torch, fused_mp, f"{name} {agg}", bwd, ref, False, routes))
            kernels[agg] = (bwd, plain, ref)
        if per_step == 0:
            continue
        # the train path's call: max, with the forward's argmax
        timing, err = _time_bwd_routes(torch, fused_mp, name,
                                       *kernels["max"], B, N, Nd, K, T, C,
                                       "max")
        worst = max(worst, err)
        # read g, argmax, h, etype and both tables once; write dh, d_etype
        nbytes = (4 * B * Nd * C + B * Nd * C + 2 * 4 * h.numel()
                  + 2 * 4 * et.numel() + 4 * (2 * idx.numel() + N + 1))
        # dm (one select per edge and channel), then an FMA per (t, c) for
        # d_etype and another for dh
        ops = B * Nd * K * C * (4 * T + 1)
        shapes.append(dict(
            name=name, B=B, N_src=N, Nd=Nd, K=K, T=T, C=C,
            launches_per_step=per_step, **timing,
            bound_ms=bound_ms(nbytes, ops), bytes=nbytes, ops=ops,
            bound_by=bound_by(nbytes, ops),
            gbytes_per_s=nbytes / timing["ms"] / 1e6))
        emit("kernel_check_bwd", **shapes[-1], max_abs_err=worst)

    # all ties: every k slot equal; the whole cotangent goes to k = 0
    B, N, Nd, K, T, C = 8, 16, 16, 3, 2, 16
    h = torch.randn(1, 1, T, C, device="cuda").expand(B, N, T, C).contiguous()
    idx = torch.zeros(Nd, K, dtype=torch.int32, device="cuda")
    table = GatherTable(idx.cpu().numpy(), N).to("cuda")
    et = torch.ones(B, Nd, K, T, device="cuda")
    _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max", want_argmax=True)
    g = torch.randn(B, Nd, C, device="cuda")
    before = fused_mp.BWD_COUNTS["kernel_launches"]
    _, det = fused_mp.typed_gather_mix_agg_bwd(
        g, h, idx, table.src_ptr, table.src_edge, et, "max", argmax=am)
    require(fused_mp.BWD_COUNTS["kernel_launches"] == before + 1,
            "all ties: the staged route")
    require(not det[:, :, 1:].any().item() and det[:, :, 0].any().item(),
            "all ties: d_etype only at k = 0")
    emit("kernel_check_bwd", name="all_ties", max_abs_err=worst)
    return worst, shapes


def _count_decode(torch, fused_mp, evaluate, args, model, dev, n_batches):
    """``evaluate`` counted: (seconds, launch counts, ber_total, err)."""
    fused_mp.reset_counts()
    t0 = time.perf_counter()
    ber_total, err = evaluate(args, model, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fused_mp.COUNTS)
    require(counts["kernel_launches"] == 16 * n_batches,
            f"kernel_launches {counts['kernel_launches']} != 16 x "
            f"{n_batches}")
    require(counts["plain_calls"] == 0, "no plain calls on the card")
    norms = dict(fused_mp.NORM_ACT_COUNTS)
    require(norms == {"kernel_launches": NORMS_PER_FORWARD * n_batches,
                      "plain_calls": 0},
            f"every norm on its kernel, none plain: {norms}")
    require(0.0 <= ber_total <= 1.0 and err.shape == (5, 6),
            "BER in [0, 1], 5 x 6 matrix")
    return seconds, counts, ber_total, err


def _cell_error(x, gts, snr, sigma_b):
    """Info-bit error rate per (snr, sigma_b) cell of hard decisions."""
    import numpy as np

    err = np.zeros((5, 6))
    for i in range(5):
        for j in range(6):
            sel = (np.abs(snr - i) < 1e-3) & (sigma_b.astype(int) == j)
            err[i, j] = np.mean(x[sel, :48] != gts[sel, :48])
    return err


def phase_decode(torch, fused_mp, dev, tmp):
    import numpy as np

    from fgnn_tpu_torch.data import Codes, ContinuousCodesSP, ldpc_datasets
    from fgnn_tpu_torch.data.ldpc_channel import posteriors
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.ldpc import (
        decode_step,
        evaluate,
        model_inputs,
        parse_args,
    )

    path = os.path.join(tmp, "ldpc_eval.npz")
    model = init_weights(LDPCModel(), seed=0).to(dev).eval()
    # the decode CLI's defaults: --eval-bp-baseline writes the missing grid
    # with the sum-product matrix
    args = parse_args(["--test-path", path, "--eval-per-cell",
                       str(EVAL_PER_CELL), "--batch-size", str(BATCH)])
    require(args.eval_bp_baseline and not args.bp_features,
            "the decode CLI's defaults")
    n_batches = 30 * EVAL_PER_CELL // BATCH
    words = n_batches * BATCH

    # warm-up, then the counted run of the main path: the grid written,
    # then decoded
    decode_step(model, next(ContinuousCodesSP(length=BATCH, seed=9)
                            .batches(BATCH)), dev)
    torch.cuda.synchronize()
    for k in ldpc_datasets.BP_DECODED:
        ldpc_datasets.BP_DECODED[k] = 0
    grid_seconds, counts, _, _ = _count_decode(
        torch, fused_mp, evaluate, args, model, dev, n_batches)
    require(ldpc_datasets.BP_DECODED == {"cpp": 30 * EVAL_PER_CELL,
                                         "numpy": 0},
            f"the host C++ decoder wrote the baseline "
            f"({ldpc_datasets.BP_DECODED})")
    with np.load(path) as f:
        grid = dict(f)
    bp = grid["bp_err_matrix"]
    require(bp.shape == (5, 6) and bp.any(), "a non-zero sum-product matrix")

    # the port's writer CLI on the CPU, in a process without the card
    cli = os.path.join(tmp, "ldpc_cli.npz")
    subprocess.run(
        [sys.executable, "-m", "fgnn_tpu_torch.data.generate", "ldpc",
         "--n-per-cell", str(EVAL_PER_CELL), "--seed", "0", "--out", cli],
        cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        check=True, capture_output=True, text=True, timeout=600)
    with np.load(cli) as f:
        require(sorted(f.files) == sorted(grid), "the CLI grid's arrays")
        for k in f.files:
            require(f[k].dtype == grid[k].dtype
                    and np.array_equal(f[k], grid[k]),
                    f"grid {k}: the decode path's equals the CPU writer's")

    # the host decoder alone over the grid's stored words (f32; the writer
    # decoded the f64 words before it stored them, so its matrix may differ
    # in a few words)
    bias = np.stack([posteriors(y, s) for y, s in
                     zip(grid["noisy_sg"], grid["snr_dbs"])])
    t0 = time.perf_counter()
    host_x = ldpc_datasets.bp_decisions(bias)
    host_bp_seconds = time.perf_counter() - t0
    host_err = _cell_error(host_x, grid["gts"], grid["snr_dbs"],
                           grid["sigma_b"])
    print("sum-product baseline (host C++ decoder, 100 loops):")
    print(np.array_str(bp, precision=4, suppress_small=True), flush=True)

    # words/s on the written grid
    seconds, again, ber_total, err = _count_decode(
        torch, fused_mp, evaluate, args, model, dev, n_batches)
    first = next(Codes(path).batches(BATCH))
    inputs = model_inputs(model, first, dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(**inputs), 20, torch)
    emit("decode", words=words, batches=n_batches, batch_size=BATCH,
         seconds_with_grid=grid_seconds, host_bp_seconds=host_bp_seconds,
         host_bp_words_per_s=len(bias) / host_bp_seconds,
         host_bp_stored_words_max_diff=float(np.abs(host_err - bp).max()),
         bp_err_matrix=bp.tolist(), seconds=seconds,
         words_per_s=words / seconds,
         edges_per_s=words * EDGES_PER_WORD / seconds,
         forward_ms=fwd_ms, forward_words_per_s=BATCH / fwd_ms * 1e3,
         ber_total=float(ber_total), kernel_launches=counts["kernel_launches"],
         plain_calls=counts["plain_calls"])
    return model, first, counts, path


def phase_bp_decode(torch, dev, path):
    """The batched sum-product decoder on the card over the grid, against
    the port's CPU path on the same f32 bias."""
    import numpy as np

    from fgnn_tpu_torch.data import decode_graph
    from fgnn_tpu_torch.data.ldpc_channel import posteriors
    from fgnn_tpu_torch.ops.bp import BPGraphArrays, bp_decode_batch
    from fgnn_tpu_torch.utils.profiling import kernels_per_call

    with np.load(path) as f:
        grid = dict(f)
    bias = np.stack([posteriors(y, s) for y, s in
                     zip(grid["noisy_sg"], grid["snr_dbs"])]) \
        .astype(np.float32)
    words = len(bias)
    graph = BPGraphArrays.from_ref(decode_graph(), dev)
    on_card = torch.from_numpy(bias).to(dev)

    def call():
        return bp_decode_batch(graph, on_card, max_loops=BP_LOOPS,
                               return_posterior=True)

    first, second = call(), call()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, second)),
            "two card runs give the same bits")
    ms = cuda_ms(call, 3, torch)
    kernels, busy_ms = kernels_per_call(call)
    t0 = time.perf_counter()
    cpu = bp_decode_batch(BPGraphArrays.from_ref(decode_graph()),
                          torch.from_numpy(bias), max_loops=BP_LOOPS,
                          return_posterior=True)
    cpu_seconds = time.perf_counter() - t0
    gx, gok, git, gq = (t.cpu().numpy() for t in first)
    cx, cok, cit, cq = (t.numpy() for t in cpu)
    both = gok & cok
    require(np.array_equal(gx[both], cx[both])
            and np.array_equal(git[both], cit[both]),
            "decisions and iterations equal on every word both solve")
    one = np.flatnonzero(gok != cok)
    one_sided = [{"word": int(w), "card_solved": bool(gok[w]),
                  "card_iters": int(git[w]), "cpu_iters": int(cit[w]),
                  "min_abs_q1_minus_half": float(min(
                      np.abs(gq[w] - 0.5).min(), np.abs(cq[w] - 0.5).min()))}
                 for w in one]
    for w in one_sided:
        print(f"bp_decode: word {w['word']} solved on the "
              f"{'card' if w['card_solved'] else 'CPU'} only, smallest "
              f"|q1 - 0.5| {w['min_abs_q1_minus_half']:.3e}", flush=True)
    unsolved = ~(gok | cok)
    card_ber = _cell_error(gx, grid["gts"], grid["snr_dbs"], grid["sigma_b"])
    print("bp_decode: the card's per-cell BER (f32), then the host "
          "decoder's (f64):")
    print(np.array_str(card_ber, precision=4, suppress_small=True))
    print(np.array_str(grid["bp_err_matrix"], precision=4,
                       suppress_small=True), flush=True)
    emit("bp_decode", words=words, max_loops=BP_LOOPS, ms_per_call=ms,
         words_per_s=words / ms * 1e3, kernels_per_call=kernels,
         device_busy_ms=busy_ms, cpu_seconds=cpu_seconds,
         solved_card=int(gok.sum()), solved_cpu=int(cok.sum()),
         solved_one_side=len(one), one_sided=one_sided,
         unsolved_x_differ=int((gx != cx).any(-1)[unsolved].sum()),
         q1_max_abs_diff_both_solved=float(
             np.abs(gq - cq)[both].max()) if both.any() else 0.0,
         card_ber=card_ber.tolist(),
         host_bp_err_matrix=grid["bp_err_matrix"].tolist())
    require(len(one) <= BP_ONE_SIDED * words,
            f"{len(one)} words solved by one side only > "
            f"{BP_ONE_SIDED} of {words}")


def _vs_cpu(torch, gpu, cpu, what):
    """A card result against the CPU's (``decode_vs_cpu``, ``joint``,
    ``entry``): max abs diff 1e-3, signs equal where the CPU's value
    exceeds 1e-3.  Returns (diff, values compared)."""
    require(gpu.shape == cpu.shape, f"{what}: shapes {gpu.shape} {cpu.shape}")
    require(torch.isfinite(gpu).all().item(), f"{what}: finite")
    diff = (gpu - cpu).abs().max().item()
    require(diff <= 1e-3, f"{what}: max abs diff {diff} > 1e-3")
    sure = cpu.abs() > 1e-3
    require(((gpu >= 0) == (cpu >= 0))[sure].all().item(),
            f"{what}: signs agree where |value| > 1e-3")
    return diff, int(sure.sum().item())


def phase_decode_vs_cpu(torch, model, batch, dev):
    from fgnn_tpu_torch.train.ldpc import decode_logits

    gpu = decode_logits(model, batch, dev).cpu()
    cpu_model = copy.deepcopy(model).cpu().eval()
    cpu = decode_logits(cpu_model, batch, "cpu")
    require(gpu.shape == (BATCH, 48), "logits (256, 48)")
    diff, compared = _vs_cpu(torch, gpu, cpu, "decode logits")
    emit("decode_vs_cpu", logits_max_abs_diff=diff,
         decisions_compared=compared)


def phase_train(torch, fused_mp, dev, tmp):
    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.ldpc import (
        BASE_LR,
        stage_batch,
        train,
        train_step,
    )
    from fgnn_tpu_torch.utils.logging import MetricsWriter

    args = Namespace(samples_per_epoch=TRAIN_STEPS * BATCH, snr=None, seed=0,
                     batch_size=BATCH, n_epochs=1,
                     steps_per_epoch=TRAIN_STEPS, model_path="",
                     clean_weight=0.0)
    model = init_weights(LDPCModel(), seed=0).to(dev)
    # warm-up (the first call of each library, cuBLAS handles): one step
    # on another model, so that the counted run starts from the seed
    warm = init_weights(LDPCModel(), seed=1).to(dev)
    warm_batch = next(ContinuousCodesSP(length=BATCH, seed=9).batches(BATCH))
    train_step(warm, make_optimizer(warm.parameters(), BASE_LR), warm_batch,
               dev)
    torch.cuda.synchronize()

    run_dir = os.path.join(tmp, "train")
    fused_mp.reset_counts()
    t0 = time.perf_counter()
    with MetricsWriter(os.path.join(run_dir, "tf_logs")) as writer:
        train(args, model, writer, run_dir, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = dict(fused_mp.COUNTS), dict(fused_mp.BWD_COUNTS)
    require(fwd["kernel_launches"] == FWD_PER_STEP * TRAIN_STEPS,
            f"forward launches {fwd['kernel_launches']} != "
            f"{FWD_PER_STEP} x {TRAIN_STEPS}")
    require(bwd["kernel_launches"] == BWD_PER_STEP * TRAIN_STEPS,
            f"backward launches {bwd['kernel_launches']} != "
            f"{BWD_PER_STEP} x {TRAIN_STEPS}")
    require(fwd["plain_calls"] == 0 and bwd["plain_calls"] == 0,
            "no plain calls on the card")
    require(fused_mp.KEPT_BWD_COUNTS["kernel_launches"] == 0,
            "every backward took the staged route")
    with open(os.path.join(run_dir, "tf_logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["value"] for r in logged if r["tag"] == "syn_train/loss"]
    require(len(losses) == TRAIN_STEPS // 10, "a loss every 10 steps")
    require(all(math.isfinite(r["value"]) for r in logged),
            "finite logged metrics")
    for ckpt in ("ldpc_latest.ckpt", "ldpc_final.ckpt"):
        require(os.path.getsize(os.path.join(run_dir, ckpt)) > 0,
                f"{ckpt} written")

    # the step alone, on one batch already on the card (as bench.py times
    # the JAX step)
    opt = make_optimizer(model.parameters(), BASE_LR)
    staged = stage_batch(model, warm_batch, dev)
    step_ms = cuda_ms(lambda: train_step(model, opt, staged, dev), 20, torch)
    emit("train", steps=TRAIN_STEPS, batch_size=BATCH, seconds=seconds,
         steps_per_s=TRAIN_STEPS / seconds, train_step_ms=step_ms,
         train_edges_per_s=EDGES_PER_WORD * BATCH / step_ms * 1e3,
         losses=losses, fwd_launches=fwd["kernel_launches"],
         bwd_launches=bwd["kernel_launches"],
         plain_calls=fwd["plain_calls"] + bwd["plain_calls"])
    return fwd, bwd, step_ms


def phase_train_bp_features(torch, fused_mp, dev, tmp, path, train_ms):
    """``train.ldpc.train --bp-features`` and ``evaluate --bp-features`` at
    the reference width: the decode of every step and batch runs on the
    card before the first conv, and the convs launch as without it."""
    from fgnn_tpu_torch.data import Codes, ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train import ldpc
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.utils.logging import MetricsWriter

    args = ldpc.parse_args([
        "--train", "--bp-features", "--n-epochs", "1", "--steps-per-epoch",
        str(TRAIN_STEPS), "--batch-size", str(BATCH),
        "--samples-per-epoch", str(TRAIN_STEPS * BATCH), "--seed", "0"])
    model = init_weights(ldpc.new_model(args), seed=0).to(dev)
    require(model.main.node_mapping.conv.weight.shape[1] == 4,
            "a model of 4 node features")
    warm = init_weights(LDPCModel(node_feature_dim=4), seed=1).to(dev)
    warm_batch = next(ContinuousCodesSP(length=BATCH, seed=9).batches(BATCH))
    ldpc.train_step(warm, make_optimizer(warm.parameters(), ldpc.BASE_LR),
                    warm_batch, dev, bp_features=True)
    torch.cuda.synchronize()
    run_dir = os.path.join(tmp, "train_bp_features")
    fused_mp.reset_counts()
    t0 = time.perf_counter()
    with MetricsWriter(os.path.join(run_dir, "tf_logs")) as writer:
        ldpc.train(args, model, writer, run_dir, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = dict(fused_mp.COUNTS), dict(fused_mp.BWD_COUNTS)
    require(fwd["kernel_launches"] == FWD_PER_STEP * TRAIN_STEPS
            and bwd["kernel_launches"] == BWD_PER_STEP * TRAIN_STEPS,
            f"bp-features train: {fwd['kernel_launches']} forward and "
            f"{bwd['kernel_launches']} backward launches")
    require(fwd["plain_calls"] == 0 and bwd["plain_calls"] == 0
            and fused_mp.KEPT_BWD_COUNTS["kernel_launches"] == 0,
            "bp-features train: no plain calls, no kept backward")
    with open(os.path.join(run_dir, "tf_logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["value"] for r in logged if r["tag"] == "syn_train/loss"]
    require(len(losses) == TRAIN_STEPS // 10 and all(
        math.isfinite(r["value"]) for r in logged),
        "bp-features train: finite logged metrics")
    for ckpt in ("ldpc_latest.ckpt", "ldpc_final.ckpt"):
        require(os.path.getsize(os.path.join(run_dir, ckpt)) > 0,
                f"bp-features train: {ckpt} written")

    eargs = ldpc.parse_args(["--test-path", path, "--bp-features",
                             "--batch-size", str(BATCH)])
    n_batches = len(Codes(path)) // BATCH
    seconds_eval, ecounts, ber_total, err = _count_decode(
        torch, fused_mp, ldpc.evaluate, eargs, model, dev, n_batches)

    opt = make_optimizer(model.parameters(), ldpc.BASE_LR)
    staged = ldpc.stage_batch(model, warm_batch, dev)
    step_ms = cuda_ms(lambda: ldpc.train_step(model, opt, staged, dev,
                                              bp_features=True), 20, torch)
    emit("train_bp_features", steps=TRAIN_STEPS, batch_size=BATCH,
         seconds=seconds, steps_per_s=TRAIN_STEPS / seconds,
         train_step_ms=step_ms, train_step_ms_without=train_ms,
         losses=losses, fwd_launches=fwd["kernel_launches"],
         bwd_launches=bwd["kernel_launches"],
         plain_calls=fwd["plain_calls"] + bwd["plain_calls"],
         eval_seconds=seconds_eval, eval_words_per_s=n_batches * BATCH
         / seconds_eval, eval_fwd_launches=ecounts["kernel_launches"],
         eval_ber_total=float(ber_total))
    return fwd, bwd, ecounts


def _grad_errors(torch, got, ref):
    """Gradients ``got`` against ``ref`` (name -> tensor or None), in f64:
    relative L2 error per tensor where the reference stands clear of the
    noise floor (GRAD_FLOOR of its largest gradient), else max abs error
    (the tensors that are zero or tiny in exact arithmetic).  Returns
    (rel, abs, floor, failures: a gradient on one side only or not
    finite)."""
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in ref.values()
                             if g is not None)
    rel, err, bad = {}, {}, []
    for n, r in ref.items():
        g = got[n]
        if r is None or g is None:
            if not (r is None and g is None):
                bad.append(f"{n}: a gradient on one side only")
            continue
        if not torch.isfinite(g).all().item():
            bad.append(f"{n}: a gradient that is not finite")
            continue
        g, r = g.double(), r.double()
        if r.abs().max().item() > 100 * floor:
            rel[n] = ((g - r).norm() / r.norm()).item()
        else:
            err[n] = (g - r).abs().max().item()
    return rel, err, floor, bad


def phase_train_vs_cpu(torch, dev, bp_features=False):
    """One train step from the same weights and batch on the card and on
    the port's CPU path.  With ``--bp-features`` (the sum-product decode in
    the step on each side) from the weights BP_WARM_STEPS card steps
    leave."""
    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.ldpc import BASE_LR, train_step

    model = init_weights(LDPCModel(node_feature_dim=4 if bp_features
                                   else 2), seed=2)
    if bp_features:
        model = model.to(dev)
        opt = make_optimizer(model.parameters(), BASE_LR)
        for b in ContinuousCodesSP(length=BP_WARM_STEPS * BATCH,
                                   seed=40).batches(BATCH):
            train_step(model, opt, b, dev, bp_features=True)
        model = model.cpu()
    batch = next(ContinuousCodesSP(length=BATCH, seed=3).batches(BATCH))
    runs = {}
    for where in (dev, "cpu"):
        m = copy.deepcopy(model).to(where)
        metrics = train_step(m, make_optimizer(m.parameters(), BASE_LR),
                             batch, where, bp_features=bp_features)
        runs[str(where)] = (
            {k: float(v) for k, v in metrics.items()},
            {n: None if p.grad is None else p.grad.cpu()
             for n, p in m.named_parameters()})
    (gm, gg), (cm, cg) = runs[str(dev)], runs["cpu"]
    for k in ("loss", "sigma_b_loss"):
        require(math.isfinite(gm[k]), f"finite {k}")
        require(abs(gm[k] - cm[k]) <= LOSS_RTOL * abs(cm[k]),
                f"{k}: card {gm[k]} vs CPU {cm[k]}")
    rel, noise, floor, bad = _grad_errors(torch, gg, cg)
    bad += ([f"{n}: relative L2 error {v}" for n, v in rel.items()
             if v > GRAD_REL_L2]
            + [f"{n}: max abs err {v} > {floor}" for n, v in noise.items()
               if v > floor])
    emit("train_bp_features_vs_cpu" if bp_features else "train_vs_cpu",
         loss=gm["loss"], loss_cpu=cm["loss"],
         sigma_b_loss=gm["sigma_b_loss"], sigma_b_loss_cpu=cm["sigma_b_loss"],
         acc=gm["acc"], acc_cpu=cm["acc"], tensors_rel_l2=len(rel),
         grad_rel_l2_worst=max(rel.values()),
         grad_rel_l2_worst_tensor=max(rel, key=rel.get),
         tensors_rel_l2_over_1e_3=sum(v > 1e-3 for v in rel.values()),
         tensors_at_noise_floor=len(noise), noise_floor=floor,
         noise_abs_err_worst=max(noise.values(), default=0.0),
         failed=bad)
    require(not bad, "gradients on the card and on the CPU agree")


def _ext_inputs(torch, B, N, K, T, C, seed):
    """h with two rows per node (self, neighbour), a table over the N
    nodes (Nd = N) and etype, on the card."""
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(B, 2 * N, T, C, device="cuda", generator=g)
    idx = torch.randint(0, N, (N, K), device="cuda", generator=g,
                        dtype=torch.int32)
    et = torch.randn(B, N, K, T, device="cuda", generator=g)
    return h, GatherTable(idx.cpu().numpy(), N).to("cuda"), et


def _check_close(torch, got, ref, what):
    require(torch.isfinite(got).all().item(), f"{what} finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(err <= KERNEL_TOL * scale,
            f"{what}: max_abs_err {err} > {KERNEL_TOL} * {scale}")
    return err


def _check_ext_fwd(torch, fused_mp, what, h, idx, et, agg, want, slab,
                   ref, kept):
    """The extension forward on route ``slab`` (None: the planned staged
    slab) against the plain version's ``ref``: one launch of that route
    each call, two launches give the same bits, out within KERNEL_TOL;
    max's out (and argmax) bit-equal to the kept route's ``kept``, and the
    argmax equal to the plain one's where the top two messages stand
    clear.  Returns the error."""
    counts = (fused_mp.KEPT_EXT_COUNTS if slab == 0
              else fused_mp.EXT_COUNTS)
    before = counts["kernel_launches"]
    runs = [fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, want,
                                          ext=True, slab=slab)
            for _ in range(2)]
    torch.cuda.synchronize()
    require(counts["kernel_launches"] == before + 2,
            f"{what}: two launches of route {slab}")
    first, second = ((r if want else (r,)) for r in runs)
    require(all(torch.equal(a, b) for a, b in zip(first, second)),
            f"{what}: two launches give the same bits")
    err = _check_close(torch, first[0], ref[0], what)
    if agg == "max":
        require(all(torch.equal(a, b) for a, b in zip(first, kept)),
                f"{what}: max bit-equal to the kept route")
    if want:
        hg = h[:, 0::2, None] + h[:, 1::2][:, idx.long()]
        msgs = (hg * et[..., None]).sum(dim=3)
        top2 = msgs.topk(2, dim=2).values
        clear = ((top2[:, :, 0] - top2[:, :, 1])
                 > 1e-5 * top2[:, :, 0].abs())
        require((first[1] == ref[1])[clear].all().item(),
                f"{what}: argmax differs where the gap is clear")
    return err


def phase_kernel_check_ext(torch, fused_mp):
    worst, rows = 0.0, []
    for si, (name, B, N, K, T, C, path_agg, per_hop, per_fixed) in \
            enumerate(EXT_SHAPES):
        h, table, et = _ext_inputs(torch, B, N, K, T, C, 300 + si)
        idx = table.idx
        for agg in AGGS:
            require(fused_mp.fwd_slab(B, 2 * N, N, K, T, C, agg) > 0,
                    f"{name} {agg}: a forward slab is planned")
            for want in ((True, False) if agg == "max" else (False,)):
                ref = fused_mp.typed_gather_mix_agg_plain(
                    h, idx, et, agg, 3.0, want, ext=True)
                ref = ref if want else (ref,)
                kept = fused_mp.typed_gather_mix_agg(
                    h, idx, et, agg, 3.0, want, ext=True, slab=0)
                kept = kept if want else (kept,)
                for route, slab in ROUTES:
                    worst = max(worst, _check_ext_fwd(
                        torch, fused_mp, f"{name} {agg} argmax={want} "
                        f"{route}", h, idx, et, agg, want, slab, ref, kept))
        if path_agg is None:
            continue
        # the train path's call: the path's aggregator, the argmax for max
        want = path_agg == "max"
        ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, path_agg, 3.0,
                                                  want, ext=True)
        ref = ref if want else (ref,)
        kept = fused_mp.typed_gather_mix_agg(h, idx, et, path_agg, 3.0,
                                             want, ext=True, slab=0)
        kept = kept if want else (kept,)

        def call(slab, agg=path_agg, want=want):
            return fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, want,
                                                 ext=True, slab=slab)

        def check(got, cs, want=want, ref=ref, kept=kept):
            got = got if want else (got,)
            if path_agg == "max":
                require(all(torch.equal(a, b) for a, b in zip(got, kept)),
                        f"{name} slab {cs}: max bit-equal to the kept route")
            return _check_close(torch, got[0], ref[0], f"{name} slab {cs}")

        timing, err = _time_routes(
            torch, call, lambda: fused_mp.typed_gather_mix_agg_plain(
                h, idx, et, path_agg, 3.0, want, ext=True),
            fused_mp.fwd_slabs(2 * N, N, K, T, C), check)
        worst = max(worst, err)
        slab = fused_mp.fwd_slab(B, 2 * N, N, K, T, C, path_agg)
        # read h (both rows), the table and etype once; write out (+argmax)
        nbytes = (4 * (h.numel() + idx.numel() + et.numel() + B * N * C)
                  + (B * N * C if want else 0))
        # per edge and channel: T adds of the two rows, T FMAs, one
        # aggregation step
        ops = B * N * K * C * (3 * T + 1)
        rows.append(dict(
            name=name, B=B, N=N, Nd=N, K=K, T=T, C=C, aggregator=path_agg,
            argmax=want, per_hop_step=per_hop, per_fixed_step=per_fixed,
            **timing, slab=slab, slabs_per_sample=C // slab,
            slab_bytes=fused_mp.fwd_bytes(2 * N, N, K, T, slab),
            bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
            bound_by=bound_by(nbytes, ops),
            gbytes_per_s=nbytes / timing["ms"] / 1e6))
        emit("kernel_check_ext", **rows[-1], max_abs_err=worst)

    # all ties: every edge of a row reads the same rows, so every message
    # ties; K=9 puts two edges on one lane and eight lanes on a row, and the
    # staged route's first-win argmax must still be 0 everywhere
    B, N, K, T, C = 8, 16, 9, 2, 16
    h = torch.randn(1, 1, T, C, device="cuda").expand(B, 2 * N, T, C)
    idx = torch.zeros(N, K, dtype=torch.int32, device="cuda")
    et = torch.ones(B, N, K, T, device="cuda")
    before = fused_mp.EXT_COUNTS["kernel_launches"]
    _, am = fused_mp.typed_gather_mix_agg(h.contiguous(), idx, et, "max",
                                          want_argmax=True, ext=True)
    require(fused_mp.EXT_COUNTS["kernel_launches"] == before + 1,
            "all ties: the staged forward")
    require(am.max().item() == 0, "all-ties argmax is 0 (extensions)")
    emit("kernel_check_ext", name="all_ties", argmax_max=int(am.max().item()),
         max_abs_err=worst)
    return worst, rows


def phase_kernel_check_ext_bwd(torch, fused_mp):
    worst, rows = 0.0, []
    for si, (name, B, N, K, T, C, path_agg, per_hop, per_fixed) in \
            enumerate(EXT_SHAPES):
        h, table, et = _ext_inputs(torch, B, N, K, T, C, 400 + si)
        idx = table.idx
        gen = torch.Generator(device="cuda").manual_seed(500 + si)
        g = torch.randn(B, N, C, device="cuda", generator=gen)
        kernels = {}
        for agg in AGGS:
            require(fused_mp.bwd_slab(B, 2 * N, N, K, T, C, agg) > 0,
                    f"{name} {agg}: a slab is planned")
            res = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0,
                                                agg == "max", ext=True)
            out, am = res if agg == "max" else (res, None)

            def bwd(slab, agg=agg, am=am, out=out):
                return fused_mp.typed_gather_mix_agg_bwd(
                    g, h, idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
                    argmax=am, out=out, ext=True, slab=slab)

            def plain(agg=agg, am=am, out=out):
                return fused_mp.typed_gather_mix_agg_bwd_plain(
                    g, h, idx, et, agg, 3.0, argmax=am, out=out, ext=True)

            ref = plain()
            worst = max(worst, _check_bwd_routes(
                torch, fused_mp, f"{name} {agg}", bwd, ref, True, ROUTES))
            kernels[agg] = (bwd, plain, ref)
        if path_agg is None:
            continue
        timing, err = _time_bwd_routes(torch, fused_mp, name,
                                       *kernels[path_agg], B, 2 * N, N, K, T,
                                       C, path_agg)
        worst = max(worst, err)
        # read g, the argmax (max) or out (softmax), h, etype and the
        # tables once; write dh and d_etype
        saved = B * N * C * (1 if path_agg == "max" else 4)
        nbytes = (4 * B * N * C + saved + 2 * 4 * h.numel()
                  + 2 * 4 * et.numel()
                  + 4 * (idx.numel() + table.ext_ptr.numel()
                         + table.ext_edge.numel()))
        # per edge and channel: dm, then T adds and T FMAs for d_etype and
        # T FMAs into each of the two rows for dh; softmax also needs the
        # message (T adds and T FMAs) for its weight
        ops = B * N * K * C * (7 * T + 1 + (3 * T if path_agg == "softmax"
                                            else 0))
        rows.append(dict(
            name=name, B=B, N=N, Nd=N, K=K, T=T, C=C, aggregator=path_agg,
            per_hop_step=per_hop, per_fixed_step=per_fixed, **timing,
            bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
            bound_by=bound_by(nbytes, ops),
            gbytes_per_s=nbytes / timing["ms"] / 1e6))
        emit("kernel_check_ext_bwd", **rows[-1], max_abs_err=worst)
    return worst, rows


def _syn_args(workload, tmp, steps, eval_batches, *extra, name=None):
    """The CLI's flags for a run of ``steps`` and ``eval_batches``, inline
    synthesis unless ``extra`` names ``--workers``."""
    from fgnn_tpu_torch.train.synthetic import parse_args

    if "--workers" not in extra:
        extra = ("--workers", "0") + extra
    return parse_args([
        "--train-epoches", "1",
        "--train-size", str(steps * SYN_BATCH),
        "--test-size", str(eval_batches * SYN_BATCH),
        "--batch-size", str(SYN_BATCH), "--seed", "0",
        "--work-dir", os.path.join(tmp, name or workload), *extra],
        workload)


def _run_syn(torch, fused_mp, dev, workload, args, steps, eval_batches,
             per_step):
    """``train_and_eval`` as the CLI runs it, counted: every step and eval
    batch launches the extension kernels ``per_step`` times and nothing
    else runs a kernel or a plain version."""
    from fgnn_tpu_torch.train.synthetic import train_and_eval

    fused_mp.reset_counts()
    t0 = time.perf_counter()
    acc, lp_acc = train_and_eval(workload, args, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = dict(fused_mp.EXT_COUNTS), dict(fused_mp.EXT_BWD_COUNTS)
    # the staged backward's bf16 launches with the scalar products count
    # as its kept bf16 route
    bwd["kernel_launches"] += fused_mp.KEPT_BF16_EXT_BWD_COUNTS[
        "kernel_launches"]
    require(fwd["kernel_launches"] == per_step * (steps + eval_batches),
            f"{workload}: forward launches {fwd['kernel_launches']} != "
            f"{per_step} x ({steps} + {eval_batches})")
    require(bwd["kernel_launches"] == per_step * steps,
            f"{workload}: backward launches {bwd['kernel_launches']} != "
            f"{per_step} x {steps}")
    require(fwd["plain_calls"] == 0 and bwd["plain_calls"] == 0
            and fused_mp.COUNTS["kernel_launches"] == 0
            and fused_mp.BWD_COUNTS["kernel_launches"] == 0,
            f"{workload}: no plain calls and no NO_EXTENSION kernel")
    require(fused_mp.KEPT_EXT_BWD_COUNTS["kernel_launches"] == 0
            and fused_mp.KEPT_BWD_COUNTS["kernel_launches"] == 0,
            f"{workload}: every backward took the staged route")
    require(fused_mp.KEPT_EXT_COUNTS["kernel_launches"] == 0,
            f"{workload}: every forward took the staged route")
    require(0.0 <= acc <= 1.0 and 0.0 <= lp_acc <= 1.0,
            f"{workload}: acc and lp_acc in [0, 1]")
    (run,) = os.listdir(args.work_dir)
    run = os.path.join(args.work_dir, run)
    require(os.path.getsize(os.path.join(run, "latest.ckpt")) > 0,
            f"{workload}: latest.ckpt written")
    with open(os.path.join(run, "tf_logs", "metrics.jsonl")) as f:
        logged = {}
        for line in f:
            r = json.loads(line)
            logged.setdefault(r["tag"], []).append(r["value"])
    require(all(math.isfinite(v) for vs in logged.values() for v in vs),
            f"{workload}: finite logged metrics")
    require(len(logged.get("syn_train/loss", [])) == steps // 10,
            f"{workload}: a loss every 10 steps")
    return dict(steps=steps, eval_batches=eval_batches, seconds=seconds,
                acc=acc, lp_acc=lp_acc,
                losses=logged.get("syn_train/loss", []),
                samples_per_s=logged["syn_train/samples_per_s"][0],
                eval_samples_per_s=logged["syn_test/samples_per_s"][0],
                fwd_launches=fwd["kernel_launches"],
                bwd_launches=bwd["kernel_launches"],
                kept_fwd_launches=fused_mp.KEPT_EXT_COUNTS["kernel_launches"],
                plain_calls=fwd["plain_calls"] + bwd["plain_calls"])


def phase_syn_train(torch, fused_mp, dev, tmp):
    from fgnn_tpu_torch.data import batches
    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.synthetic import BASE_LR, SynWorkload, \
        train_step

    args = _syn_args("hop", tmp, SYN_STEPS, SYN_EVAL_BATCHES)
    res = _run_syn(torch, fused_mp, dev, "hop", args, SYN_STEPS,
                   SYN_EVAL_BATCHES, HOP_PER_STEP)
    # the step alone, on one batch already on the card
    wl = SynWorkload("hop", args)
    init_weights(wl.model, 1)
    wl.to(dev)
    opt = make_optimizer(wl.model.parameters(), BASE_LR, weight_decay=0.0)
    staged = wl.stage(next(batches(wl.dataset, SYN_BATCH, 1)), dev)
    step_ms = cuda_ms(lambda: train_step(wl, opt, staged, dev), 20, torch)
    emit("syn_train", batch_size=SYN_BATCH, **res, syn_train_step_ms=step_ms,
         step_samples_per_s=SYN_BATCH / step_ms * 1e3,
         params=sum(p.numel() for p in wl.model.parameters()))
    return res


@contextlib.contextmanager
def _branches(torch, fused_mp, record=None, kinks=None, replay=None):
    """Within the block, every ReLU and leaky ReLU of the port's models,
    every max conv's first-win argmax and every COO max's set of maxima is
    a decision, taken in call order.  With ``record`` each call appends
    (kind, decision) to it: the mask of positive inputs, the argmax, or
    the mask of a COO segment's edges at its max (``amax``, whose gradient
    splits among them).  With ``kinks`` it also appends each element's
    distance from its kink over the largest magnitude of the call's input:
    |x| for a (leaky) ReLU, and for the argmax and the COO max the gap from
    the top message to each message (B, Nd, K, C), or (n, W, C) over the
    segments' padded edge tables.  With ``replay``, a list of (where,
    decision) per call, each call takes the replayed decision where
    ``where`` holds and its own elsewhere: a COO max then averages the
    edges of its set, which routes the gradient as amax does."""
    import torch.nn.functional as F

    from fgnn_tpu_torch.ops import segment

    relu, leaky = torch.relu, F.leaky_relu
    wrapped = fused_mp.typed_gather_mix_agg
    seg_max = segment.segment_max

    def scaled(d, x):
        return (d / x.abs().max().clamp_min(1e-300)).cpu()

    def decide(kind, own, dist):
        if replay is not None:
            where, theirs = replay.pop(0)
            require(where.shape == own.shape, f"{kind}: the same call")
            return torch.where(where.to(own.device), theirs.to(own.device),
                               own)
        record.append((kind, own.cpu()))
        if kinks is not None:
            kinks.append(dist())
        return own

    def relu_(x):
        pos = decide("relu", x > 0, lambda: scaled(x.abs(), x))
        return relu(x) if replay is None else torch.where(
            pos, x, torch.zeros_like(x))

    def leaky_(x, negative_slope=0.01, inplace=False):
        pos = decide("leaky_relu", x > 0, lambda: scaled(x.abs(), x))
        return leaky(x, negative_slope) if replay is None else torch.where(
            pos, x, negative_slope * x)

    def routed(h, nn_idx, etype, aggregator, gamma=3.0, want_argmax=False,
               ext=False, **kw):
        if aggregator != "max" or not want_argmax:
            return wrapped(h, nn_idx, etype, aggregator, gamma, want_argmax,
                           ext=ext, **kw)

        def messages():
            hx, et = fused_mp._operands(h, etype)
            return (fused_mp._gathered(hx, nn_idx.long(), ext)
                    * et[..., None]).sum(dim=3)

        if replay is None:
            out, am = wrapped(h, nn_idx, etype, aggregator, gamma, True,
                              ext=ext, **kw)

            def gaps():
                msgs = messages()
                return scaled(msgs.amax(dim=2, keepdim=True) - msgs, msgs)

            decide("argmax", am, gaps)
            return out, am
        msgs = messages()
        am = decide("argmax", fused_mp._first_win_max(msgs)[1], None)
        out = msgs.gather(2, am[:, :, None].long()).squeeze(2)
        return out.to(h.dtype), am

    def coo_max(data, seg):
        with torch.no_grad():
            padded = segment._padded(data.reshape(data.shape[0], -1), seg,
                                     float("-inf"))
            top = padded.amax(dim=1, keepdim=True)
            at_top = padded == top
        if replay is None:
            out = seg_max(data, seg)

            def gaps():
                finite = torch.where(torch.isfinite(padded), padded,
                                     torch.zeros_like(padded))
                return scaled(top - padded, finite)

            decide("amax", at_top, gaps)
            return out
        taken = decide("amax", at_top, None).view(seg.n, seg.width,
                                                  *data.shape[1:])
        rows = segment._Pad.apply(data, seg, float("-inf"))
        return (torch.where(taken, rows, torch.zeros_like(rows)).sum(dim=1)
                / taken.sum(dim=1).clamp_min(1))

    torch.relu, F.leaky_relu = relu_, leaky_
    fused_mp.typed_gather_mix_agg = routed
    segment.segment_max = coo_max
    try:
        yield
    finally:
        torch.relu, F.leaky_relu = relu, leaky
        fused_mp.typed_gather_mix_agg = wrapped
        segment.segment_max = seg_max


def _flips(torch, side, base, kinks=None):
    """Where the decisions ``side`` differ from ``base`` (both recorded by
    ``_branches`` over the same calls): the replay that takes ``side``'s
    decision there, the number of flipped decisions of each kind, and,
    with ``kinks`` (``base``'s distances), the largest distance of a
    flipped decision from its kink."""
    require(len(side) == len(base), "the same number of decisions")
    replay, flipped, far = [], {}, 0.0
    for i, ((kind, a), (kind_b, b)) in enumerate(zip(side, base)):
        require(kind == kind_b and a.shape == b.shape,
                f"decision {i}: the same call")
        where = a != b
        n = int(where.sum().item())
        flipped[kind] = flipped.get(kind, 0) + n
        if n and kinks is not None:
            d = kinks[i]
            if kind == "argmax":  # the gap to the message side took
                d = d.gather(2, a[:, :, None].long()).squeeze(2)
            far = max(far, d[where].max().item())
        replay.append((where, a))
    return replay, flipped, far


def phase_syn_train_vs_cpu(torch, dev):
    """The hop step against the CPU and f64 from each (data, init) seed
    pair of SYN_VS_CPU_SEEDS; every reading must pass, and their spread is
    emitted."""
    worst = []
    for data_seed, init_seed in SYN_VS_CPU_SEEDS:
        worst.append(_syn_train_vs_cpu(torch, dev, data_seed, init_seed))
    emit("syn_train_vs_cpu", seeds=[list(p) for p in SYN_VS_CPU_SEEDS],
         card_vs_f64_rel_l2_worst_by_seed=[w[0] for w in worst],
         cpu_vs_f64_rel_l2_worst_by_seed=[w[1] for w in worst],
         card_vs_cpu_rel_l2_worst_by_seed=[w[2] for w in worst],
         card_vs_f64_rel_l2_spread=[min(w[0] for w in worst),
                                    max(w[0] for w in worst)],
         flipped_by_seed=[w[3] for w in worst],
         tol_rel_l2=GRAD_REL_L2, kink_tol=KINK_TOL)


def _syn_train_vs_cpu(torch, dev, data_seed, init_seed, coo=False):
    """One hop step from the weights SYN_WARM_STEPS dense card steps leave,
    on the card, on the CPU and in f64 (with ``coo``, through the COO
    model at uniform length, ``--coo``): the readings of
    ``syn_train_vs_cpu`` (``syn_coo_vs_cpu``) at one seed pair."""
    from fgnn_tpu_torch.data import batches
    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.ops import fused_mp
    from fgnn_tpu_torch.train.synthetic import BASE_LR, SynWorkload, \
        parse_args, train_step

    dense = parse_args(["--seed", str(data_seed),
                        "--batch-size", str(SYN_BATCH)], "hop")
    args = parse_args(["--coo", "--seed", str(data_seed),
                       "--batch-size", str(SYN_BATCH)], "hop") \
        if coo else dense
    wl = SynWorkload("hop", dense)
    init_weights(wl.model, init_seed)
    wl.to(dev)
    data = batches(wl.dataset, SYN_BATCH, SYN_WARM_STEPS + 1)
    opt = make_optimizer(wl.model.parameters(), BASE_LR, weight_decay=0.0)
    for _ in range(SYN_WARM_STEPS):
        train_step(wl, opt, next(data), dev)
    start = {k: v.cpu() for k, v in wl.model.state_dict().items()}
    batch = next(data)

    def run(where, dtype, **routed):
        wl = SynWorkload("hop", args)
        wl.model.load_state_dict(start)
        wl.to(where)
        wl.model.to(dtype)

        def cast(tables):
            return {k: v.to(dtype) if k.startswith("ef") else v
                    for k, v in tables.items()}

        if wl.buckets is None:
            wl.static = cast(wl.static)
        else:
            wl.buckets = {n: cast(t) for n, t in wl.buckets.items()}
        staged = {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in wl.stage(batch, where).items()}
        opt = make_optimizer(wl.model.parameters(), BASE_LR,
                             weight_decay=0.0)
        with _branches(torch, fused_mp, **routed):
            metrics = train_step(wl, opt, staged, where)
        if "replay" in routed:
            require(not routed["replay"], "every decision replayed")
        return ({k: float(v) for k, v in metrics.items()},
                {n: None if p.grad is None else p.grad.cpu().double()
                 for n, p in wl.model.named_parameters()})

    f32, f64 = torch.float32, torch.float64
    taken = {"card": [], "cpu": [], "f64": []}
    kinks = []
    runs = {"card": run(dev, f32, record=taken["card"]),
            "cpu": run("cpu", f32, record=taken["cpu"]),
            "f64": run("cpu", f64, record=taken["f64"], kinks=kinks)}
    require(taken["f64"], "the decisions recorded")
    # each f32 run against an f64 run that flips the decisions the f32 run
    # flipped, and only those, each of them at its kink
    refs, flipped, far = {}, {}, {}
    for side in ("card", "cpu"):
        replay, flipped[side], far[side] = _flips(
            torch, taken[side], taken["f64"], kinks)
        refs[side] = run("cpu", f64, replay=replay)[1]
    # the CPU's f32 on the card's decisions, for a bounded card-vs-CPU
    replay, _, _ = _flips(torch, taken["card"], taken["cpu"])
    refs["card_vs_cpu"] = run("cpu", f32, replay=replay)[1]
    (gm, gg), (cm, cg) = runs["card"], runs["cpu"]
    require(math.isfinite(gm["loss"]), "finite loss")
    require(abs(gm["loss"] - cm["loss"]) <= LOSS_RTOL * abs(cm["loss"]),
            f"loss: card {gm['loss']} vs CPU {cm['loss']}")
    bad = [f"{side}: a flipped decision {far[side]} of its input's largest "
           f"magnitude from its kink > {KINK_TOL}"
           for side in far if far[side] > KINK_TOL]
    readings = {}
    for side, grads, ref in (("card", gg, refs["card"]),
                             ("cpu", cg, refs["cpu"]),
                             ("card_vs_cpu", gg, refs["card_vs_cpu"])):
        rel, noise, floor, failed = _grad_errors(torch, grads, ref)
        readings[side] = rel
        bad += [f"{side}: {m}" for m in failed]
        bad += ([f"{side} {n}: relative L2 error {v}" for n, v in rel.items()
                 if v > GRAD_REL_L2]
                + [f"{side} {n}: max abs err {v} > {floor}"
                   for n, v in noise.items() if v > floor])
    card, cpu = readings["card"], readings["cpu"]
    free = {side: max(_grad_errors(torch, g, runs["f64"][1])[0].values())
            for side, g in (("card", gg), ("cpu", cg))}
    worst = sorted(card, key=card.get, reverse=True)[:5]
    emit("syn_coo_vs_cpu" if coo else "syn_train_vs_cpu",
         seeds=[data_seed, init_seed],
         warm_steps=SYN_WARM_STEPS, loss=gm["loss"],
         loss_cpu=cm["loss"], acc=gm["acc"], acc_cpu=cm["acc"],
         lp_acc=gm["lp_acc"], tensors_rel_l2=len(card),
         tensors_at_noise_floor=len(noise), noise_floor=floor,
         decisions=sum(int(d.numel()) for _, d in taken["f64"]),
         flipped=flipped, flipped_kink_distance_worst=far,
         kink_tol=KINK_TOL,
         card_vs_f64_rel_l2_worst=max(card.values()),
         cpu_vs_f64_rel_l2_worst=max(cpu.values()),
         card_vs_cpu_rel_l2_worst=max(readings["card_vs_cpu"].values()),
         card_vs_f64_unflipped_rel_l2_worst=free["card"],
         cpu_vs_f64_unflipped_rel_l2_worst=free["cpu"],
         card_vs_cpu_unflipped_rel_l2_worst=max(
             _grad_errors(torch, gg, cg)[0].values()),
         worst_tensors={n: {"card_vs_f64": card[n], "cpu_vs_f64": cpu[n]}
                        for n in worst},
         tol_rel_l2=GRAD_REL_L2, failed=bad)
    require(not bad, "hop gradients on the card and on the CPU within "
                     "GRAD_REL_L2 of the f64 run, flipped decisions at "
                     "their kinks")
    return (max(card.values()), max(cpu.values()),
            max(readings["card_vs_cpu"].values()), flipped)


def phase_syn_workers(torch, fused_mp, dev, tmp):
    """The hop trainer with the default ``--workers`` and with
    ``--workers 0``: the pool's stream, the prefetch thread's staging."""
    import functools

    import numpy as np

    from fgnn_tpu_torch.data import loader
    from fgnn_tpu_torch.train import synthetic

    seen, methods = [], []

    class Recording(loader.PoolBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            methods.append(self.start_method)

        def batches(self, n):
            for b in super().batches(n):
                if len(seen) < 3:
                    seen.append(b)
                yield b

    default = synthetic.parse_args([], "hop").workers
    pooled = _syn_args("hop", tmp, SYN_STEPS, SYN_EVAL_BATCHES,
                       "--workers", str(default), name="hop_workers")
    synthetic.PoolBatcher = Recording
    try:
        res = _run_syn(torch, fused_mp, dev, "hop", pooled, SYN_STEPS,
                       SYN_EVAL_BATCHES, HOP_PER_STEP)
    finally:
        synthetic.PoolBatcher = loader.PoolBatcher
    require(methods == ["spawn"], f"one pool, spawned ({methods})")
    inline = _syn_args("hop", tmp, SYN_STEPS, SYN_EVAL_BATCHES,
                       name="hop_inline")
    res0 = _run_syn(torch, fused_mp, dev, "hop", inline, SYN_STEPS,
                    SYN_EVAL_BATCHES, HOP_PER_STEP)

    # the pool's first batches (the init batch and two train batches)
    # against a pool of the same seed built here, of one worker
    with loader.PoolBatcher(functools.partial(
            synthetic.make_syn_dataset, "hop", pooled), SYN_BATCH,
            n_workers=1, seed=pooled.seed) as pool:
        want = list(pool.batches(3))
    require(len(seen) == 3 and all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                       for k in a)
        for a, b in zip(seen, want)),
        "the trainer's pool batches equal a pool of the same seed")
    # device_prefetch's copies (pinned memory, its own stream) against the
    # same batches staged inline
    wl = synthetic.SynWorkload("hop", pooled)
    n = 0
    with loader.device_prefetch(iter(want), dev,
                                put=lambda b: wl.stage(b, dev)) as staged:
        for got, b in zip(staged, want):
            ref = wl.stage(b, dev)
            require(sorted(got) == sorted(ref) and all(
                torch.equal(got[k], ref[k]) for k in ref),
                "a prefetched batch equals the batch staged inline")
            n += 1
    require(n == 3, "three prefetched batches")
    emit("syn_workers", workers=default, cpu_count=os.cpu_count(),
         start_method=methods[0], batch_size=SYN_BATCH,
         samples_per_s_workers=res["samples_per_s"],
         samples_per_s_inline=res0["samples_per_s"],
         eval_samples_per_s_workers=res["eval_samples_per_s"],
         seconds_workers=res["seconds"], seconds_inline=res0["seconds"],
         losses_workers=res["losses"], losses_inline=res0["losses"],
         acc_workers=res["acc"], acc_inline=res0["acc"])
    return res, res0


def phase_syn_train_path(torch, fused_mp, dev, tmp):
    """The writer CLI's hop samples through --train-path and --test-path."""
    path = os.path.join(tmp, "hops_train.npz")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "fgnn_tpu_torch.data.generate", "rpgm",
         "--type", "hops", "--size", str(SYN_PATH_SAMPLES), "--seed", "0",
         "--out", path], cwd=ROOT, check=True, capture_output=True,
        text=True, timeout=600)
    write_s = time.perf_counter() - t0
    args = _syn_args("hop", tmp, SYN_STEPS, SYN_EVAL_BATCHES, "--train-path",
                     path, "--test-path", path, name="hop_train_path")
    res = _run_syn(torch, fused_mp, dev, "hop", args, SYN_STEPS,
                   SYN_EVAL_BATCHES, HOP_PER_STEP)
    require(all(math.isfinite(v) for v in res["losses"]),
            "train-path: finite losses")
    emit("syn_train_path", samples=SYN_PATH_SAMPLES, write_seconds=write_s,
         writer=out.stdout.strip(), batch_size=SYN_BATCH, **res)
    return res


# --------------------------------------------------------------------------
# the COO path (ROADMAP item 5): PyTorch ops, no typed-mp kernel


def _fused_total(fused_mp):
    """Every typed-mp kernel launch and plain call counted since the last
    reset, over all routes."""
    return sum(c["kernel_launches"] + c.get("plain_calls", 0) for c in (
        fused_mp.COUNTS, fused_mp.BWD_COUNTS, fused_mp.EXT_COUNTS,
        fused_mp.EXT_BWD_COUNTS, fused_mp.KEPT_EXT_COUNTS,
        fused_mp.KEPT_BWD_COUNTS, fused_mp.KEPT_EXT_BWD_COUNTS,
        fused_mp.KEPT_BF16_COUNTS, fused_mp.KEPT_BF16_BWD_COUNTS,
        fused_mp.KEPT_BF16_EXT_COUNTS, fused_mp.KEPT_BF16_EXT_BWD_COUNTS))


@contextlib.contextmanager
def _steps_recorded(synthetic):
    """Within the block, each ``train_step`` of the trainer appends (the
    batch's sample width, its loss on the device) to the yielded list."""
    real, seen = synthetic.train_step, []

    def step(wl, optimizer, batch, device, **kw):
        m = real(wl, optimizer, batch, device, **kw)
        seen.append((int(batch["label"].shape[1]), m["loss"]))
        return m

    synthetic.train_step = step
    try:
        yield seen
    finally:
        synthetic.train_step = real


def phase_syn_coo(torch, fused_mp, dev, tmp):
    """``train_and_eval("hop", ...)`` with ``--coo --mixed-lengths`` at the
    reference width, then with ``--length-dist`` and with ``--bf16``: no
    typed-mp kernel and no plain version runs, finite losses; samples/s,
    and the step alone on a staged batch (ms, kernels per step)."""
    from fgnn_tpu_torch.data import batches
    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train import synthetic
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.utils.profiling import kernels_per_call

    def run(name, steps, eval_batches, *flags):
        args = _syn_args("hop", tmp, steps, eval_batches, "--coo",
                         "--mixed-lengths", COO_LENGTHS, *flags, name=name)
        with _steps_recorded(synthetic) as seen:
            res = _run_syn(torch, fused_mp, dev, "hop", args, steps,
                           eval_batches, 0)
        require(_fused_total(fused_mp) == 0,
                f"{name}: no typed-mp kernel and no plain version")
        losses = [float(loss) for _, loss in seen]
        require(len(losses) == steps
                and all(math.isfinite(v) for v in losses),
                f"{name}: {steps} finite losses ({losses})")
        return args, res, [w for w, _ in seen], losses

    args, res, widths, losses = run("hop_coo", COO_STEPS, COO_EVAL_BATCHES)
    require(set(widths) == {COO_WIDTH}, f"composite samples of {COO_WIDTH}")
    wl = synthetic.SynWorkload("hop", args)
    init_weights(wl.model, 1)
    wl.to(dev)
    opt = make_optimizer(wl.model.parameters(), synthetic.BASE_LR,
                         weight_decay=0.0)
    staged = wl.stage(next(batches(wl.dataset, SYN_BATCH, 1)), dev)

    def step():
        synthetic.train_step(wl, opt, staged, dev)

    fused_mp.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, 20, torch)
    kernels, busy_ms = kernels_per_call(step, 3)
    require(_fused_total(fused_mp) == 0, "the COO step: no typed-mp kernel")
    pw, high = wl.static["coo_pw"], wl.static["coo_high"]
    shapes = {"variables": int(staged["node_feature"].shape[0]),
              "factors_per_type": pw.num_nodes
              - int(staged["node_feature"].shape[0]),
              "pw_edges": pw.n_edges, "hop_edges": high.n_edges,
              "samples": pw.num_segments}
    # each joint node receives K edges: 2 (pairwise), 9 (hop)
    nv = COO_WIDTH * SYN_BATCH
    require(shapes == {"variables": nv, "factors_per_type": nv,
                       "pw_edges": 2 * 2 * nv, "hop_edges": 9 * 2 * nv,
                       "samples": 3 * SYN_BATCH}, f"the COO shapes {shapes}")

    _, bucketed, bucket_widths, bucket_losses = run(
        "hop_coo_bucketed", COO_BUCKET_STEPS, 1, "--length-dist", COO_DIST)
    require(set(bucket_widths) <= {int(x) for x in COO_LENGTHS.split(",")},
            f"buckets {bucket_widths}")
    _, b16, _, b16_losses = run("hop_coo_bf16", COO_BF16_STEPS, 1, "--bf16")
    emit("syn_coo", batch_size=SYN_BATCH, mixed_lengths=COO_LENGTHS,
         shapes=shapes, **res, step_losses=losses,
         coo_train_step_ms=step_ms,
         step_samples_per_s=SYN_BATCH / step_ms * 1e3,
         kernels_per_step=kernels, device_busy_ms_per_step=busy_ms,
         step_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         length_dist=COO_DIST, buckets_by_step=bucket_widths,
         bucketed_losses=bucket_losses,
         bucketed_samples_per_s=bucketed["samples_per_s"],
         bf16_losses=b16_losses, bf16_samples_per_s=b16["samples_per_s"])
    return res


def phase_syn_coo_vs_dense(torch, fused_mp, dev):
    """At uniform length 30 (``--coo`` alone), B=32, reference width, from
    the weights SYN_WARM_STEPS dense card steps leave: the COO and the
    dense hop models on one state dict give the same logits (train and
    eval mode) and losses; two COO steps give the same bits; step times in
    turns (all at the first seed pair); the card's COO step against the
    port's CPU COO step and f64, with the decisions at their kinks
    replayed, at every seed pair of SYN_VS_CPU_SEEDS."""
    from fgnn_tpu_torch.data import batches
    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.synthetic import BASE_LR, SynWorkload, \
        parse_args, train_step
    from fgnn_tpu_torch.utils.profiling import kernels_per_call

    data_seed, init_seed = SYN_VS_CPU_SEEDS[0]
    common = ["--seed", str(data_seed), "--batch-size", str(SYN_BATCH)]
    flags = {False: parse_args(common, "hop"),
             True: parse_args(["--coo", *common], "hop")}
    dense = SynWorkload("hop", flags[False])
    init_weights(dense.model, init_seed)
    dense.to(dev)
    data = batches(dense.dataset, SYN_BATCH, SYN_WARM_STEPS + 1)
    opt = make_optimizer(dense.model.parameters(), BASE_LR, weight_decay=0.0)
    for _ in range(SYN_WARM_STEPS):
        train_step(dense, opt, next(data), dev)
    start = {k: v.cpu() for k, v in dense.model.state_dict().items()}
    batch = next(data)

    def make(coo, where):
        wl = SynWorkload("hop", flags[coo])
        wl.model.load_state_dict(start)
        return wl.to(where)

    logits_err = {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            d, c = make(False, dev), make(True, dev)
            d.model.train(mode == "train")
            c.model.train(mode == "train")
            want = d.logits(d.stage(batch, dev))
            got = c.logits(c.stage(batch, dev)).reshape(want.shape)
            logits_err[mode] = ((got - want).abs().max()
                                / want.abs().max()).item()
    require(max(logits_err.values()) <= COO_LOGITS_TOL,
            f"COO against dense logits: {logits_err}")

    def step(coo, where):
        wl = make(coo, where)
        o = make_optimizer(wl.model.parameters(), BASE_LR, weight_decay=0.0)
        m = train_step(wl, o, batch, where)
        return (float(m["loss"]),
                {n: None if p.grad is None else p.grad.detach().cpu()
                 for n, p in wl.model.named_parameters()},
                {k: v.cpu() for k, v in wl.model.state_dict().items()
                 if "running_" in k})

    fused_mp.reset_counts()
    first, second = step(True, dev), step(True, dev)
    require(_fused_total(fused_mp) == 0, "the COO step: no typed-mp kernel")
    same = (first[0] == second[0]
            and all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(first[1].values(), second[1].values()))
            and all(torch.equal(first[2][k], second[2][k])
                    for k in first[2]))
    require(same, "two COO steps give the same bits: loss, gradients, "
                  "running statistics")
    dense_loss = step(False, dev)[0]
    require(abs(first[0] - dense_loss) <= LOSS_RTOL * abs(dense_loss),
            f"COO loss {first[0]} against dense {dense_loss}")
    # the card's COO step against the CPU's and f64 at every seed pair,
    # each f32 run held to an f64 run that flips its decisions at their
    # kinks (a syn_coo_vs_cpu line each; a failed reading raises there)
    readings = [_syn_train_vs_cpu(torch, dev, d, i, coo=True)
                for d, i in SYN_VS_CPU_SEEDS]

    # the two steps timed in turns (dense, COO, COO, dense)
    d, c = make(False, dev), make(True, dev)
    od = make_optimizer(d.model.parameters(), BASE_LR, weight_decay=0.0)
    oc = make_optimizer(c.model.parameters(), BASE_LR, weight_decay=0.0)
    sd, sc = d.stage(batch, dev), c.stage(batch, dev)
    steps = {"dense": lambda: train_step(d, od, sd, dev),
             "coo": lambda: train_step(c, oc, sc, dev)}
    turns = [(name, cuda_ms(steps[name], 20, torch))
             for name in ("dense", "coo", "coo", "dense")]
    ms = {name: sum(t for n, t in turns if n == name) / 2 for name in steps}
    traced = {name: kernels_per_call(fn, 3) for name, fn in steps.items()}
    by_seed = {key: [r[i] for r in readings] for i, key in enumerate(
        ("card_vs_f64", "cpu_vs_f64", "card_vs_cpu"))}
    emit("syn_coo_vs_dense", seeds=[data_seed, init_seed],
         warm_steps=SYN_WARM_STEPS, batch_size=SYN_BATCH,
         logits_rel_err=logits_err, logits_tol=COO_LOGITS_TOL,
         loss_coo=first[0], loss_dense=dense_loss, same_bits=same,
         vs_cpu_seeds=[list(p) for p in SYN_VS_CPU_SEEDS],
         **{f"{k}_rel_l2_worst_by_seed": v for k, v in by_seed.items()},
         **{f"{k}_rel_l2_worst": max(v) for k, v in by_seed.items()},
         flipped_by_seed=[r[3] for r in readings],
         tol_rel_l2=GRAD_REL_L2, kink_tol=KINK_TOL,
         turns_ms=turns, coo_step_ms=ms["coo"], dense_step_ms=ms["dense"],
         kernels_per_step={n: k for n, (k, _) in traced.items()},
         device_busy_ms_per_step={n: b for n, (_, b) in traced.items()})
    return ms


def phase_syn_fixed(torch, fused_mp, dev, tmp):
    args = _syn_args("fixed", tmp, FIXED_STEPS, 1)
    require(args.model_name == "mp_nn", "the fixed workload runs mp_nn")
    res = _run_syn(torch, fused_mp, dev, "fixed", args, FIXED_STEPS, 1,
                   FIXED_PER_STEP)
    emit("syn_fixed", batch_size=SYN_BATCH, model_name=args.model_name,
         **res)
    return res


# --------------------------------------------------------------------------
# the JAX package's checkpoints (ROADMAP item 7)


def _fixture_tree(stored, prefix):
    """The (flax path, array) pairs stored under ``prefix/``."""
    return [(tuple(k[len(prefix) + 1:].split("/")), v)
            for k, v in stored.items() if k.startswith(prefix + "/")]


def check_jax_fixture(torch, dev):
    """The committed JAX checkpoints on ``dev``: each read through
    ``read_checkpoint`` into a fresh model and Adam, its eval logits
    against the JAX package's, then one step of the restored Adam on the
    stored gradients (the hop model's clipped as the trainer clips them)
    against optax's step.  Returns the readings by checkpoint."""
    import numpy as np

    from fgnn_tpu_torch.models import LDPCModel
    from fgnn_tpu_torch.models.from_jax import flax_tensors
    from fgnn_tpu_torch.train import synthetic
    from fgnn_tpu_torch.train.common import (
        clip_grad_norm,
        make_optimizer,
        read_checkpoint,
        set_lr,
    )
    from fgnn_tpu_torch.train.jax_checkpoint import restore_jax_payload
    from fgnn_tpu_torch.train.ldpc import decode_logits

    root = os.path.join(ROOT, JAX_FIXTURE_DIR)
    with np.load(os.path.join(root, JAX_FIXTURE)) as f:
        stored = dict(f)
    readings = {}
    for name in ("ldpc_tree", "ldpc_flat", "hop_tree", "hop_flat"):
        kind = name.split("_")[0]
        batch = {p[0]: v for p, v in _fixture_tree(stored, f"{kind}/batch")}
        if kind == "ldpc":
            model = LDPCModel(**JAX_FIXTURE_LDPC).to(dev)
        else:
            hop = JAX_FIXTURE_HOP
            args = synthetic.parse_args(
                ["--chain-length", str(hop["chain_length"]), "--hop-order",
                 str(hop["hop_order"]), "--batch-size",
                 str(len(batch["label"]))], "hop")
            args.dims = hop["dims"]
            wl = synthetic.SynWorkload("hop", args).to(dev)
            model = wl.model
        opt = make_optimizer(model.parameters(), 1.0, weight_decay=(
            1e-8 if kind == "ldpc" else 0.0))
        payload = read_checkpoint(os.path.join(root, f"{name}.pkl"))
        epoch, gcnt = restore_jax_payload(payload, model, opt)
        model.eval()
        with torch.no_grad():
            logits = (decode_logits(model, batch, dev) if kind == "ldpc"
                      else wl.logits(wl.stage(batch, dev)))
        want = torch.from_numpy(stored[f"{name}/logits"])
        require(tuple(logits.shape) == tuple(want.shape),
                f"{name}: logits {tuple(logits.shape)}")
        logits_err = (logits.cpu() - want).abs().max().item()

        set_lr(opt, float(stored["step_lr"]))
        params = dict(model.named_parameters())
        for n, g in flax_tensors(model, "params", _fixture_tree(
                stored, f"{kind}/grad")).items():
            params[n].grad = g.to(dev)
        if kind == "hop":
            clip_grad_norm(model.parameters(), 1.0)
        opt.step()
        after = flax_tensors(model, "params",
                             _fixture_tree(stored, f"{name}/after"))
        require(sorted(after) == sorted(params), f"{name}: every parameter")
        step_err = max((params[n].detach().cpu() - v).abs().max().item()
                       for n, v in after.items())
        readings[name] = dict(layout=payload["opt_layout"], epoch=epoch,
                              gcnt=gcnt, logits_max_abs_err=logits_err,
                              step_max_abs_err=step_err)
        require(logits_err <= JAX_LOGITS_TOL,
                f"{name}: logits {logits_err} from JAX's > {JAX_LOGITS_TOL}")
        require(step_err <= JAX_STEP_TOL,
                f"{name}: Adam step {step_err} from optax's > "
                f"{JAX_STEP_TOL}")
    return readings


def _ravel(tree):
    """A flax tree's leaves in ``optax.flatten``'s order (the keys sorted
    at every level), as one vector."""
    import numpy as np

    parts = []
    for key in sorted(tree):
        val = tree[key]
        parts.append(_ravel(val) if isinstance(val, dict)
                     else np.asarray(val).reshape(-1))
    return np.concatenate(parts)


def jax_payload(torch, model, optimizer, layout, epoch, gcnt):
    """The JAX trainer's checkpoint payload of a port model and its torch
    Adam, in ``layout``: each port tensor back at the flax path that
    ``flax_leaf`` maps to it (found among FLAX_LEAVES), transposed back
    where the map transposes, and the Adam moments in the parameters'
    tree, or raveled into one vector each (``"flat"``)."""
    import numpy as np

    from fgnn_tpu_torch.models.from_jax import flax_leaf
    from fgnn_tpu_torch.train import jax_checkpoint as jck

    state = model.state_dict()
    paths = {}
    for key in state:
        mod_path = key.rsplit(".", 1)[0] if "." in key else ""
        prefix = tuple(mod_path.split(".")) if mod_path else ()
        for collection in ("params", "batch_stats"):
            for leaf in FLAX_LEAVES:
                try:
                    hit = flax_leaf(model, collection, prefix + (leaf,),
                                    state)
                except KeyError:
                    continue
                if hit[0] == key:
                    paths[key] = (collection, prefix + (leaf,), hit[1])
        require(key in paths, f"{key}: a flax leaf maps to it")

    def put(tree, path, tensor, transpose):
        arr = tensor.detach().cpu().numpy()
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)

    trees = {"params": {}, "batch_stats": {}}
    for key, (collection, path, tr) in paths.items():
        put(trees[collection], path, state[key], tr)
    names = dict(model.named_parameters())
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for key, (collection, path, tr) in paths.items():
        if collection == "params":
            # a parameter whose gradient was always None (no path to the
            # loss) has no torch state; optax's moments of it are zeros
            p = names[key]
            st = optimizer.state.get(p) or {}
            if st:
                steps.add(float(st["step"]))
            for m in moments:
                put(moments[m], path, st.get(m, torch.zeros_like(p)), tr)
    require(len(steps) == 1, f"one Adam step count ({steps})")
    count = np.asarray(int(steps.pop()), np.int32)
    mu, nu = moments["exp_avg"], moments["exp_avg_sq"]
    if layout == "flat":
        mu, nu = _ravel(mu), _ravel(nu)
    adam = jck.ScaleByAdamState(count, mu, nu)
    hyper = {k: np.asarray(v, np.float32) for k, v in (
        ("b1", 0.9), ("b2", 0.999), ("eps", 1e-8), ("eps_root", 0.0),
        ("learning_rate", optimizer.param_groups[0]["lr"]))}
    opt_state = (jck.EmptyState(), jck.InjectStatefulHyperparamsState(
        count, hyper, {}, (adam, jck.EmptyState())))
    return {"format_version": jck.JAX_FORMAT_VERSION, "opt_layout": layout,
            **trees, "opt_state": opt_state, "gcnt": gcnt, "epoch": epoch,
            "extra": {}}


def phase_jax_checkpoint(torch, fused_mp, dev, grid):
    """(a) the committed JAX checkpoints on the card (``check_jax_fixture``);
    (b) the reference-width LDPC decoder after JAX_WARM_STEPS card steps,
    written as a JAX payload in each layout and restored through
    ``restore_jax_payload`` into a fresh model and Adam on the card:
    ``evaluate`` over the decode grid gives the source's BER matrix, the
    logits of a batch are bit-equal, and one more train step from each
    gives the same loss, parameters and Adam state to the bit, through the
    typed-mp kernels and no plain version."""
    from fgnn_tpu_torch.data import Codes, ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.jax_checkpoint import restore_jax_payload
    from fgnn_tpu_torch.train.ldpc import (
        BASE_LR,
        decode_logits,
        evaluate,
        parse_args,
        stage_batch,
        train_step,
    )

    fused_mp.reset_counts()
    fixture = check_jax_fixture(torch, dev)
    fixture_launches = _fused_total(fused_mp)

    model = init_weights(LDPCModel(), seed=3).to(dev)
    opt = make_optimizer(model.parameters(), BASE_LR)
    for b in ContinuousCodesSP(length=JAX_WARM_STEPS * BATCH,
                               seed=41).batches(BATCH):
        train_step(model, opt, b, dev)
    n_params = len(list(model.parameters()))
    elements = sum(p.numel() for p in model.parameters())
    args = parse_args(["--test-path", grid, "--batch-size", str(BATCH)])
    n_batches = len(Codes(grid)) // BATCH
    first = next(Codes(grid).batches(BATCH))
    step_batch = stage_batch(model, next(ContinuousCodesSP(
        length=BATCH, seed=42).batches(BATCH)), dev)
    _, _, ber_src, err_src = _count_decode(
        torch, fused_mp, evaluate, args, model.eval(), dev, n_batches)

    layouts, launched = {}, {"fwd": 0, "bwd": 0, "plain": 0}
    for layout in ("tree", "flat"):
        t0 = time.perf_counter()
        payload = jax_payload(torch, model, opt, layout, 7, 70)
        write_s = time.perf_counter() - t0
        fresh = LDPCModel().to(dev)
        fresh_opt = make_optimizer(fresh.parameters(), BASE_LR)
        t0 = time.perf_counter()
        require(restore_jax_payload(payload, fresh, fresh_opt) == (7, 70),
                f"{layout}: epoch and gcnt")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same_state = all(torch.equal(v, fresh.state_dict()[k])
                         for k, v in model.state_dict().items())
        _, _, ber, err = _count_decode(torch, fused_mp, evaluate, args,
                                       fresh.eval(), dev, n_batches)
        same_logits = torch.equal(decode_logits(model.eval(), first, dev),
                                  decode_logits(fresh, first, dev))
        # one more step from each: the source's copy and the restored
        src = copy.deepcopy(model)
        src_opt = make_optimizer(src.parameters(), BASE_LR)
        src_opt.load_state_dict(opt.state_dict())
        m_src = train_step(src, src_opt, step_batch, dev)
        m_new = train_step(fresh, fresh_opt, step_batch, dev)
        same_step = (torch.equal(m_src["loss"], m_new["loss"])
                     and all(torch.equal(v, fresh.state_dict()[k])
                             for k, v in src.state_dict().items())
                     and all(torch.equal(src_opt.state[p][k],
                                         fresh_opt.state[q][k])
                             for p, q in zip(src.parameters(),
                                             fresh.parameters())
                             for k in src_opt.state[p]))
        # the counts since _count_decode reset them: the decode, the
        # logits and the two steps
        launched["fwd"] += fused_mp.COUNTS["kernel_launches"]
        launched["bwd"] += fused_mp.BWD_COUNTS["kernel_launches"]
        launched["plain"] += (fused_mp.COUNTS["plain_calls"]
                              + fused_mp.BWD_COUNTS["plain_calls"])
        layouts[layout] = dict(
            payload_seconds=write_s, restore_seconds=restore_s,
            state_bit_equal=same_state, ber_total=float(ber),
            ber_matrix_equal=bool((err == err_src).all()),
            logits_bit_equal=same_logits, step_loss=float(m_new["loss"]),
            step_bit_equal=same_step)
        require(same_state and layouts[layout]["ber_matrix_equal"]
                and ber == ber_src and same_logits and same_step,
                f"{layout}: the restored decoder is the source's "
                f"({layouts[layout]})")
    require(launched["fwd"] > 0 and launched["bwd"] > 0,
            "the restored decoders ran the forward and backward kernels")
    require(launched["plain"] == 0, "no plain version on the card")
    emit("jax_checkpoint", fixture=fixture,
         fixture_typed_mp_launches=fixture_launches,
         logits_tol=JAX_LOGITS_TOL, step_tol=JAX_STEP_TOL,
         full_width={"params": n_params, "elements": elements,
                     "batch_size": BATCH, "warm_steps": JAX_WARM_STEPS,
                     "eval_batches": n_batches, "ber_total": float(ber_src),
                     "layouts": layouts},
         fwd_launches=launched["fwd"], bwd_launches=launched["bwd"],
         plain_calls=launched["plain"])
    return launched


# --------------------------------------------------------------------------
# the bf16 mode


def _ulp_bf16(torch, v):
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -120)))
    return torch.exp2(e - 7)


def _bf16_fail(msg):
    """A bf16 kernel-vs-plain check that failed: raises, or under
    ``--unrounded`` is noted in BF16_FAILED."""
    if BF16_FAILED is None:
        require(False, msg)
    BF16_FAILED.append(msg)


def _rel_l2(torch, got, ref, what, quantity):
    got, ref = got.float(), ref.float()
    require(torch.isfinite(got).all().item(), f"{what} finite")
    rel = ((got - ref).norm() / ref.norm()).item()
    BF16_READINGS[quantity].append(rel)
    if rel > BF16_KERNEL_REL_L2:
        _bf16_fail(f"{what}: {quantity} relative L2 error {rel} > "
                   f"{BF16_KERNEL_REL_L2}")
    return got, ref


def _check_bf16_out(torch, got, ref, what):
    """A bf16 out against the plain version's: one bf16 ulp per element
    plus KERNEL_TOL of the largest value, and BF16_KERNEL_REL_L2.  Returns
    the max abs error."""
    got, ref = _rel_l2(torch, got, ref, what, "out")
    err = (got - ref).abs()
    if not (err <= _ulp_bf16(torch, ref)
            + KERNEL_TOL * ref.abs().max()).all().item():
        _bf16_fail(f"{what}: out beyond one bf16 ulp (max abs err "
                   f"{err.max().item()})")
    return err.max().item()


def _check_grads(torch, got, ref, what):
    """A backward's (dh, d_etype) against the plain version's, each within
    BF16_KERNEL_REL_L2.  Returns the max abs error."""
    worst = 0.0
    for quantity, a, b in zip(("dh", "d_etype"), got, ref):
        a, b = _rel_l2(torch, a, b, f"{what} {quantity}", quantity)
        worst = max(worst, (a - b).abs().max().item())
    return worst


def _worst_readings(start=None):
    """The largest BF16_READINGS of each quantity, of those after
    ``start`` (the lengths at a phase's start)."""
    return {q: max(v[start[q] if start else 0:], default=0.0)
            for q, v in BF16_READINGS.items()}


def _same_bits(torch, a, b, what):
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{what}: two launches give the same bits")


def _time_modes(torch, call, plain, slabs, check, kept=None):
    """``call(dtype, slab)`` of the f32 and bf16 instantiations, and with
    ``kept`` the bf16 mode's kept route, timed in turns (f32, kept, bf16,
    bf16, kept, f32), the bf16 plain version, and every bf16 slab of
    ``slabs`` (the staged kernels), each checked by ``check(result, slab)``
    first.  Returns (timings, worst error of the slabs)."""
    f32, b16 = torch.float32, torch.bfloat16
    order = [("f32", lambda: call(f32, None))]
    if kept is not None:
        order.append(("kept", kept))
    order.append(("bf16", lambda: call(b16, None)))
    runs = {name: [] for name, _ in order}
    turns = []
    for name, fn in order + order[::-1]:
        runs[name].append(device_ms(fn, 200, torch))
        turns.append([name, runs[name][-1][0]])
    plain_ms, _ = device_ms(plain, 20, torch)
    worst, slab_ms = 0.0, {}
    for cs in slabs:
        got = call(b16, cs)
        torch.cuda.synchronize()
        worst = max(worst, check(got, cs))
        slab_ms[cs] = device_ms(lambda s=cs: call(b16, s), 200, torch)[0]
    mean = {name: sum(r[0] for r in v) / len(v) for name, v in runs.items()}
    res = dict(ms=mean["bf16"], f32_ms=mean["f32"], ms_in_turns=turns,
               wrapper_host_ms=runs["bf16"][0][1], plain_ms=plain_ms,
               bf16_over_f32=mean["bf16"] / mean["f32"], slab_ms=slab_ms)
    if kept is not None:
        res.update(kept_ms=mean["kept"], new_over_kept=mean["bf16"]
                   / mean["kept"])
    return res, worst


def _bf16_fwd_bytes(B, rows, Nd, K, T, C, argmax):
    """A forward's bytes in the bf16 mode: h and out bf16, the table and
    etype 4 bytes, the argmax 1."""
    return (2 * B * rows * T * C + 4 * Nd * K + 4 * B * Nd * K * T
            + 2 * B * Nd * C + (B * Nd * C if argmax else 0))


def _bf16_bwd_bytes(B, rows, Nd, K, T, C, agg, table_ints):
    """A backward's bytes in the bf16 mode: g, h and dh bf16, the argmax
    (max) 1 byte or the f32 log-sum-exp (softmax) 4, etype and d_etype and
    the tables 4."""
    saved = B * Nd * C * (1 if agg == "max" else
                          4 if agg == "softmax" else 0)
    return (2 * B * Nd * C + saved + 2 * 2 * B * rows * T * C
            + 2 * 4 * B * Nd * K * T + 4 * table_ints)


def _route_bits(torch, new, kept, what):
    """The new bf16 route against the kept one: the same bits."""
    if not all(torch.equal(a, b) for a, b in zip(new, kept)):
        _bf16_fail(f"{what}: the new and the kept route give other bits")


# Batches at which the new bf16 routes are timed against the kept ones
# beside the path's B=256: the forward's sample route around its plan's
# threshold (fused_mp.fwd_sample: one sample for every second SM, B >= 66)
# and the LDPC CLI's default of 32, the backward's packed products at 32
# and 66.
BATCH_SWEEP = {"typed_mp_fwd": (32, 48, 66, 96, 132),
               "typed_mp_bwd": (32, 66)}


def _sample_fwd(torch, fused_mp, h, idx, et, want_argmax):
    """The bf16 forward's sample route launched at any batch, the plan
    aside (``typed_mp_fwd_sample`` through ``fused_mp._launch``; counted
    nowhere): the timing of a route the plan does not take."""
    B, N, T, C = h.shape
    Nd, K = idx.shape
    out = h.new_empty((B, Nd, C))
    am = (h.new_empty((B, Nd, C), dtype=torch.uint8) if want_argmax
          else None)
    fused_mp._launch("typed_mp_fwd", "typed_mp_fwd_sample", h.device,
                     (B, N, Nd, K, T, C), h.data_ptr(), idx.data_ptr(),
                     et.data_ptr(), out.data_ptr(), fused_mp._ptr(am), None,
                     B, N, Nd, K, T, C, fused_mp.AGGREGATORS["max"], 3.0)
    return (out, am) if want_argmax else out


def _time_batches(torch, fused_mp):
    """At each LDPC path shape and each batch of BATCH_SWEEP: the new bf16
    route (the forward's sample route with the argmax, the backward's
    packed products for max) and the kept one, bit-equal, then timed in
    turns (new, kept, kept, new) with ``device_ms``; beside them the route
    the plan takes at that batch."""
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    b16 = torch.bfloat16
    for si, (name, _, N, Nd, K, T, C, per_fwd, _) in enumerate(SHAPES):
        if not per_fwd:
            continue
        for kernel, batches in BATCH_SWEEP.items():
            for B in batches:
                h32, idx, et = _inputs(torch, B, N, Nd, K, T, C, 1000 + si)
                h = h32.to(b16)
                if kernel == "typed_mp_fwd":
                    planned = ("sample" if fused_mp.fwd_sample(
                        B, N, Nd, K, T, C, 2) else "kept")
                    calls = {
                        "new": lambda: _sample_fwd(torch, fused_mp, h, idx,
                                                   et, True),
                        "kept": lambda: fused_mp.typed_gather_mix_agg(
                            h, idx, et, "max", 3.0, True, slab=0)}
                else:
                    table = GatherTable(idx.cpu().numpy(), N).to("cuda")
                    _, am = fused_mp.typed_gather_mix_agg(
                        h, idx, et, "max", 3.0, True, slab=0)
                    g = torch.randn(B, Nd, C, device="cuda").to(b16)
                    planned = ("packed" if fused_mp.bwd_packed(
                        C, fused_mp.bwd_slab(B, N, Nd, K, T, C, "max", 2),
                        "max", 2) else "kept")

                    def bwd(packed):
                        return fused_mp.typed_gather_mix_agg_bwd(
                            g, h, idx, table.src_ptr, table.src_edge, et,
                            "max", 3.0, argmax=am, packed=packed)

                    calls = {"new": lambda: bwd(None),
                             "kept": lambda: bwd(False)}
                new, kept = calls["new"](), calls["kept"]()
                torch.cuda.synchronize()
                _route_bits(torch, new, kept, f"{name} B={B} {kernel}")
                runs = {"new": [], "kept": []}
                for route in ("new", "kept", "kept", "new"):
                    runs[route].append(
                        device_ms(calls[route], 200, torch)[0] * 1e3)
                us = {r: sum(v) / len(v) for r, v in runs.items()}
                emit("kernel_check_bf16", name="batch_sweep", kernel=kernel,
                     shape=name, B=B, planned=planned, new_us=us["new"],
                     kept_us=us["kept"], us_in_turns=runs,
                     new_over_kept=us["new"] / us["kept"])


def phase_kernel_check_bf16(torch, fused_mp):
    """The NO_EXTENSION forward (the sample route and the kept kernel) and
    the staged backward (packed and scalar products) in the bf16 mode
    against their plain versions at every LDPC and ragged shape, all four
    aggregators; the new routes bit-equal to the kept ones wherever the
    plan takes them, each launch counted under the route that ran; two
    launches bit-equal; at the path shapes the f32 instantiation and both
    bf16 routes timed in turns, and every bf16 slab of the backward; then
    ``_time_batches``."""
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    b16 = torch.bfloat16
    worst, fwd_rows, bwd_rows = 0.0, [], []
    start = {q: len(v) for q, v in BF16_READINGS.items()}
    # the (shape, aggregator) cases where a new route ran beside the kept
    compared = {"typed_mp_fwd": [], "typed_mp_bwd": []}
    for si, (name, B, N, Nd, K, T, C, per_fwd, per_step) in enumerate(
            SHAPES):
        h32, idx, et = _inputs(torch, B, N, Nd, K, T, C, 600 + si)
        h = h32.to(b16)
        table = GatherTable(idx.cpu().numpy(), N).to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(700 + si)
        g = torch.randn(B, Nd, C, device="cuda", generator=gen).to(b16)
        saved = {}
        # the sample route at the path shapes; the ragged ones (a few
        # samples, C % 8 != 0) take the kept kernel through the plan
        sample = fused_mp.fwd_sample(B, N, Nd, K, T, C, 2)
        require(sample == bool(per_fwd),
                f"{name}: the bf16 forward's plan takes the sample route "
                f"at the path shapes only")
        planned = fused_mp.COUNTS if sample else fused_mp.KEPT_BF16_COUNTS
        for agg in AGGS:
            kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
            before = planned["bf16_launches"]
            runs = [fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, **kw)
                    for _ in range(2)]
            ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0,
                                                      **kw)
            torch.cuda.synchronize()
            require(planned["bf16_launches"] == before + 2,
                    f"{name} {agg}: two launches of the planned bf16 "
                    f"forward")
            two = agg in ("max", "softmax")
            first, again = ((r if two else (r,)) for r in runs)
            ref = ref if two else (ref,)
            _same_bits(torch, first, again, f"{name} {agg} bf16 forward")
            require(first[0].dtype == b16, f"{name} {agg}: a bf16 out")
            worst = max(worst, _check_bf16_out(torch, first[0], ref[0],
                                               f"{name} {agg} bf16"))
            if agg == "softmax":  # the f32 log-sum-exp
                err = (first[1] - ref[1]).abs().max().item()
                if err > KERNEL_TOL * ref[1].abs().max().item():
                    _bf16_fail(f"{name} bf16 lse: max abs err {err}")
                worst = max(worst, err)
            if agg == "max" and K > 1:
                msgs = (h.float()[:, idx.long()]
                        * et.to(b16).float()[..., None]).sum(dim=3)
                top2 = msgs.topk(2, dim=2).values
                clear = ((top2[:, :, 0] - top2[:, :, 1])
                         > 2.0 ** -8 * top2[:, :, 0].abs())
                if not (first[1] == ref[1])[clear].all().item():
                    _bf16_fail(f"{name}: bf16 argmax differs where the gap "
                               "is clear")
            # the kept route: the first kernel's bf16 instantiation
            before = fused_mp.KEPT_BF16_COUNTS["kernel_launches"]
            kept = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0,
                                                 slab=0, **kw)
            torch.cuda.synchronize()
            require(fused_mp.KEPT_BF16_COUNTS["kernel_launches"]
                    == before + 1, f"{name} {agg}: a kept bf16 forward")
            kept = kept if two else (kept,)
            worst = max(worst, _check_bf16_out(torch, kept[0], ref[0],
                                               f"{name} {agg} bf16 kept"))
            if sample:
                _route_bits(torch, first, kept, f"{name} {agg} bf16 forward")
                compared["typed_mp_fwd"].append(f"{name} {agg}")
            am = first[1] if agg == "max" else None
            lse = first[1] if agg == "softmax" else None
            saved[agg] = (am, lse)
            # the packed products for max, sum and mean on the vector path;
            # softmax (f32 dm) and C=30 run the scalar ones on either route
            packs = fused_mp.bwd_packed(
                C, fused_mp.bwd_slab(B, N, Nd, K, T, C, agg, 2), agg, 2)
            before = fused_mp.BWD_COUNTS["bf16_launches"]
            kept_before = fused_mp.KEPT_BF16_BWD_COUNTS["kernel_launches"]
            bwd = [fused_mp.typed_gather_mix_agg_bwd(
                g, h, idx, table.src_ptr, table.src_edge, et, agg, 3.0,
                argmax=am, out=lse, packed=packed)
                for packed in (None, None, False)]
            bref = fused_mp.typed_gather_mix_agg_bwd_plain(
                g, h, idx, et, agg, 3.0, argmax=am, out=lse)
            torch.cuda.synchronize()
            require(fused_mp.BWD_COUNTS["bf16_launches"] - before
                    == (2 if packs else 0)
                    and fused_mp.KEPT_BF16_BWD_COUNTS["kernel_launches"]
                    - kept_before == (1 if packs else 3),
                    f"{name} {agg}: the bf16 backward's launches counted "
                    f"under the route that ran (packed: {packs})")
            _same_bits(torch, bwd[0], bwd[1], f"{name} {agg} bf16 backward")
            require(bwd[0][0].dtype == b16
                    and bwd[0][1].dtype == torch.float32,
                    f"{name} {agg}: bf16 dh, f32 d_etype")
            for route, res in (("", bwd[0]), (" kept", bwd[2])):
                worst = max(worst, _check_grads(torch, res, bref,
                                                f"{name} {agg} bf16{route}"))
            if packs:
                _route_bits(torch, bwd[0], bwd[2],
                            f"{name} {agg} bf16 backward")
                compared["typed_mp_bwd"].append(f"{name} {agg}")
        if per_fwd == 0:
            continue
        # the path's calls: max, the argmax for training, none for decode
        for argmax in (False, True):
            timing, _ = _time_modes(
                torch, lambda d, _s, a=argmax: fused_mp.typed_gather_mix_agg(
                    h32.to(d) if d != b16 else h, idx, et, "max", 3.0, a),
                lambda a=argmax: fused_mp.typed_gather_mix_agg_plain(
                    h, idx, et, "max", 3.0, a), (), None,
                kept=lambda a=argmax: fused_mp.typed_gather_mix_agg(
                    h, idx, et, "max", 3.0, a, slab=0))
            nbytes = _bf16_fwd_bytes(B, N, Nd, K, T, C, argmax)
            ops = B * Nd * K * C * (2 * T + 1)
            fwd_rows.append(dict(
                name=name, argmax=argmax, B=B, N_src=N, Nd=Nd, K=K, T=T, C=C,
                bf16_per_forward=BF16_FWD[name], f32_per_forward=per_fwd
                - BF16_FWD[name], **timing, bytes=nbytes, ops=ops,
                bound_ms=bound_ms(nbytes, ops),
                bound_by=bound_by(nbytes, ops),
                gbytes_per_s=nbytes / timing["ms"] / 1e6,
                kept_gbytes_per_s=nbytes / timing["kept_ms"] / 1e6))
            emit("kernel_check_bf16", kernel="typed_mp_fwd", **fwd_rows[-1],
                 max_abs_err=worst)
        am, _ = saved["max"]
        h_f32 = h.float()
        g_f32 = g.float()

        def bwd_call(d, slab, packed=None):
            if d == b16:
                return fused_mp.typed_gather_mix_agg_bwd(
                    g, h, idx, table.src_ptr, table.src_edge, et, "max", 3.0,
                    argmax=am, slab=slab, packed=packed)
            return fused_mp.typed_gather_mix_agg_bwd(
                g_f32, h_f32, idx, table.src_ptr, table.src_edge, et, "max",
                3.0, argmax=am, slab=slab)

        bref = fused_mp.typed_gather_mix_agg_bwd_plain(
            g, h, idx, et, "max", 3.0, argmax=am)

        def check(got, cs, bref=bref):
            return _check_grads(torch, got, bref, f"{name} bf16 slab {cs}")

        timing, err = _time_modes(
            torch, bwd_call, lambda: fused_mp.typed_gather_mix_agg_bwd_plain(
                g, h, idx, et, "max", 3.0, argmax=am),
            fused_mp.staged_slabs(N, Nd, K, T, C, "max", 2), check,
            kept=lambda: bwd_call(b16, None, False))
        worst = max(worst, err)
        nbytes = _bf16_bwd_bytes(B, N, Nd, K, T, C, "max",
                                 2 * idx.numel() + N + 1)
        ops = B * Nd * K * C * (4 * T + 1)
        slab = fused_mp.bwd_slab(B, N, Nd, K, T, C, "max", 2)
        bwd_rows.append(dict(
            name=name, B=B, N_src=N, Nd=Nd, K=K, T=T, C=C,
            bf16_per_step=BF16_BWD[name], f32_per_step=per_step
            - BF16_BWD[name], **timing, slab=slab,
            slab_bytes=fused_mp.staged_bytes(N, Nd, K, T, slab, "max", 2),
            bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
            bound_by=bound_by(nbytes, ops),
            gbytes_per_s=nbytes / timing["ms"] / 1e6,
            kept_gbytes_per_s=nbytes / timing["kept_ms"] / 1e6))
        emit("kernel_check_bf16", kernel="typed_mp_bwd", **bwd_rows[-1],
             max_abs_err=worst)

    # all ties in bf16: the first-win argmax is 0, and the whole cotangent
    # goes to k = 0
    B, N, Nd, K, T, C = 8, 16, 16, 3, 2, 16
    h = torch.randn(1, 1, T, C, device="cuda").to(b16).expand(
        B, N, T, C).contiguous()
    idx = torch.zeros(Nd, K, dtype=torch.int32, device="cuda")
    table = GatherTable(idx.cpu().numpy(), N).to("cuda")
    et = torch.ones(B, Nd, K, T, device="cuda")
    _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max", want_argmax=True)
    require(am.max().item() == 0, "bf16 all-ties argmax is 0")
    g = torch.randn(B, Nd, C, device="cuda").to(b16)
    _, det = fused_mp.typed_gather_mix_agg_bwd(
        g, h, idx, table.src_ptr, table.src_edge, et, "max", argmax=am)
    require(not det[:, :, 1:].any().item() and det[:, :, 0].any().item(),
            "bf16 all ties: d_etype only at k = 0")
    emit("kernel_check_bf16", name="all_ties", max_abs_err=worst,
         rel_l2_worst=_worst_readings(start), tol_rel_l2=BF16_KERNEL_REL_L2,
         new_vs_kept_bits=compared)
    if BF16_FAILED is None:
        _time_batches(torch, fused_mp)
    # per bf16 decode forward (15 launches), per bf16 train step (15
    # forward launches with the argmax, 14 backward): us, bound, GB/s
    for what, kernel, rows, per in (
            ("per_bf16_forward", "typed_mp_fwd",
             [r for r in fwd_rows if not r["argmax"]], "bf16_per_forward"),
            ("per_bf16_step", "typed_mp_fwd",
             [r for r in fwd_rows if r["argmax"]], "bf16_per_forward"),
            ("per_bf16_step", "typed_mp_bwd", bwd_rows, "bf16_per_step")):
        tot = {key: sum(r[key] * r[per] for r in rows)
               for key in ("ms", "kept_ms", "f32_ms", "bytes", "ops")}
        emit("kernel_check_bf16", name=what, kernel=kernel,
             new_us=tot["ms"] * 1e3, kept_us=tot["kept_ms"] * 1e3,
             f32_us=tot["f32_ms"] * 1e3,
             bound_us=bound_ms(tot["bytes"], tot["ops"]) * 1e3,
             gbytes_per_s=tot["bytes"] / tot["ms"] / 1e6,
             kept_gbytes_per_s=tot["bytes"] / tot["kept_ms"] / 1e6,
             new_over_kept=tot["ms"] / tot["kept_ms"])
    return worst, fwd_rows, bwd_rows


# The routes of the DIFF/NEIGHBOR mode's bf16 forward and backward, with
# the counter each launch lands in: the bf16 design as planned, the kept
# staged route (kept=True: the f32 mode's design, as the bf16 mode first
# ran it) and, for the forward, the first kernel (slab=0); for the
# backward, the kept scalar products (packed=False).
EXT_BF16_FWD_ROUTES = (("new", {}, "EXT_COUNTS"),
                       ("kept", dict(kept=True), "KEPT_BF16_EXT_COUNTS"),
                       ("first", dict(slab=0), "KEPT_EXT_COUNTS"))
EXT_BF16_BWD_ROUTES = (("new", {}, None),
                       ("kept", dict(kept=True), "KEPT_BF16_EXT_BWD_COUNTS"),
                       ("scalar", dict(packed=False),
                        "KEPT_BF16_EXT_BWD_COUNTS"))


def _ext_bwd_new_counter(fused_mp, B, N, K, T, C, agg):
    """Where the bf16 design's backward launch counts: the design's counter
    wherever it runs (ext_bwd_kernel, or the staged kernel in more than
    one tile of rows), else the kept route's."""
    slab = fused_mp.bwd_slab(B, 2 * N, N, K, T, C, agg, 2)
    design = (fused_mp.bwd_ext_plan(B, 2 * N, N, K, T, C, agg)[0] > 0
              or fused_mp.bwd_ext_tiles(B, N, C, slab) > 1)
    return "EXT_BWD_COUNTS" if design else "KEPT_BF16_EXT_BWD_COUNTS"


def _counted(fused_mp, counter, what, fn):
    """``fn()``, which must add exactly one launch to ``counter``."""
    counts = getattr(fused_mp, counter)
    before = counts["bf16_launches"]
    res = fn()
    require(counts["bf16_launches"] == before + 1,
            f"{what}: one launch counted in {counter}")
    return res


def phase_kernel_check_ext_bf16(torch, fused_mp):
    """Every route of the DIFF/NEIGHBOR forward and backward in the bf16
    mode (EXT_BF16_FWD_ROUTES, EXT_BF16_BWD_ROUTES) at every extension
    shape and aggregator: against the plain versions, two launches
    bit-equal, each launch counted under its route; the forward's max
    (out and argmax) bit-equal across its three routes; the backward's dh
    bit-equal across its routes for max, sum and mean; at the path shapes
    the f32 instantiation, the kept route and the bf16 design timed in
    turns, with every slab of the design; an all-ties case."""
    b16 = torch.bfloat16
    worst, fwd_rows, bwd_rows = 0.0, [], []
    start = {q: len(v) for q, v in BF16_READINGS.items()}
    dh_bits = []  # the backward's cases with dh bit-equal across routes
    for si, (name, B, N, K, T, C, path_agg, per_hop, _) in enumerate(
            EXT_SHAPES):
        h32, table, et = _ext_inputs(torch, B, N, K, T, C, 800 + si)
        h, idx = h32.to(b16), table.idx
        gen = torch.Generator(device="cuda").manual_seed(900 + si)
        g = torch.randn(B, N, C, device="cuda", generator=gen).to(b16)
        saved = {}
        for agg in AGGS:
            require(fused_mp.fwd_bf16_plan(B, 2 * N, N, K, T, C)[0] > 0,
                    f"{name} {agg}: the bf16 forward design is planned")
            kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
            two = agg in ("max", "softmax")
            ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0,
                                                      ext=True, **kw)
            ref = ref if two else (ref,)
            routes = {}
            for route, extra, counter in EXT_BF16_FWD_ROUTES:
                runs = [_counted(
                    fused_mp, counter, f"{name} {agg} bf16 {route} forward",
                    lambda: fused_mp.typed_gather_mix_agg(
                        h, idx, et, agg, 3.0, ext=True, **kw, **extra))
                    for _ in range(2)]
                torch.cuda.synchronize()
                first, again = ((r if two else (r,)) for r in runs)
                _same_bits(torch, first, again,
                           f"{name} {agg} bf16 {route} forward")
                worst = max(worst, _check_bf16_out(
                    torch, first[0], ref[0], f"{name} {agg} bf16 {route}"))
                routes[route] = first
            if agg == "max":
                for route in ("kept", "first"):
                    require(all(torch.equal(a, b) for a, b in zip(
                        routes["new"], routes[route])),
                        f"{name}: bf16 max bit-equal between the design and "
                        f"the {route} route")
                hg = h.float()[:, 0::2, None] + h.float()[:, 1::2][
                    :, idx.long()]
                msgs = (hg * et.to(b16).float()[..., None]).sum(dim=3)
                top2 = msgs.topk(2, dim=2).values
                clear = ((top2[:, :, 0] - top2[:, :, 1])
                         > 2.0 ** -8 * top2[:, :, 0].abs())
                if not (routes["new"][1] == ref[1])[clear].all().item():
                    _bf16_fail(f"{name}: bf16 argmax differs where the gap "
                               "is clear")
            am = routes["new"][1] if agg == "max" else None
            lse = routes["new"][1] if agg == "softmax" else None
            saved[agg] = (am, lse)
            bref = fused_mp.typed_gather_mix_agg_bwd_plain(
                g, h, idx, et, agg, 3.0, argmax=am, out=lse, ext=True)
            bwd = {}
            for route, extra, counter in EXT_BF16_BWD_ROUTES:
                counter = counter or _ext_bwd_new_counter(
                    fused_mp, B, N, K, T, C, agg)
                runs = [_counted(
                    fused_mp, counter, f"{name} {agg} bf16 {route} backward",
                    lambda: fused_mp.typed_gather_mix_agg_bwd(
                        g, h, idx, table.ext_ptr, table.ext_edge, et, agg,
                        3.0, argmax=am, out=lse, ext=True, **extra))
                    for _ in range(2)]
                torch.cuda.synchronize()
                _same_bits(torch, runs[0], runs[1],
                           f"{name} {agg} bf16 {route} backward")
                worst = max(worst, _check_grads(
                    torch, runs[0], bref, f"{name} {agg} bf16 {route}"))
                bwd[route] = runs[0]
            if agg != "softmax":
                for route in ("kept", "scalar"):
                    _route_bits(torch, bwd["new"][:1], bwd[route][:1],
                                f"{name} {agg} bf16 backward dh ({route})")
                dh_bits.append(f"{name} {agg}")
        if path_agg is None:
            continue
        want = path_agg == "max"
        am, lse = saved[path_agg]
        kw = dict(want_argmax=want)
        ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, path_agg, 3.0,
                                                  ext=True, **kw)
        ref = ref if want else (ref,)

        def fwd_call(d, slab, agg=path_agg, kw=kw, kept=False):
            x = h if d == b16 else h32
            return fused_mp.typed_gather_mix_agg(
                x, idx, et, agg, 3.0, ext=True, slab=slab, kept=kept, **kw)

        def fwd_check(got, cs, want=want, ref=ref):
            got = got if want else (got,)
            return _check_bf16_out(torch, got[0], ref[0],
                                   f"{name} bf16 slab {cs}")

        timing, err = _time_modes(
            torch, fwd_call, lambda agg=path_agg, kw=kw:
            fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0,
                                                ext=True, **kw),
            fused_mp.fwd_bf16_slabs(2 * N, N, K, T, C), fwd_check,
            kept=lambda: fwd_call(b16, None, kept=True))
        worst = max(worst, err)
        nbytes = _bf16_fwd_bytes(B, 2 * N, N, K, T, C, want)
        ops = B * N * K * C * (3 * T + 1)
        slab, tiles = fused_mp.fwd_bf16_plan(B, 2 * N, N, K, T, C)
        fwd_rows.append(dict(
            name=name, B=B, N=N, K=K, T=T, C=C, aggregator=path_agg,
            argmax=want, per_hop_step=per_hop, **timing, slab=slab,
            tiles=tiles, kept_slab=fused_mp.fwd_slab(
                B, 2 * N, N, K, T, C, path_agg, 2),
            bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
            bound_by=bound_by(nbytes, ops),
            gb_per_s=nbytes / timing["ms"] * 1e-6))
        emit("kernel_check_ext_bf16", kernel="typed_mp_fwd", **fwd_rows[-1],
             max_abs_err=worst)
        h_f32, g_f32 = h.float(), g.float()

        def bwd_call(d, slab, agg=path_agg, am=am, lse=lse, kept=False):
            x, gg = (h, g) if d == b16 else (h_f32, g_f32)
            return fused_mp.typed_gather_mix_agg_bwd(
                gg, x, idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
                argmax=am, out=lse, ext=True, slab=slab, kept=kept)

        bref = fused_mp.typed_gather_mix_agg_bwd_plain(
            g, h, idx, et, path_agg, 3.0, argmax=am, out=lse, ext=True)

        def bwd_check(got, cs, bref=bref):
            return _check_grads(torch, got, bref, f"{name} bf16 slab {cs}")

        slab, tiles = fused_mp.bwd_ext_plan(B, 2 * N, N, K, T, C, path_agg)
        if not slab:  # the staged kernel in tiles of rows
            slab = fused_mp.bwd_slab(B, 2 * N, N, K, T, C, path_agg, 2)
            tiles = fused_mp.bwd_ext_tiles(B, N, C, slab)
        timing, err = _time_modes(
            torch, bwd_call, lambda agg=path_agg, am=am, lse=lse:
            fused_mp.typed_gather_mix_agg_bwd_plain(
                g, h, idx, et, agg, 3.0, argmax=am, out=lse, ext=True),
            fused_mp.bwd_ext_slabs(B, 2 * N, N, K, T, C, path_agg)
            or fused_mp.staged_slabs(2 * N, N, K, T, C, path_agg, 2),
            bwd_check, kept=lambda: bwd_call(b16, None, kept=True))
        worst = max(worst, err)
        nbytes = _bf16_bwd_bytes(B, 2 * N, N, K, T, C, path_agg,
                                 idx.numel() + table.ext_ptr.numel()
                                 + table.ext_edge.numel())
        ops = B * N * K * C * (7 * T + 1 + (3 * T if path_agg == "softmax"
                                            else 0))
        bwd_rows.append(dict(
            name=name, B=B, N=N, K=K, T=T, C=C, aggregator=path_agg,
            per_hop_step=per_hop, **timing, slab=slab, tiles=tiles,
            route=("ext_bwd_kernel" if fused_mp.bwd_ext_plan(
                B, 2 * N, N, K, T, C, path_agg)[0] else
                "staged_bwd_kernel in tiles"),
            kept_slab=fused_mp.bwd_slab(B, 2 * N, N, K, T, C, path_agg, 2),
            bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
            bound_by=bound_by(nbytes, ops),
            gb_per_s=nbytes / timing["ms"] * 1e-6))
        emit("kernel_check_ext_bf16", kernel="typed_mp_bwd", **bwd_rows[-1],
             max_abs_err=worst)

    B, N, K, T, C = 8, 16, 9, 2, 16
    h = torch.randn(1, 1, T, C, device="cuda").to(b16).expand(
        B, 2 * N, T, C).contiguous()
    idx = torch.zeros(N, K, dtype=torch.int32, device="cuda")
    et = torch.ones(B, N, K, T, device="cuda")
    for route, extra, _ in EXT_BF16_FWD_ROUTES:
        _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max",
                                              want_argmax=True, ext=True,
                                              **extra)
        require(am.max().item() == 0,
                f"bf16 all-ties argmax is 0 (extensions, {route})")
    per_step = {}
    for what, rows in (("fwd", fwd_rows), ("bwd", bwd_rows)):
        per_step[what] = {key: sum(r[key] * r["per_hop_step"] for r in rows)
                          for key in ("ms", "kept_ms", "f32_ms", "bound_ms")}
    emit("kernel_check_ext_bf16", name="all_ties", max_abs_err=worst,
         rel_l2_worst=_worst_readings(start), tol_rel_l2=BF16_KERNEL_REL_L2,
         dh_bits_across_routes=dh_bits, per_bf16_hop_step=per_step)
    return worst, fwd_rows, bwd_rows


def phase_decode_bf16(torch, fused_mp, dev, model, batch, path):
    """``train.ldpc.evaluate`` with ``--bf16`` over the decode phase's eval
    grid, the same weights: 15 bf16 and 1 f32 forward launches per batch,
    no plain version; the bf16 logits against the f32 logits of one
    batch."""
    from fgnn_tpu_torch.data import Codes
    from fgnn_tpu_torch.models.policy import compute_dtype
    from fgnn_tpu_torch.train.ldpc import (
        decode_logits,
        decode_step,
        evaluate,
        model_inputs,
        parse_args,
    )

    args = parse_args(["--bf16", "--test-path", path, "--batch-size",
                       str(BATCH), "--eval-per-cell", str(EVAL_PER_CELL)])
    n_batches = len(Codes(path)) // BATCH
    with compute_dtype(torch.bfloat16):
        decode_step(model, batch, dev)  # warm-up
    torch.cuda.synchronize()
    fused_mp.reset_counts()
    t0 = time.perf_counter()
    ber_total, err = evaluate(args, model, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fused_mp.COUNTS)
    require(counts["kernel_launches"] == FWD_PER_STEP * n_batches,
            f"bf16 decode: {counts['kernel_launches']} forward launches")
    require(counts["bf16_launches"] == BF16_FWD_PER_STEP * n_batches,
            f"bf16 decode: {counts['bf16_launches']} bf16 launches != "
            f"{BF16_FWD_PER_STEP} x {n_batches}")
    require(counts["plain_calls"] == 0, "no plain calls on the card")
    require(fused_mp.KEPT_BF16_COUNTS["kernel_launches"] == 0,
            "bf16 decode: every bf16 launch on the sample route, none on "
            "the kept kernel")
    require(0.0 <= ber_total <= 1.0 and err.shape == (5, 6),
            "BER in [0, 1], 5 x 6 matrix")
    f32 = decode_logits(model, batch, dev).double()
    with compute_dtype(torch.bfloat16):
        got = decode_logits(model, batch, dev).double()
        inputs = model_inputs(model, batch, dev)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(**inputs), 20, torch)
    require(got.shape == (BATCH, 48) and torch.isfinite(got).all().item(),
            "finite bf16 logits (256, 48)")
    rel = ((got - f32).norm() / f32.norm()).item()
    require(rel <= DECODE_BF16_REL_L2,
            f"bf16 logits {rel} relative L2 from f32 > {DECODE_BF16_REL_L2}")
    words = n_batches * BATCH
    emit("decode_bf16", words=words, batches=n_batches, batch_size=BATCH,
         seconds=seconds, words_per_s=words / seconds,
         edges_per_s=words * EDGES_PER_WORD / seconds, forward_ms=fwd_ms,
         forward_words_per_s=BATCH / fwd_ms * 1e3, ber_total=float(ber_total),
         logits_rel_l2_vs_f32=rel, tol_rel_l2=DECODE_BF16_REL_L2,
         decisions_agree=((got >= 0) == (f32 >= 0)).double().mean().item(),
         kernel_launches=counts["kernel_launches"],
         bf16_launches=counts["bf16_launches"],
         kept_bf16_launches=fused_mp.KEPT_BF16_COUNTS["kernel_launches"],
         plain_calls=counts["plain_calls"])
    return counts["bf16_launches"], fused_mp.KEPT_BF16_COUNTS[
        "kernel_launches"]


def phase_train_bf16(torch, fused_mp, dev, tmp):
    """20 LDPC steps (``train.ldpc.train``) and 20 hop steps with 4 eval
    batches (``train.synthetic.train_and_eval``) with ``--bf16``, at the
    reference widths: finite losses, and every launch the path makes in the
    bf16 mode but layer 6's v2f conv (f32 x) on the LDPC path."""
    from fgnn_tpu_torch.data import ContinuousCodesSP, batches
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.models.policy import compute_dtype
    from fgnn_tpu_torch.train import ldpc, synthetic
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.utils.logging import MetricsWriter

    args = ldpc.parse_args([
        "--train", "--bf16", "--n-epochs", "1", "--steps-per-epoch",
        str(TRAIN_STEPS), "--batch-size", str(BATCH),
        "--samples-per-epoch", str(TRAIN_STEPS * BATCH), "--seed", "0"])
    model = init_weights(LDPCModel(), seed=0).to(dev)
    warm = init_weights(LDPCModel(), seed=1).to(dev)
    warm_batch = next(ContinuousCodesSP(length=BATCH, seed=9).batches(BATCH))
    with compute_dtype(torch.bfloat16):
        ldpc.train_step(warm, make_optimizer(warm.parameters(),
                                             ldpc.BASE_LR), warm_batch, dev)
    torch.cuda.synchronize()
    run_dir = os.path.join(tmp, "train_bf16")
    fused_mp.reset_counts()
    t0 = time.perf_counter()
    with MetricsWriter(os.path.join(run_dir, "tf_logs")) as writer:
        ldpc.train(args, model, writer, run_dir, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = dict(fused_mp.COUNTS), dict(fused_mp.BWD_COUNTS)
    require(fwd["kernel_launches"] == FWD_PER_STEP * TRAIN_STEPS
            and bwd["kernel_launches"] == BWD_PER_STEP * TRAIN_STEPS,
            f"bf16 train: {fwd['kernel_launches']} forward and "
            f"{bwd['kernel_launches']} backward launches")
    require(fwd["bf16_launches"] == BF16_FWD_PER_STEP * TRAIN_STEPS
            and bwd["bf16_launches"] == BF16_BWD_PER_STEP * TRAIN_STEPS,
            f"bf16 train: {fwd['bf16_launches']} and {bwd['bf16_launches']} "
            f"bf16 launches != {BF16_FWD_PER_STEP} and "
            f"{BF16_BWD_PER_STEP} x {TRAIN_STEPS}")
    require(fwd["plain_calls"] == 0 and bwd["plain_calls"] == 0
            and fused_mp.KEPT_BWD_COUNTS["kernel_launches"] == 0,
            "no plain calls, no kept backward")
    require(fused_mp.KEPT_BF16_COUNTS["kernel_launches"] == 0
            and fused_mp.KEPT_BF16_BWD_COUNTS["kernel_launches"] == 0,
            "bf16 train: every bf16 launch on the new routes (the sample "
            "forward, the packed backward), none on the kept ones")
    with open(os.path.join(run_dir, "tf_logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["value"] for r in logged if r["tag"] == "syn_train/loss"]
    require(len(losses) == TRAIN_STEPS // 10 and all(
        math.isfinite(r["value"]) for r in logged), "finite logged metrics")
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            "f32 parameters under the bf16 policy")
    opt = make_optimizer(model.parameters(), ldpc.BASE_LR)
    staged = ldpc.stage_batch(model, warm_batch, dev)
    with compute_dtype(torch.bfloat16):
        step_ms = cuda_ms(lambda: ldpc.train_step(model, opt, staged, dev),
                          20, torch)
    ldpc_res = dict(steps=TRAIN_STEPS, batch_size=BATCH, seconds=seconds,
                    steps_per_s=TRAIN_STEPS / seconds, train_step_ms=step_ms,
                    train_edges_per_s=EDGES_PER_WORD * BATCH / step_ms * 1e3,
                    losses=losses, fwd_launches=fwd["kernel_launches"],
                    bwd_launches=bwd["kernel_launches"],
                    bf16_fwd_launches=fwd["bf16_launches"],
                    bf16_bwd_launches=bwd["bf16_launches"],
                    kept_bf16_fwd_launches=fused_mp.KEPT_BF16_COUNTS[
                        "kernel_launches"],
                    kept_bf16_bwd_launches=fused_mp.KEPT_BF16_BWD_COUNTS[
                        "kernel_launches"])
    emit("train_bf16", workload="ldpc", **ldpc_res)

    hop_args = synthetic.parse_args([
        "--bf16", "--workers", "0", "--train-epoches", "1",
        "--train-size", str(SYN_STEPS * SYN_BATCH),
        "--test-size", str(SYN_EVAL_BATCHES * SYN_BATCH),
        "--batch-size", str(SYN_BATCH), "--seed", "0",
        "--work-dir", os.path.join(tmp, "hop_bf16")], "hop")
    hop = _run_syn(torch, fused_mp, dev, "hop", hop_args, SYN_STEPS,
                   SYN_EVAL_BATCHES, HOP_PER_STEP)
    fwd, bwd = (fused_mp.EXT_COUNTS["bf16_launches"],
                fused_mp.EXT_BWD_COUNTS["bf16_launches"])
    kept_fwd = (fused_mp.KEPT_BF16_EXT_COUNTS["kernel_launches"]
                + fused_mp.KEPT_EXT_COUNTS["kernel_launches"])
    kept_bwd = fused_mp.KEPT_BF16_EXT_BWD_COUNTS["kernel_launches"]
    require(fwd == hop["fwd_launches"] and bwd == hop["bwd_launches"],
            f"bf16 hop: every launch in the bf16 mode ({fwd}, {bwd})")
    require(kept_fwd == 0 and kept_bwd == 0,
            f"bf16 hop: all {HOP_PER_STEP} forward and {HOP_PER_STEP} "
            f"backward launches a step on the bf16 designs (ext_bwd_kernel "
            f"for the {HOP_EXT_PER_STEP} max convs, the staged kernel in "
            f"tiles of rows for the softmax convs), none on the kept routes "
            f"({kept_fwd}, {kept_bwd})")
    require(all(math.isfinite(v) for v in hop["losses"]),
            "bf16 hop: finite losses")
    wl = synthetic.SynWorkload("hop", hop_args)
    init_weights(wl.model, 1)
    wl.to(dev)
    opt = make_optimizer(wl.model.parameters(), synthetic.BASE_LR,
                         weight_decay=0.0)
    staged = wl.stage(next(batches(wl.dataset, SYN_BATCH, 1)), dev)
    with compute_dtype(torch.bfloat16):
        step_ms = cuda_ms(lambda: synthetic.train_step(wl, opt, staged, dev),
                          20, torch)
    hop.update(syn_train_step_ms=step_ms,
               step_samples_per_s=SYN_BATCH / step_ms * 1e3,
               bf16_fwd_launches=fwd, bf16_bwd_launches=bwd,
               kept_bf16_fwd_launches=kept_fwd,
               kept_bf16_bwd_launches=kept_bwd)
    emit("train_bf16", workload="hop", batch_size=SYN_BATCH, **hop)
    return ldpc_res, hop


# --------------------------------------------------------------------------
# The mesh paths (parallel/, --mesh DPxTP).  Ranks are processes spawned by
# parallel.launch.run_ranks, each running a function of this module.  One
# card cannot hold two NCCL ranks, so ranks that share cuda:0 run over
# gloo, which stages every collective through the host: their collective
# times are gloo's host copies, not NVLink's.

MESH_STEPS = 5
MESH_SPECS = ("2x1", "1x2")
# A data-parallel run sums its gradients in another order than one process,
# and Adam turns that noise into lr-sized updates wherever a gradient is
# near zero (and flips the sign of the noise-level gradients that are zero
# in exact arithmetic), so two correct runs drift apart step by step.  Each
# step's loss is held to one process's on the SAME weights and batch at
# every step; the free-running trajectories are held together over the
# JAX trajectory test's 3 steps (tests/test_mesh_trainer.py:148) and
# printed beyond.
MESH_TRAJECTORY_STEPS = 3
# the halo cell: the decoder's v2f conv at full width (C 128 -> 128, T=4)
# over HALO_WORDS words as one flat graph: 98304 sources, 49152
# destinations, 294912 edges, above the ~1e5 nodes where
# fgnn_tpu/parallel/edge_partition.py:14-16 says the halo exchange pays;
# tests/test_halo.py's tolerances, its gradients' atol taken of the largest
# gradient: a filter gradient sums 294912 edges' products, and f32 sums in
# two orders lie ~1e-6 of the terms' size apart wherever they cancel to
# near zero (that test's gradients are O(1) sums of 400 edges)
HALO_WORDS = 1024
HALO_C = 128
HALO_FWD_TOL = 1e-5
HALO_GRAD_RTOL, HALO_GRAD_ATOL = 1e-4, 1e-5
HALO_RANKS = 2


@contextlib.contextmanager
def _collectives_logged(dist, log):
    """Within the block, each collective the port calls appends (name, its
    tensor, its group) to ``log`` (the ranks' autograd threads too)."""
    names = ("all_reduce", "all_gather", "all_to_all_single", "broadcast")
    real = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def call(*args, **kw):
            t = args[1] if name in ("all_gather", "all_to_all_single") \
                else args[0]
            log.append((name, t.numel(), t.dtype, kw.get("group")))
            return real[name](*args, **kw)
        return call

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield log
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _replay_ms(torch, dist, dev, calls):
    """Host ms of a step's logged collectives replayed alone on tensors of
    their sizes, each done before the next as in the step (second pass)."""
    bufs = [torch.zeros(n, dtype=dt, device=dev) for _, n, dt, _ in calls]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for (name, _, _, g), b in zip(calls, bufs):
            if name == "all_reduce":
                dist.all_reduce(b, group=g)
            elif name == "all_gather":
                dist.all_gather([torch.empty_like(b) for _ in range(
                    dist.get_world_size(g))], b, group=g)
            elif name == "all_to_all_single":
                dist.all_to_all_single(torch.empty_like(b), b, group=g)
            else:
                dist.broadcast(b, src=0, group=g)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return ms


def mesh_train_rank(dev, spec, tmp, with_unmeshed):
    """One rank of ``train.ldpc.train --mesh spec``: MESH_STEPS steps at
    B=256 from the seeded init of ``phase_train``, with the typed-mp
    launches of that run (counts set to 0 just before it), each step's
    global metrics and host ms, the first step's gradients by unmeshed
    name, its collectives replayed alone, the shards this rank holds and
    the final state.  ``with_unmeshed``: first the same run without a
    mesh, in this rank, recorded alike."""
    import torch
    import torch.distributed as dist

    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.ops import fused_mp
    from fgnn_tpu_torch.parallel.sharding import full_grads, \
        full_state_dict, sharded
    from fgnn_tpu_torch.train import ldpc
    from fgnn_tpu_torch.train.common import make_optimizer, mean_metrics
    from fgnn_tpu_torch.utils.logging import MetricsWriter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    real = ldpc.train_step

    def run(mesh_spec, name):
        rec = {"metrics": [], "ms": [], "weights": []}

        def step(model, optimizer, batch, device, *a, mesh=None, **kw):
            if mesh is not None:  # the weights the step starts from
                rec["weights"].append({k: v.cpu().clone() for k, v in
                                       full_state_dict(model).items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _collectives_logged(dist, []) as log:
                m = real(model, optimizer, batch, device, *a, mesh=mesh,
                         **kw)
                torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            if "grads" not in rec:
                rec["calls"] = log
                rec["grads"] = {k: None if v is None else v.cpu()
                                for k, v in full_grads(model).items()}
                rec["shards"] = [
                    (n, tuple(mod.parametrizations[n].original.shape),
                     tuple(getattr(mod, n).shape))
                    for mod, n, _ in sharded(model)]
            rec["metrics"].append(mean_metrics([m], mesh))
            return m

        args = ldpc.parse_args([
            "--train", "--n-epochs", "1", "--steps-per-epoch",
            str(MESH_STEPS), "--batch-size", str(BATCH),
            "--samples-per-epoch", str(MESH_STEPS * BATCH), "--seed", "0",
            "--mesh", mesh_spec, "--work-dir", os.path.join(tmp, name)])
        model = init_weights(LDPCModel(), seed=0).to(dev)
        ldpc.train_step = step
        try:
            fused_mp.reset_counts()
            with (MetricsWriter(os.path.join(args.work_dir, "tf_logs"))
                  if dist.get_rank() == 0 else contextlib.nullcontext()
                  ) as writer:
                model = ldpc.train(args, model, writer, args.work_dir,
                                   device=dev)
            torch.cuda.synchronize()
        finally:
            ldpc.train_step = real
        rec["counts"] = {n: dict(c) for n, c in (
            ("fwd", fused_mp.COUNTS), ("bwd", fused_mp.BWD_COUNTS),
            ("kept_bwd", fused_mp.KEPT_BWD_COUNTS))}
        rec["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
        if dist.get_rank() != 0:  # replicated: rank 0's go back
            rec["weights"] = []
        calls = rec.pop("calls")
        rec["collectives_per_step"] = len(calls)
        rec["collective_bytes_per_step"] = sum(
            n * torch.empty((), dtype=dt).element_size()
            for _, n, dt, _ in calls)
        rec["collective_ms_per_step"] = _replay_ms(torch, dist, dev, calls)
        return rec

    # warm-up (cuBLAS handles, the kernel libraries) on another model
    warm = init_weights(LDPCModel(), seed=1).to(dev)
    real(warm, make_optimizer(warm.parameters(), ldpc.BASE_LR),
         next(ContinuousCodesSP(length=BATCH, seed=9).batches(BATCH)), dev)
    torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "device": str(dev)}
    if with_unmeshed:
        out["unmeshed"] = run("", "unmeshed")
    out["mesh"] = run(spec, f"mesh_{spec}")
    return out


def _mesh_check_counts(what, counts):
    fwd, bwd = counts["fwd"], counts["bwd"]
    require(fwd["kernel_launches"] == FWD_PER_STEP * MESH_STEPS
            and bwd["kernel_launches"] == BWD_PER_STEP * MESH_STEPS,
            f"{what}: {fwd['kernel_launches']} forward and "
            f"{bwd['kernel_launches']} backward launches in {MESH_STEPS} "
            f"steps, not {FWD_PER_STEP} and {BWD_PER_STEP} a step")
    require(fwd["plain_calls"] == 0 and bwd["plain_calls"] == 0
            and counts["kept_bwd"]["kernel_launches"] == 0,
            f"{what}: no plain version, no kept backward")


def phase_mesh_nccl_1(torch, tmp):
    """``train.ldpc.train --mesh 1x1`` through NCCL at world size 1 and the
    same run unmeshed, in one rank: losses, parameters and running
    statistics bit-equal; 16 forward and 15 backward launches a step.
    Returns the unmeshed run (the one-process reference of ``mesh_dp``)
    and the mesh run's counts."""
    from fgnn_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    (res,) = run_ranks(mesh_train_rank, 1, "nccl", "cuda", "1x1", tmp, True)
    seconds = time.perf_counter() - t0
    ref, got = res["unmeshed"], res["mesh"]
    _mesh_check_counts("mesh_nccl_1", got["counts"])
    losses = [m["loss"] for m in got["metrics"]]
    ref_losses = [m["loss"] for m in ref["metrics"]]
    require(losses == ref_losses and len(losses) == MESH_STEPS,
            f"mesh_nccl_1: losses {losses} != unmeshed {ref_losses}")
    require(got["state"].keys() == ref["state"].keys() and all(
        torch.equal(got["state"][k], ref["state"][k]) for k in ref["state"]),
        "mesh_nccl_1: parameters and running statistics bit-equal")
    emit("mesh_nccl_1", backend="nccl", world_size=1, device=res["device"],
         steps=MESH_STEPS, batch_size=BATCH, losses=losses, bit_equal=True,
         fwd_launches=got["counts"]["fwd"]["kernel_launches"],
         bwd_launches=got["counts"]["bwd"]["kernel_launches"],
         step_ms=got["ms"], unmeshed_step_ms=ref["ms"],
         collectives_per_step=got["collectives_per_step"], seconds=seconds)
    return ref, got["counts"]


def _losses_at(torch, dev, weights):
    """One process's step metrics on the card from each of ``weights`` (the
    weights a mesh run's steps started from) on that step's batch."""
    from itertools import islice

    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel
    from fgnn_tpu_torch.train import ldpc
    from fgnn_tpu_torch.train.common import make_optimizer

    ds = ContinuousCodesSP(length=MESH_STEPS * BATCH, seed=0)
    next(ds.batches(BATCH))  # as train draws its init batch
    out = []
    for w, b in zip(weights, islice(ds.batches(BATCH), MESH_STEPS)):
        model = LDPCModel().to(dev)
        model.load_state_dict(w)
        m = ldpc.train_step(model, make_optimizer(model.parameters(),
                                                  ldpc.BASE_LR), b, dev)
        out.append({k: float(v) for k, v in m.items()})
    return out


def phase_mesh_dp(torch, dev, tmp, ref, specs=MESH_SPECS, world=2,
                  backend="gloo", phase="mesh_dp"):
    """``train.ldpc.train --mesh spec`` on ``world`` ranks for each spec,
    against the one-process card run ``ref`` of the same steps: each
    step's loss within LOSS_RTOL of one process's from the same weights,
    the trajectories within LOSS_RTOL over MESH_TRAJECTORY_STEPS steps,
    first-step gradients within GRAD_REL_L2 (``train_vs_cpu``'s rule), on
    every rank 16 forward and 15 backward launches a step and no plain
    version.  Returns rank 0's counts by spec."""
    from fgnn_tpu_torch.parallel import run_ranks

    ref_losses = [m["loss"] for m in ref["metrics"]]
    counts = {}
    for spec in specs:
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_train_rank, world, backend, "cuda", spec,
                          tmp, False)
        seconds = time.perf_counter() - t0
        # the replicated state is every rank's: rank 0's weights
        same_weights = _losses_at(torch, dev, ranks[0]["mesh"]["weights"])
        rows = []
        for r in ranks:
            got, what = r["mesh"], f"{phase} {spec} rank {r['rank']}"
            _mesh_check_counts(what, got["counts"])
            losses = [m["loss"] for m in got["metrics"]]
            step_err = [abs(m["loss"] - w["loss"]) / abs(w["loss"])
                        for m, w in zip(got["metrics"], same_weights)]
            require(len(step_err) == MESH_STEPS
                    and max(step_err) <= LOSS_RTOL,
                    f"{what}: step losses {losses} vs one process on the "
                    f"same weights {[w['loss'] for w in same_weights]}")
            drift = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
            require(max(drift[:MESH_TRAJECTORY_STEPS]) <= LOSS_RTOL,
                    f"{what}: losses {losses} vs one process {ref_losses}")
            rel, noise, floor, bad = _grad_errors(torch, got["grads"],
                                                  ref["grads"])
            bad += ([f"{n}: relative L2 error {v}" for n, v in rel.items()
                     if v > GRAD_REL_L2]
                    + [f"{n}: max abs err {v} > {floor}"
                       for n, v in noise.items() if v > floor])
            require(not bad, f"{what}: first-step gradients {bad}")
            rows.append(dict(
                rank=r["rank"], device=r["device"], losses=losses,
                same_weights_loss_rel_err=step_err,
                trajectory_loss_rel_err=drift,
                grad_rel_l2_worst=max(rel.values()),
                grad_rel_l2_worst_tensor=max(rel, key=rel.get),
                step_ms=got["ms"],
                collectives_per_step=got["collectives_per_step"],
                collective_bytes_per_step=got["collective_bytes_per_step"],
                collective_ms_per_step=got["collective_ms_per_step"],
                fwd_launches=got["counts"]["fwd"]["kernel_launches"],
                bwd_launches=got["counts"]["bwd"]["kernel_launches"],
                plain_calls=got["counts"]["fwd"]["plain_calls"]
                + got["counts"]["bwd"]["plain_calls"],
                shards=[list(s) for s in got["shards"]],
                shard_elements=sum(math.prod(s[1]) for s in got["shards"]),
                of_elements=sum(math.prod(s[2]) for s in got["shards"])))
        emit(phase, spec=spec, backend=backend, world_size=world,
             steps=MESH_STEPS, batch_size=BATCH,
             collective_ms_is=("gloo's host staging of ranks sharing one "
                               "card, not NVLink" if backend == "gloo"
                               else "NCCL, one rank per card"),
             one_process_losses=ref_losses, one_process_step_ms=ref["ms"],
             one_process_losses_on_the_mesh_weights=[
                 w["loss"] for w in same_weights],
             trajectory_steps_held=MESH_TRAJECTORY_STEPS,
             ranks=rows, seconds=seconds)
        counts[spec] = ranks[0]["mesh"]["counts"]
    return counts


def phase_mesh_cards(torch, dev, tmp, ref):
    """``mesh_dp``'s check through NCCL, one rank per card, where the
    machine has two cards or more: ``--mesh {n}x1`` with n = min(count,
    4), and ``2x2`` at four."""
    count = torch.cuda.device_count()
    if count < 2:
        emit("mesh_cards", cards=count, ran=False,
             reason="one card: NCCL needs a card per rank; mesh_dp ran the "
                    "ranks on one card over gloo")
        return {}
    n = min(count, 4)
    specs = (f"{n}x1",) + (("2x2",) if n == 4 else ())
    return phase_mesh_dp(torch, dev, tmp, ref, specs, n, "nccl",
                         "mesh_cards")


def _halo_inputs(seed=0):
    """The halo cell's graph (each word's v2f edges: check d of word w
    reads its 6 variables), features, filters, edge weights and the
    output's cotangent, in numpy from ``seed``."""
    import numpy as np

    from fgnn_tpu_torch.data.ldpc_graph import default_structure

    st = default_structure()
    n_var, n_chk, k = st.n_vars, st.n_checks, st.factors.shape[1]
    words = np.arange(HALO_WORDS)
    src = (words[:, None, None] * n_var + st.factors[None]).reshape(-1)
    dst = np.repeat(np.arange(HALO_WORDS * n_chk), k)
    rng = np.random.RandomState(seed)
    x = rng.randn(HALO_WORDS * n_var, HALO_C).astype(np.float32)
    w = (rng.randn(HALO_C, HALO_C * 4) / np.sqrt(HALO_C)).astype(np.float32)
    et = rng.randn(src.size, 4).astype(np.float32)
    g = rng.randn(HALO_WORDS * n_chk, HALO_C).astype(np.float32)
    return src.astype(np.int64), dst.astype(np.int64), x, w, et, g


def _timed(torch, fn, n=3):
    """Median host ms of ``fn`` over n calls after one, synchronised."""
    fn()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[n // 2]


def mesh_halo_rank(dev, plan):
    """One rank of the halo cell: for max and softmax the halo conv's
    output rows and, through sum(out * g) over them, x's and the filters'
    gradients (this rank's part); the edge-partitioned conv's output for
    the four aggregators; ms of each."""
    import torch
    import torch.distributed as dist

    from fgnn_tpu_torch.parallel import (HaloGraph, make_mesh,
                                         pad_edges,
                                         partitioned_typed_mp_coo)
    from fgnn_tpu_torch.parallel.halo import halo_typed_mp_coo

    torch.backends.cuda.matmul.allow_tf32 = False
    src, dst, x, w, et, g = _halo_inputs()
    mesh = make_mesh((dist.get_world_size(), 1), dev.type)
    graph = HaloGraph(plan, mesh).to(dev)
    r, nd = mesh.data_rank, plan.dst_block
    xl = torch.from_numpy(graph.local_src(x)).to(dev)
    wt = torch.from_numpy(w).to(dev)
    et_loc, et_rem = graph.shard_etype(torch.from_numpy(et).to(dev))
    gl = torch.from_numpy(g[r * nd:(r + 1) * nd]).to(dev)
    out = {"rank": dist.get_rank()}
    for agg in ("max", "softmax"):
        xg = xl.clone().requires_grad_(True)
        wg = wt.clone().requires_grad_(True)

        def fwd(xg=xg, wg=wg, agg=agg):
            return halo_typed_mp_coo(xg, et_loc, et_rem, wg, HALO_C, graph,
                                     aggregator=agg)

        y = fwd()
        (y * gl).sum().backward()
        # copies: the timed calls below add to the gradients
        out[f"halo_{agg}"] = {"out": y.detach().cpu().clone(),
                              "gx": xg.grad.cpu().clone(),
                              "gw": wg.grad.cpu().clone()}
        with torch.no_grad():
            out[f"halo_{agg}"]["ms"] = _timed(torch, fwd)
        out[f"halo_{agg}"]["fwd_bwd_ms"] = _timed(
            torch, lambda: (fwd() * gl).sum().backward())
    srcp, dstp, etp, mask = pad_edges(src, dst, et, mesh.dp)
    xt = torch.from_numpy(x).to(dev)
    etp_t = torch.from_numpy(etp).to(dev)
    for agg in ("max", "sum", "mean", "softmax"):
        def part(agg=agg):
            return partitioned_typed_mp_coo(
                xt, srcp, dstp, etp_t, mask, wt, HALO_C, plan.n_dst, mesh,
                aggregator=agg)

        with torch.no_grad():
            out[f"edge_{agg}"] = {"out": part().cpu(),
                                  "ms": _timed(torch, part)}
    return out


def phase_mesh_halo(torch, dev):
    """The halo and edge-partitioned convs on HALO_RANKS ranks of cuda:0
    over gloo, against ``typed_mp_conv_coo`` on one rank (this process)."""
    from fgnn_tpu_torch.ops.segment import CooGraph, typed_mp_conv_coo
    from fgnn_tpu_torch.parallel import build_halo_plan, run_ranks

    src, dst, x, w, et, g = _halo_inputs()
    n_src, n_dst = x.shape[0], g.shape[0]
    t0 = time.perf_counter()
    plan = build_halo_plan(src, dst, n_src, n_dst, HALO_RANKS)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_halo_rank, HALO_RANKS, "gloo", "cuda", plan)
    seconds = time.perf_counter() - t0

    graph = CooGraph(src, dst, num_nodes=n_dst, num_src=n_src).to(dev)
    xt, wt = (torch.from_numpy(a).to(dev) for a in (x, w))
    ett, gt = (torch.from_numpy(a).to(dev) for a in (et, g))
    readings = {}
    for agg in ("max", "softmax", "sum", "mean"):
        xg = xt.clone().requires_grad_(agg in ("max", "softmax"))
        wg = wt.clone().requires_grad_(agg in ("max", "softmax"))

        def coo(xg=xg, wg=wg, agg=agg):
            return typed_mp_conv_coo(xg, graph, ett, wg, HALO_C,
                                     aggregator=agg)

        ref = coo()
        with torch.no_grad():
            coo_ms = _timed(torch, coo)
        rd = {"coo_ms": coo_ms}
        if agg in ("max", "softmax"):
            (ref * gt).sum().backward()
            halo = [r[f"halo_{agg}"] for r in ranks]
            got = torch.cat([h["out"] for h in halo])[:n_dst]
            err = (got - ref.detach().cpu()).abs().max().item()
            require(torch.allclose(got, ref.detach().cpu(),
                                   rtol=HALO_FWD_TOL, atol=HALO_FWD_TOL),
                    f"mesh_halo {agg}: out max abs err {err}")
            gx = torch.cat([h["gx"] for h in halo])[:n_src]
            gw = sum(h["gw"] for h in halo)
            for name, a, b in (("x", gx, xg.grad.cpu()),
                               ("filters", gw, wg.grad.cpu())):
                scale = b.abs().max().item()
                ok = ((a - b).abs() <= HALO_GRAD_RTOL * b.abs()
                      + HALO_GRAD_ATOL * scale).all().item()
                rd[f"grad_{name}_max_abs_err"] = (a - b).abs().max().item()
                rd[f"grad_{name}_largest"] = scale
                require(ok, f"mesh_halo {agg}: {name} gradient "
                        f"{rd[f'grad_{name}_max_abs_err']} of {scale}")
            rd.update(halo_out_max_abs_err=err,
                      halo_ms=[h["ms"] for h in halo],
                      halo_fwd_bwd_ms=[h["fwd_bwd_ms"] for h in halo])
        edge = [r[f"edge_{agg}"] for r in ranks]
        errs = [(e["out"] - ref.detach().cpu()).abs().max().item()
                for e in edge]
        require(all(torch.allclose(e["out"], ref.detach().cpu(),
                                   rtol=HALO_FWD_TOL, atol=HALO_FWD_TOL)
                    for e in edge),
                f"mesh_halo edge-partitioned {agg}: out max abs err {errs}")
        rd.update(edge_out_max_abs_err=max(errs),
                  edge_ms=[e["ms"] for e in edge])
        readings[agg] = rd
    emit("mesh_halo", backend="gloo", ranks=HALO_RANKS, words=HALO_WORDS,
         sources=n_src, destinations=n_dst, edges=int(src.size), C=HALO_C,
         halo=plan.halo, comm_rows_per_device=plan.comm_rows_per_device,
         src_block=plan.src_block, dst_block=plan.dst_block,
         plan_seconds=plan_s, seconds=seconds,
         ms_are="host ms per call on cuda:0, ranks over gloo",
         readings=readings)


# The joint LDPC formulation (joint): FactorMPNN over the [96 variables ;
# 48 checks] graph of ContinuousCodesJoint (N = Nd = 144, K = 6, T = 2),
# at the synthetic models' widths and the JAX defaults
# (gnn_immediate_dim = max_mpnn_dim = 64): per forward 5 MPConvResidual
# convs (max, C = 64) and the last MPConv (softmax, C = 2), all DIFF; the
# other four layers are pointwise.  (name, C, aggregator, launches per
# forward = per backward)
JOINT_BATCH = 256
JOINT_DIMS = (64, 64, 128, 128, 256, 256, 128, 128, 64, 64, 2)
JOINT_SHAPES = [("joint_c64", 64, "max", 5), ("joint_c2", 2, "softmax", 1)]
JOINT_PER_STEP = sum(s[3] for s in JOINT_SHAPES)   # 6
JOINT_N, JOINT_K, JOINT_T = 144, 6, 2
# The entry points (entry, dryrun): the flagship decoder's 16 forward and
# 15 backward NO_EXTENSION launches a step, on every rank
DRYRUN_WORLDS = (1, 4)


def _joint_inputs(torch, batch, dev):
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    nn_idx = batch["nn_idx"]
    require((nn_idx == nn_idx[:1]).all(), "joint: every sample's table equal")
    table = GatherTable(nn_idx[0], nn_idx.shape[1]).to(dev)
    return ([torch.from_numpy(batch["node_feature"]).to(dev)],
            [torch.from_numpy(batch["hop_feature"]).to(dev)], table,
            torch.from_numpy(batch["etype"]).to(dev))


def phase_joint(torch, fused_mp, dev):
    """FactorMPNN on a ContinuousCodesJoint batch of 256 at the synthetic
    widths: the eval forward on the card against the CPU on the same
    weights (``decode_vs_cpu``'s rule, node and factor outputs); one
    train-mode forward and backward of sum(x * g1) + sum(f * g2), counted
    from 0: 6 DIFF/NEIGHBOR forward and 6 backward launches on the staged
    routes, nothing else; every conv's h, table and etype of that run
    through both kernels and their plain versions on the card, f32 and
    bf16, forward and backward; the forward and the step by CUDA events;
    each joint kernel shape by ``device_ms`` beside its bound, both dtypes.
    Returns (counts, rows, the worst kernel error)."""
    from fgnn_tpu_torch.data import ContinuousCodesJoint
    from fgnn_tpu_torch.models import FactorMPNN, init_weights

    t0 = time.perf_counter()
    batch = next(ContinuousCodesJoint(length=JOINT_BATCH, seed=0)
                 .batches(JOINT_BATCH))
    nodes, hops, table, etype = _joint_inputs(torch, batch, dev)
    model = init_weights(FactorMPNN(2, [6], JOINT_DIMS, [2]), 0).to(dev)
    model.eval()
    with torch.no_grad():
        x, fs = model(nodes[0], hops, [table], [etype])
        cpu_model = copy.deepcopy(model).cpu()
        cx, cfs = cpu_model(nodes[0].cpu(), [hops[0].cpu()],
                            [copy.deepcopy(table).cpu()], [etype.cpu()])
    x_diff, x_n = _vs_cpu(torch, x.cpu(), cx, "joint node outputs")
    f_diff, f_n = _vs_cpu(torch, fs[0].cpu(), cfs[0], "joint factor outputs")

    gen = torch.Generator(device="cuda").manual_seed(7)
    g1 = torch.randn(JOINT_BATCH, 96, 2, device="cuda", generator=gen)
    g2 = torch.randn(JOINT_BATCH, 48, 2, device="cuda", generator=gen)

    def step():
        model.zero_grad(set_to_none=True)
        x, fs = model(nodes[0], hops, [table], [etype])
        ((x * g1).sum() + (fs[0] * g2).sum()).backward()

    model.train()
    seen, real = [], fused_mp.typed_mp_fwd

    def record(h, tbl, et, aggregator, gamma=3.0, ext=False):
        seen.append((h.detach().clone(), tbl, et.detach().clone(),
                     aggregator, ext))
        return real(h, tbl, et, aggregator, gamma, ext)

    fused_mp.typed_mp_fwd = record
    try:
        fused_mp.reset_counts()
        step()
        torch.cuda.synchronize()
    finally:
        fused_mp.typed_mp_fwd = real
    counts = {n: dict(c) for n, c in (
        ("fwd", fused_mp.EXT_COUNTS), ("bwd", fused_mp.EXT_BWD_COUNTS),
        ("kept_fwd", fused_mp.KEPT_EXT_COUNTS),
        ("kept_bwd", fused_mp.KEPT_EXT_BWD_COUNTS),
        ("no_ext_fwd", fused_mp.COUNTS), ("no_ext_bwd", fused_mp.BWD_COUNTS))}
    require(counts["fwd"]["kernel_launches"] == JOINT_PER_STEP
            and counts["bwd"]["kernel_launches"] == JOINT_PER_STEP,
            f"joint: {JOINT_PER_STEP} forward and backward launches a step; "
            f"got {counts}")
    require(all(c.get("plain_calls", 0) == 0 for c in counts.values())
            and all(counts[k]["kernel_launches"] == 0 for k in (
                "kept_fwd", "kept_bwd", "no_ext_fwd", "no_ext_bwd")),
            f"joint: no plain version, no kept route; got {counts}")
    require(all(p.grad is not None and torch.isfinite(p.grad).all().item()
                for p in model.parameters()), "joint: finite gradients")
    shapes = sorted({(s[0].shape[-1], s[3]) for s in seen})
    require(len(seen) == JOINT_PER_STEP and all(s[4] for s in seen)
            and shapes == sorted((c, a) for _, c, a, _ in JOINT_SHAPES),
            f"joint: the convs' (C, aggregator) {shapes}")

    # every recorded conv through both kernels and their plain versions
    worst, worst_b16 = 0.0, 0.0
    for i, (h, tbl, et, agg, _) in enumerate(seen):
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        g = torch.randn(h.shape[0], JOINT_N, h.shape[-1], device="cuda",
                        generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            hd, gd = h.to(dt), g.to(dt)
            kw = dict(ext=True, want_lse=agg == "softmax")
            res = fused_mp.typed_gather_mix_agg(hd, tbl.idx, et, agg, 3.0,
                                                agg == "max", **kw)
            ref = fused_mp.typed_gather_mix_agg_plain(
                hd, tbl.idx, et, agg, 3.0, agg == "max", **kw)
            got = fused_mp.typed_gather_mix_agg_bwd(
                gd, hd, tbl.idx, tbl.ext_ptr, tbl.ext_edge, et, agg, 3.0,
                argmax=res[1] if agg == "max" else None,
                out=res[1] if agg == "softmax" else None, ext=True)
            want = fused_mp.typed_gather_mix_agg_bwd_plain(
                gd, hd, tbl.idx, et, agg, 3.0,
                argmax=res[1] if agg == "max" else None,
                out=res[1] if agg == "softmax" else None, ext=True)
            torch.cuda.synchronize()
            what = f"joint conv {i} ({agg}, C={h.shape[-1]}, {dt})"
            if dt == torch.float32:
                worst = max(worst, _check_close(torch, res[0], ref[0], what),
                            _check_close(torch, got[0], want[0],
                                         what + " dh"),
                            _check_close(torch, got[1], want[1],
                                         what + " d_etype"))
            else:
                worst_b16 = max(worst_b16,
                                _check_bf16_out(torch, res[0], ref[0], what),
                                _check_grads(torch, got, want, what))

    model.eval()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(nodes[0], hops, [table], [etype]),
                         10, torch)
    model.train()
    step_ms = cuda_ms(step, 10, torch)

    rows = []
    for name, C, agg, per_step in JOINT_SHAPES:
        h, tbl, et = next((s[0], s[1], s[2]) for s in seen
                          if s[0].shape[-1] == C)
        B, rows2 = h.shape[0], h.shape[1]
        N, K, T = JOINT_N, JOINT_K, JOINT_T
        argmax = agg == "max"
        gen = torch.Generator(device="cuda").manual_seed(900 + C)
        g = torch.randn(B, N, C, device="cuda", generator=gen)
        row = dict(name=name, B=B, N=N, Nd=N, K=K, T=T, C=C, aggregator=agg,
                   per_joint_step=per_step)
        table_ints = (tbl.idx.numel() + tbl.ext_ptr.numel()
                      + tbl.ext_edge.numel())
        for dt, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
            hd, gd = h.to(dt), g.to(dt)
            kw = dict(ext=True, want_lse=agg == "softmax")

            def fwd(hd=hd, kw=kw):
                return fused_mp.typed_gather_mix_agg(hd, tbl.idx, et, agg,
                                                     3.0, argmax, **kw)

            res = fwd()
            saved = res[1]

            def bwd(hd=hd, gd=gd, saved=saved):
                return fused_mp.typed_gather_mix_agg_bwd(
                    gd, hd, tbl.idx, tbl.ext_ptr, tbl.ext_edge, et, agg, 3.0,
                    argmax=saved if argmax else None,
                    out=saved if agg == "softmax" else None, ext=True)

            def fwd_plain(hd=hd, kw=kw):
                return fused_mp.typed_gather_mix_agg_plain(
                    hd, tbl.idx, et, agg, 3.0, argmax, **kw)

            def bwd_plain(hd=hd, gd=gd, saved=saved):
                return fused_mp.typed_gather_mix_agg_bwd_plain(
                    gd, hd, tbl.idx, et, agg, 3.0,
                    argmax=saved if argmax else None,
                    out=saved if agg == "softmax" else None, ext=True)

            if dt == torch.float32:
                fb = (4 * (hd.numel() + tbl.idx.numel() + et.numel()
                           + B * N * C) + (B * N * C if argmax else 0))
                sv = B * N * C * (1 if argmax else 4)
                bb = (4 * B * N * C + sv + 2 * 4 * hd.numel()
                      + 2 * 4 * et.numel() + 4 * table_ints)
            else:
                fb = _bf16_fwd_bytes(B, rows2, N, K, T, C, argmax)
                bb = _bf16_bwd_bytes(B, rows2, N, K, T, C, agg, table_ints)
            fops = B * N * K * C * (3 * T + 1)
            bops = B * N * K * C * (7 * T + 1 + (3 * T if agg == "softmax"
                                                 else 0))
            for kind, fn, plain, nbytes, ops in (
                    ("fwd", fwd, fwd_plain, fb, fops),
                    ("bwd", bwd, bwd_plain, bb, bops)):
                ms, host_ms = device_ms(fn, 200, torch)
                row.update({
                    f"{tag}{kind}_ms": ms,
                    f"{tag}{kind}_wrapper_host_ms": host_ms,
                    f"{tag}{kind}_plain_ms": device_ms(plain, 20, torch)[0],
                    f"{tag}{kind}_bytes": nbytes, f"{tag}{kind}_ops": ops,
                    f"{tag}{kind}_bound_ms": bound_ms(nbytes, ops),
                    f"{tag}{kind}_bound_by": bound_by(nbytes, ops)})
        row["slab"] = fused_mp.fwd_slab(B, 2 * N, N, K, T, C, agg)
        row["bwd_slab"] = fused_mp.bwd_slab(B, 2 * N, N, K, T, C, agg)
        row["bf16_plan"] = list(fused_mp.fwd_bf16_plan(B, 2 * N, N, K, T, C))
        row["bf16_bwd_plan"] = list(fused_mp.bwd_ext_plan(B, 2 * N, N, K, T,
                                                          C, agg))
        rows.append(row)
        emit("joint_kernel", **row)

    def per_step(key):
        return sum(r[key] * r["per_joint_step"] for r in rows)

    emit("joint", batch_size=JOINT_BATCH, dims=list(JOINT_DIMS),
         nodes_vs_cpu_max_abs_diff=x_diff, nodes_compared=x_n,
         factors_vs_cpu_max_abs_diff=f_diff, factors_compared=f_n,
         fwd_launches=counts["fwd"]["kernel_launches"],
         bwd_launches=counts["bwd"]["kernel_launches"],
         kernel_max_abs_err=worst, bf16_kernel_max_abs_err=worst_b16,
         forward_ms=fwd_ms, step_ms=step_ms,
         kernels_ms_per_step={k: per_step(k) for k in (
             "fwd_ms", "bwd_ms", "bf16_fwd_ms", "bf16_bwd_ms")},
         bound_ms_per_step={k: per_step(k) for k in (
             "fwd_bound_ms", "bwd_bound_ms", "bf16_fwd_bound_ms",
             "bf16_bwd_bound_ms")},
         seconds=time.perf_counter() - t0)
    return counts, rows, max(worst, worst_b16)


def phase_entry(torch, fused_mp, dev):
    """``entry()`` on cuda:0: 16 NO_EXTENSION forward launches (counted
    from 0), logits and sigma_b against ``entry(device="cpu")`` on the same
    weights by ``decode_vs_cpu``'s rule, ms per call.  Returns (fn, args,
    counts)."""
    from fgnn_tpu_torch.entry import entry

    t0 = time.perf_counter()
    fn, args = entry()
    require(all(a.device == dev for a in args), "entry: args on cuda:0")
    fused_mp.reset_counts()
    logits, sigma_b = fn(*args)
    torch.cuda.synchronize()
    counts = {"fwd": dict(fused_mp.COUNTS), "bwd": dict(fused_mp.BWD_COUNTS)}
    require(counts["fwd"]["kernel_launches"] == FWD_PER_STEP
            and counts["fwd"]["plain_calls"] == 0
            and counts["bwd"]["kernel_launches"] == 0,
            f"entry: {FWD_PER_STEP} forward launches; got {counts}")
    cfn, cargs = entry(device="cpu")
    clog, csb = cfn(*cargs)
    l_diff, l_n = _vs_cpu(torch, logits.cpu(), clog, "entry logits")
    s_diff, _ = _vs_cpu(torch, sigma_b.cpu(), csb, "entry sigma_b")
    ms = cuda_ms(lambda: fn(*args), 20, torch)
    emit("entry", shapes=[list(logits.shape), list(sigma_b.shape)],
         fwd_launches=counts["fwd"]["kernel_launches"],
         logits_vs_cpu_max_abs_diff=l_diff, logits_compared=l_n,
         sigma_b_vs_cpu_max_abs_diff=s_diff, ms_per_call=ms,
         seconds=time.perf_counter() - t0)
    return fn, args, counts


def _dryrun(torch, n, backend=None):
    """``dryrun_multichip(n)`` with its printed line parsed: finite
    numbers, on every rank 16 forward and 15 backward launches, no plain
    version."""
    import io

    from fgnn_tpu_torch.entry import dryrun_multichip, mesh_spec

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = dryrun_multichip(n, backend=backend)
    seconds = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    dp, tp = (int(v) for v in mesh_spec(n).split("x"))
    head = f"dryrun_multichip({n}): mesh={{'data': {dp}, 'model': {tp}}} "
    require(line.startswith(head), f"dryrun({n}): line {line!r}")
    nums = {k: float(v) for k, v in (kv.split("=") for kv in
                                     line[len(head):].split())}
    require(sorted(nums) == ["acc", "halo_loss", "loss"]
            and all(math.isfinite(v) for v in nums.values()),
            f"dryrun({n}): finite loss, acc, halo_loss in {line!r}")
    for r in res["ranks"]:
        c = r["counts"]
        require(c["fwd"]["kernel_launches"] == FWD_PER_STEP
                and c["bwd"]["kernel_launches"] == BWD_PER_STEP
                and c["fwd"]["plain_calls"] == c["bwd"]["plain_calls"] == 0,
                f"dryrun({n}) rank {r['rank']}: {FWD_PER_STEP} forward and "
                f"{BWD_PER_STEP} backward launches; got {c}")
    return res, line, seconds


def phase_dryrun(torch, dev):
    """``dryrun_multichip(1)`` over NCCL and ``dryrun_multichip(4,
    backend="gloo")`` (four ranks sharing cuda:0, mesh 2x2): the line, the
    launches of every rank, and each loss within LOSS_RTOL of one process's
    step on the same weights and batch (``mesh_dp``'s rule); where the
    machine has two cards or more, ``dryrun_multichip(cards)`` over NCCL.
    Returns rank 0's counts by path."""
    from fgnn_tpu_torch.entry import ROWS_PER_RANK, example_batch, mesh_spec
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train import ldpc
    from fgnn_tpu_torch.train.common import make_optimizer

    worlds = [(n, "nccl" if n == 1 else "gloo", f"dryrun_{mesh_spec(n)}")
              for n in DRYRUN_WORLDS]
    cards = torch.cuda.device_count()
    if cards >= 2:
        worlds.append((cards, "nccl", f"dryrun_cards_{mesh_spec(cards)}"))
    counts, runs = {}, []
    for n, backend, key in worlds:
        res, line, seconds = _dryrun(torch, n, backend)
        bsz = ROWS_PER_RANK * int(mesh_spec(n).split("x")[0])
        model = init_weights(LDPCModel(), 0).to(dev)
        one = ldpc.train_step(model, make_optimizer(model.parameters(),
                                                    ldpc.BASE_LR),
                              example_batch(bsz), dev)
        one = {k: float(v) for k, v in one.items()}
        err = abs(res["loss"] - one["loss"]) / abs(one["loss"])
        require(err <= LOSS_RTOL, f"dryrun({n}): loss {res['loss']} vs one "
                f"process {one['loss']}")
        counts[key] = res["ranks"][0]["counts"]
        runs.append(dict(n=n, backend=backend, mesh=res["mesh"], line=line,
                         loss=res["loss"], acc=res["acc"],
                         halo_loss=res["halo_loss"],
                         one_process_loss=one["loss"],
                         one_process_acc=one["acc"], loss_rel_err=err,
                         devices=[r["device"] for r in res["ranks"]],
                         seconds=seconds))
    emit("dryrun", runs=runs, cards=cards,
         across_cards="ran" if cards >= 2 else
         "one card: not run (NCCL needs a card per rank)")
    return counts


def phase_utils(torch, fused_mp, fn, args, tmp):
    """The debug and profiling helpers on the card: under ``nan_debug`` the
    clean decode forward passes (16 launches) and one with a NaN planted
    in its input raises ``FloatingPointError``, as do a NaN that only a
    kernel writes (the wrapper's check) and a NaN cotangent in the
    backward; ``check_finite`` names a planted bad leaf of the state dict;
    ``device_memory_stats`` reports cuda:0; ``trace`` of one forward with
    an ``annotate`` range names the kernel and the range."""
    import numpy as np

    from fgnn_tpu_torch.ops.typed_mp import GatherTable
    from fgnn_tpu_torch.utils import (annotate, check_finite,
                                      device_memory_stats, nan_debug, trace)

    t0 = time.perf_counter()
    bad = list(args)
    bad[0] = args[0].clone()
    bad[0][3, 5, 0] = float("nan")
    h = torch.randn(4, 12, 2, 8, device="cuda")
    h[1, 3, 0, 2] = float("nan")
    table = GatherTable(np.arange(0, 60, 5).reshape(6, 2) % 12,
                        12).to("cuda")
    et = torch.ones(4, 6, 2, 2, device="cuda")
    hg = torch.randn(4, 12, 2, 8, device="cuda", requires_grad=True)
    nan_g = torch.full((4, 6, 8), float("nan"), device="cuda")
    raised = {}
    with nan_debug():
        fused_mp.reset_counts()
        fn(*args)
        torch.cuda.synchronize()
        clean = fused_mp.COUNTS["kernel_launches"]
        for what, call in (
                ("planted_input", lambda: fn(*bad)),
                ("kernel_output", lambda: fused_mp.typed_mp_fwd(
                    h, table, et, "sum")),
                ("backward", lambda: fused_mp.typed_mp_fwd(
                    hg, table, et, "sum").backward(nan_g))):
            try:
                call()
                torch.cuda.synchronize()
            except FloatingPointError as e:
                raised[what] = str(e)
    require(clean == FWD_PER_STEP, f"utils: the clean forward under "
            f"nan_debug launched {clean}")
    require(sorted(raised) == ["backward", "kernel_output", "planted_input"],
            f"utils: nan_debug raised for {sorted(raised)} only")
    require("typed_mp_fwd kernel" in raised["kernel_output"],
            f"utils: the kernel's NaN caught by its wrapper: "
            f"{raised['kernel_output']}")
    sd = {k: v.clone() for k, v in fn.model.state_dict().items()}
    key = "main.v2f_0_0.mp_conv.filters"
    sd[key][0, 0] = float("inf")
    try:
        check_finite(sd, "state")
        named = None
    except FloatingPointError as e:
        named = str(e)
    require(named is not None and repr(key) in named,
            f"utils: check_finite names {key}: {named}")
    mem = device_memory_stats()
    require(mem.get("cuda:0", {}).get("bytes_in_use", 0) > 0,
            f"utils: device_memory_stats {mem}")
    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        with annotate("fgnn_entry"):
            fn(*args)
        torch.cuda.synchronize()
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    require(len(files) == 1, f"utils: one trace file, got {files}")
    with open(files[0]) as f:
        text = f.read()
    require("typed_mp_fwd_kernel" in text and "fgnn_entry" in text,
            "utils: the trace names typed_mp_fwd_kernel and fgnn_entry")
    emit("utils", clean_fwd_launches=clean, nan_debug_raised=raised,
         check_finite=named, device_memory_stats=mem,
         trace_bytes=len(text), seconds=time.perf_counter() - t0)


# The bf16 roundings of the kernels, each a text of csrc/typed_mp_common.cuh,
# and what --unrounded builds in its place: rnd<TH> (etype as read or
# staged, mean's g / K, each product of the scalar bf16 mode and of the
# design's single self-row products) and rnd2 (the pairs of d_etype
# products of the DIFF/NEIGHBOR backward's design) become the identity, and
# the packed products (mul_rnd2) multiply in f32 without rounding the
# product or etype.  Stores to bf16 still round (out, dh, the packed and
# the design's g / K).
UNROUNDED = {
    "return to_f32(from_f32<TH>(v));": "return v;",
    """  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(bits(a)), "r"(bits(b)));
  return unpack2(r);""": """  const float2 x = unpack2(bits(a)), y = unpack2(bits(b));
  return make_float2(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y));""",
    "  return mul_rnd2(a, __float2bfloat162_rn(w));": """  const float2 x = unpack2(bits(a));
  return make_float2(__fmul_rn(x.x, w), __fmul_rn(x.y, w));""",
    "  return unpack2(bits(__floats2bfloat162_rn(a, b)));":
    "  return make_float2(a, b);",
}


def unrounded_header(text):
    """The shared header with every rounding of UNROUNDED switched off;
    each text must be found exactly once."""
    for rounded, bare in UNROUNDED.items():
        require(text.count(rounded) == 1,
                f"the rounding {rounded.splitlines()[-1].strip()!r} found "
                f"once in the header")
        text = text.replace(rounded, bare)
    return text


def _unrounded_build(fused_mp, tmp):
    """Build the kernels from a copy of csrc/ in ``tmp`` without the bf16
    mode's roundings (``unrounded_header``).  The wrappers launch those
    builds from here on."""
    src = os.path.join(tmp, "csrc")
    shutil.copytree(fused_mp._CSRC, src,
                    ignore=shutil.ignore_patterns("build"))
    header = os.path.join(src, "typed_mp_common.cuh")
    with open(header) as f:
        text = unrounded_header(f.read())
    with open(header, "w") as f:
        f.write(text)
    fused_mp._CSRC, fused_mp.BUILD_DIR = src, os.path.join(src, "build")
    fused_mp._libs.clear()
    require(sorted(fused_mp.build(force=True)) == sorted(fused_mp.KERNELS),
            "every unrounded kernel built")


def unrounded(torch, fused_mp):
    """``--unrounded``: the bf16 kernel checks' relative L2 readings of the
    sound kernels, then of kernels built without the bf16 mode's roundings
    (``_unrounded_build``), with the checks' failures noted instead of
    raised.  Exits 0 when every relative L2 check fails the unrounded
    kernels."""
    global BF16_FAILED

    def readings():
        for v in BF16_READINGS.values():
            v.clear()
        phase_kernel_check_bf16(torch, fused_mp)
        phase_kernel_check_ext_bf16(torch, fused_mp)
        return {q: sorted(v) for q, v in BF16_READINGS.items()}

    phase_build(fused_mp)
    sound = readings()
    BF16_FAILED = []
    with tempfile.TemporaryDirectory() as tmp:
        _unrounded_build(fused_mp, tmp)
        bare = readings()
    over = {q: sum(r > BF16_KERNEL_REL_L2 for r in v)
            for q, v in bare.items()}
    checks = {q: len(v) for q, v in bare.items()}
    emit("unrounded", tol_rel_l2=BF16_KERNEL_REL_L2,
         sound_worst={q: v[-1] for q, v in sound.items()},
         unrounded_least={q: v[0] for q, v in bare.items()},
         unrounded_median={q: v[len(v) // 2] for q, v in bare.items()},
         unrounded_worst={q: v[-1] for q, v in bare.items()},
         unrounded_over_tol=over, checks=checks,
         readings={"sound": sound, "unrounded": bare},
         failed=len(BF16_FAILED), failed_first=BF16_FAILED[:5])
    return 0 if over == checks else 1


def main():
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--unrounded"]):
        print("usage: python3 chip_smoke.py [--unrounded]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "fgnn_tpu_torch")):
        print("chip_smoke: fgnn_tpu_torch/ not found; run it from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from fgnn_tpu_torch.ops import fused_mp

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device(torch)
    if args:
        return unrounded(torch, fused_mp)
    phase_build(fused_mp)
    worst, shapes = phase_kernel_check(torch, fused_mp)
    phase_norm_act(torch, fused_mp)
    phase_code_attention(torch, fused_mp)
    worst_bwd, shapes_bwd = phase_kernel_check_bwd(torch, fused_mp)
    worst_ext, shapes_ext = phase_kernel_check_ext(torch, fused_mp)
    worst_ext_bwd, shapes_ext_bwd = phase_kernel_check_ext_bwd(torch,
                                                               fused_mp)
    worst_b16, fwd_b16, bwd_b16 = phase_kernel_check_bf16(torch, fused_mp)
    worst_ext_b16, ext_fwd_b16, ext_bwd_b16 = phase_kernel_check_ext_bf16(
        torch, fused_mp)
    with tempfile.TemporaryDirectory() as tmp:
        model, batch, counts, grid = phase_decode(torch, fused_mp, dev, tmp)
        phase_decode_vs_cpu(torch, model, batch, dev)
        phase_bp_decode(torch, dev, grid)
        decode_b16, decode_b16_kept = phase_decode_bf16(
            torch, fused_mp, dev, model, batch, grid)
        fwd_train, bwd_train, train_ms = phase_train(torch, fused_mp, dev,
                                                     tmp)
        phase_train_vs_cpu(torch, dev)
        phase_jax_checkpoint(torch, fused_mp, dev, grid)
        fwd_bpf, bwd_bpf, eval_bpf = phase_train_bp_features(
            torch, fused_mp, dev, tmp, grid, train_ms)
        phase_train_vs_cpu(torch, dev, bp_features=True)
        syn = phase_syn_train(torch, fused_mp, dev, tmp)
        phase_syn_train_vs_cpu(torch, dev)
        fixed = phase_syn_fixed(torch, fused_mp, dev, tmp)
        syn_pool, syn_inline = phase_syn_workers(torch, fused_mp, dev, tmp)
        syn_path = phase_syn_train_path(torch, fused_mp, dev, tmp)
        phase_syn_coo(torch, fused_mp, dev, tmp)
        phase_syn_coo_vs_dense(torch, fused_mp, dev)
        ldpc_b16, hop_b16 = phase_train_bf16(torch, fused_mp, dev, tmp)
        mesh_ref, mesh_1 = phase_mesh_nccl_1(torch, tmp)
        mesh_dp = phase_mesh_dp(torch, dev, tmp, mesh_ref)
        phase_mesh_halo(torch, dev)
        mesh_cards = phase_mesh_cards(torch, dev, tmp, mesh_ref)
        joint_counts, joint_rows, worst_joint = phase_joint(torch, fused_mp,
                                                            dev)
        entry_fn, entry_args, entry_counts = phase_entry(torch, fused_mp,
                                                         dev)
        dryrun_counts = phase_dryrun(torch, dev)
        phase_utils(torch, fused_mp, entry_fn, entry_args, tmp)
    # the mesh paths' and the entry points' launches, rank 0's, by path
    mesh_paths = {"mesh_nccl_1": mesh_1,
                  **{f"mesh_dp_{s}": c for s, c in mesh_dp.items()},
                  **{f"mesh_cards_{s}": c for s, c in mesh_cards.items()},
                  "entry": entry_counts, **dryrun_counts}
    mesh_fwd = {k: c["fwd"]["kernel_launches"] for k, c in mesh_paths.items()}
    mesh_bwd = {k: c["bwd"]["kernel_launches"] for k, c in mesh_paths.items()}

    def per_call(rows, key, per):
        return sum(r[key] * r[per] for r in rows)

    def entry(rows, per, suffix=""):
        nbytes = per_call(rows, "bytes" + suffix, per)
        ops = per_call(rows, "ops", per)
        res = {"ms": per_call(rows, "ms" + suffix, per),
               "plain_ms": per_call(rows, "plain_ms" + suffix, per),
               "bound_ms": bound_ms(nbytes, ops),
               "bound_by": bound_by(nbytes, ops)}
        if "previous_ms" in rows[0]:  # the backward's kept route
            res["previous_ms"] = per_call(rows, "previous_ms", per)
        if "f32_ms" in rows[0]:  # the f32 instantiation, timed in turns
            res["f32_ms"] = per_call(rows, "f32_ms", per)
        return res

    def bf16_entry(name, source, replaces, tpu_kernel, launches, by_path,
                   worst, rows, per, what, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "tpu_kernel": tpu_kernel,
                "checked": True, "launches": launches,
                "launches_by_path": by_path, "max_abs_err": worst,
                **entry(rows, per), "library_ms": None, "per": what,
                **extra}

    def joint_step(kind):
        nbytes = sum(r[f"{kind}_bytes"] * r["per_joint_step"]
                     for r in joint_rows)
        ops = sum(r[f"{kind}_ops"] * r["per_joint_step"] for r in joint_rows)
        return {"ms": sum(r[f"{kind}_ms"] * r["per_joint_step"]
                          for r in joint_rows),
                "plain_ms": sum(r[f"{kind}_plain_ms"] * r["per_joint_step"]
                                for r in joint_rows),
                "bound_ms": bound_ms(nbytes, ops),
                "bound_by": bound_by(nbytes, ops),
                "per": f"one joint FactorMPNN train step at B={JOINT_BATCH}:"
                       f" {JOINT_PER_STEP} launches"
                       + (", 5 with the argmax" if kind.endswith("fwd")
                          else "")}

    fwd_cuda = "fgnn_tpu_torch/csrc/typed_mp_fwd.cu"
    bwd_cuda = "fgnn_tpu_torch/csrc/typed_mp_bwd.cu"
    def kept(rows):  # the kept bf16 route's times in the rows' "ms"
        return [dict(r, ms=r["kept_ms"]) for r in rows]

    fwd_b16_decode = [r for r in fwd_b16 if not r["argmax"]]
    fwd_b16_train = [r for r in fwd_b16 if r["argmax"]]
    fwd_per = (f"one bf16 decode forward at B={BATCH}: {BF16_FWD_PER_STEP} "
               "bf16 launches (ms; f32_ms the f32 instantiation on the same "
               "launches)")
    fwd_step = (f"one bf16 train step: {BF16_FWD_PER_STEP} bf16 launches "
                "with the argmax")
    bwd_per = (f"one bf16 train step at B={BATCH}: {BF16_BWD_PER_STEP} bf16 "
               "launches")
    hop_bwd_per = (f"one bf16 hop train step at B={SYN_BATCH}: "
                   f"{HOP_PER_STEP} launches")
    bf16_kernels = [
        bf16_entry(
            "typed_mp_fwd (bf16 mode, sample route)", fwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:243", "_fwd_kernel, mm_dtype bfloat16",
            decode_b16 + ldpc_b16["bf16_fwd_launches"],
            {"decode_bf16": decode_b16,
             "train_bf16": ldpc_b16["bf16_fwd_launches"]}, worst_b16,
            fwd_b16_decode, "bf16_per_forward", fwd_per,
            train_step={**entry(fwd_b16_train, "bf16_per_forward"),
                        "per": fwd_step}),
        bf16_entry(
            "typed_mp_fwd (bf16 mode, kept route)", fwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:243", "_fwd_kernel, mm_dtype bfloat16",
            decode_b16_kept + ldpc_b16["kept_bf16_fwd_launches"],
            {"decode_bf16": decode_b16_kept,
             "train_bf16": ldpc_b16["kept_bf16_fwd_launches"]}, worst_b16,
            kept(fwd_b16_decode), "bf16_per_forward",
            fwd_per + ", the first kernel (slab=0)",
            train_step={**entry(kept(fwd_b16_train), "bf16_per_forward"),
                        "per": fwd_step}),
        bf16_entry(
            "typed_mp_bwd (bf16 mode, packed route)", bwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:297", "_bwd_kernel, mm_dtype bfloat16",
            ldpc_b16["bf16_bwd_launches"],
            {"train_bf16": ldpc_b16["bf16_bwd_launches"]}, worst_b16,
            bwd_b16, "bf16_per_step", bwd_per + ", packed products"),
        bf16_entry(
            "typed_mp_bwd (bf16 mode, kept route)", bwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:297", "_bwd_kernel, mm_dtype bfloat16",
            ldpc_b16["kept_bf16_bwd_launches"],
            {"train_bf16": ldpc_b16["kept_bf16_bwd_launches"]}, worst_b16,
            kept(bwd_b16), "bf16_per_step",
            bwd_per + ", scalar products (packed=False)"),
        bf16_entry(
            "typed_mp_fwd (DIFF/NEIGHBOR mode, bf16, design)", fwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:243",
            "_fwd_kernel, extension mode, mm_dtype bfloat16",
            hop_b16["bf16_fwd_launches"],
            {"train_bf16": hop_b16["bf16_fwd_launches"]}, worst_ext_b16,
            ext_fwd_b16, "per_hop_step",
            f"one bf16 hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
            "launches, 10 with the argmax, staged_fwd_kernel's bf16 design "
            "(etype rounded once in shared memory, 8 channels a thread, "
            "fwd_bf16_plan)"),
        bf16_entry(
            "typed_mp_fwd (DIFF/NEIGHBOR mode, bf16, kept route)", fwd_cuda,
            "fgnn_tpu/ops/fused_mp.py:243",
            "_fwd_kernel, extension mode, mm_dtype bfloat16",
            hop_b16["kept_bf16_fwd_launches"],
            {"train_bf16": hop_b16["kept_bf16_fwd_launches"]},
            worst_ext_b16, kept(ext_fwd_b16), "per_hop_step",
            f"one bf16 hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
            "launches on staged_fwd_kernel's f32 design and plan "
            "(kept=True)"),
        bf16_entry(
            "typed_mp_bwd (DIFF/NEIGHBOR mode, bf16, design)",
            bwd_cuda, "fgnn_tpu/ops/fused_mp.py:297",
            "_bwd_kernel, extension mode, mm_dtype bfloat16",
            hop_b16["bf16_bwd_launches"],
            {"train_bf16": hop_b16["bf16_bwd_launches"]}, worst_ext_b16,
            ext_bwd_b16, "per_hop_step",
            hop_bwd_per + f", the bf16 design: ext_bwd_kernel for the "
            f"{HOP_EXT_PER_STEP} max convs, the staged kernel in tiles of "
            f"rows for the softmax convs (C=2)"),
        bf16_entry(
            "typed_mp_bwd (DIFF/NEIGHBOR mode, bf16, kept route)",
            bwd_cuda, "fgnn_tpu/ops/fused_mp.py:297",
            "_bwd_kernel, extension mode, mm_dtype bfloat16",
            hop_b16["kept_bf16_bwd_launches"],
            {"train_bf16": hop_b16["kept_bf16_bwd_launches"]},
            worst_ext_b16, kept(ext_bwd_b16), "per_hop_step",
            hop_bwd_per + ", the staged kernel with its plan of the f32 "
            "mode (kept=True; packed products for max)"),
    ]

    print(json.dumps({"kernels": [{
        "name": "typed_mp_fwd", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_fwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:243",
        "tpu_kernel": "_fwd_kernel",
        "checked": True,
        "launches": (counts["kernel_launches"] + fwd_train["kernel_launches"]
                     + fwd_bpf["kernel_launches"]
                     + eval_bpf["kernel_launches"]
                     + sum(mesh_fwd.values())),
        "launches_by_path": {"decode": counts["kernel_launches"],
                             "train": fwd_train["kernel_launches"],
                             "train_bp_features": fwd_bpf["kernel_launches"],
                             "eval_bp_features":
                                 eval_bpf["kernel_launches"],
                             **mesh_fwd},
        "max_abs_err": worst,
        **entry(shapes, "launches_per_forward"),
        "library_ms": None,
        "per": "one decode forward at B=256: 16 launches",
        "train_step": {**entry(shapes, "launches_per_forward", "_argmax"),
                       "per": "one train step at B=256: 16 launches with "
                              "the argmax"},
    }, {
        "name": "typed_mp_bwd", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_bwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:297",
        "tpu_kernel": "_bwd_kernel",
        "checked": True,
        "launches": (bwd_train["kernel_launches"] + bwd_bpf["kernel_launches"]
                     + sum(mesh_bwd.values())),
        "launches_by_path": {"decode": 0,
                             "train": bwd_train["kernel_launches"],
                             "train_bp_features": bwd_bpf["kernel_launches"],
                             **mesh_bwd},
        "max_abs_err": worst_bwd,
        **entry(shapes_bwd, "launches_per_step"),
        "library_ms": None,
        "per": f"one train step at B=256: {BWD_PER_STEP} launches",
    }, {
        "name": "typed_mp_fwd (DIFF/NEIGHBOR mode)", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_fwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:243",
        "tpu_kernel": "_fwd_kernel, extension mode (fused_mp.py:588-620)",
        "checked": True,
        "launches": sum(r["fwd_launches"] for r in (
            syn, fixed, syn_pool, syn_inline, syn_path))
        + joint_counts["fwd"]["kernel_launches"],
        "launches_by_path": {"syn_train": syn["fwd_launches"],
                             "syn_fixed": fixed["fwd_launches"],
                             "syn_workers": syn_pool["fwd_launches"]
                             + syn_inline["fwd_launches"],
                             "syn_train_path": syn_path["fwd_launches"],
                             "joint": joint_counts["fwd"]["kernel_launches"]},
        "max_abs_err": max(worst_ext, worst_joint),
        **entry(shapes_ext, "per_hop_step"),
        "library_ms": None,
        "per": f"one hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
               "launches, 10 with the argmax",
        "fixed_step": {**entry(shapes_ext, "per_fixed_step"),
                       "per": f"one fixed (mp_nn) train step: "
                              f"{FIXED_PER_STEP} launches"},
        "joint_step": joint_step("fwd"),
        "joint_step_bf16": joint_step("bf16_fwd"),
    }, {
        "name": "typed_mp_bwd (DIFF/NEIGHBOR mode)", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_bwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:297",
        "tpu_kernel": "_bwd_kernel, extension mode",
        "checked": True,
        "launches": sum(r["bwd_launches"] for r in (
            syn, fixed, syn_pool, syn_inline, syn_path))
        + joint_counts["bwd"]["kernel_launches"],
        "launches_by_path": {"syn_train": syn["bwd_launches"],
                             "syn_fixed": fixed["bwd_launches"],
                             "syn_workers": syn_pool["bwd_launches"]
                             + syn_inline["bwd_launches"],
                             "syn_train_path": syn_path["bwd_launches"],
                             "joint": joint_counts["bwd"]["kernel_launches"]},
        "max_abs_err": max(worst_ext_bwd, worst_joint),
        **entry(shapes_ext_bwd, "per_hop_step"),
        "library_ms": None,
        "per": f"one hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
               "launches",
        "fixed_step": {**entry(shapes_ext_bwd, "per_fixed_step"),
                       "per": f"one fixed (mp_nn) train step: "
                              f"{FIXED_PER_STEP} launches"},
        "joint_step": joint_step("bwd"),
        "joint_step_bf16": joint_step("bf16_bwd"),
    }] + bf16_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
