#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, one JSON line each:

  device           the card (nvidia-smi name and power limit); TF32 off
  build            nvcc builds every kernel of the port from csrc/, one
                   process per source, all started together
  kernel_check     the forward kernel against its plain PyTorch version on
                   the card, at the LDPC shapes and two ragged ones, all
                   four aggregators; kernel (with and without the argmax),
                   plain and bound times at each LDPC shape
  kernel_check_bwd both routes of the backward (the staged kernel with its
                   planned slab, and the kept kernels) against the plain
                   version, fed the same cotangent and argmax, at the same
                   shapes and aggregators, and the kept route at a graph too
                   wide to stage; two launches must give the same bits; at
                   each LDPC shape the two routes timed in turns (kept,
                   staged, staged, kept), the plain and bound times, and
                   every slab the staged kernel takes there (each checked)
  decode           the LDPC decoder at the reference width (seeded random
                   weights) decodes a 3840-word eval grid in 15 batches of
                   256 through ``train.ldpc.evaluate``; every kernel of the
                   path must have run there, and no plain version
  decode_vs_cpu    one batch through the same weights on the port's CPU path
  train            ``train.ldpc.train`` at the reference width: one epoch of
                   TRAIN_STEPS steps at B=256, seeded random init; every
                   step launches the forward and the staged backward, and
                   neither the kept backward nor a plain version; finite
                   logged losses and a checkpoint; the step time on one
                   staged batch
  train_vs_cpu     one train step from the same weights and batch on the
                   card and on the port's CPU path: losses and gradients
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
                   times, and neither kept route nor a plain version; finite losses, a checkpoint, accuracies in
                   [0, 1]; the step time on one staged batch
  syn_train_vs_cpu one hop train step from the same weights (after
                   SYN_WARM_STEPS steps on the card) and batch on the card,
                   on the port's CPU path and in f64 on the CPU
  syn_fixed        ``train_and_eval("fixed", ...)`` (mp_nn), 5 steps at
                   B=32 and one eval batch: the NEIGHBOR mode on a path

then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before any phase.
"""

import copy
import json
import math
import os
import re
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
    t0 = time.perf_counter()
    built = fused_mp.build(force=True)
    seconds = time.perf_counter() - t0
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
    emit("build", seconds=seconds, libraries=libs)


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


def phase_decode(torch, fused_mp, dev, tmp):
    from fgnn_tpu_torch.data import Codes, generate_eval_set
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.ldpc import decode_step, evaluate, model_inputs

    path = os.path.join(tmp, "ldpc_eval.npz")
    t0 = time.perf_counter()
    generate_eval_set(path, n_per_cell=EVAL_PER_CELL, with_bp_error=False)
    gen_s = time.perf_counter() - t0
    model = init_weights(LDPCModel(), seed=0).to(dev).eval()
    args = Namespace(test_path=path, eval_per_cell=EVAL_PER_CELL,
                     batch_size=BATCH, aggregator="max", model_path="",
                     seed=0)
    first = next(Codes(path).batches(BATCH))
    n_batches = len(Codes(path)) // BATCH

    # warm-up, then the counted run of the main path
    decode_step(model, first, dev)
    torch.cuda.synchronize()
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
    require(0.0 <= ber_total <= 1.0 and err.shape == (5, 6),
            "BER in [0, 1], 5 x 6 matrix")

    # the model alone, on inputs already on the card
    inputs = model_inputs(model, first, dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(**inputs), 20, torch)
    words = n_batches * BATCH
    emit("decode", words=words, batches=n_batches, batch_size=BATCH,
         eval_set_seconds=gen_s, seconds=seconds,
         words_per_s=words / seconds,
         edges_per_s=words * EDGES_PER_WORD / seconds,
         forward_ms=fwd_ms, forward_words_per_s=BATCH / fwd_ms * 1e3,
         ber_total=float(ber_total), kernel_launches=counts["kernel_launches"],
         plain_calls=counts["plain_calls"])
    return model, first, counts


def phase_decode_vs_cpu(torch, model, batch, dev):
    from fgnn_tpu_torch.train.ldpc import decode_logits

    gpu = decode_logits(model, batch, dev).cpu()
    cpu_model = copy.deepcopy(model).cpu().eval()
    cpu = decode_logits(cpu_model, batch, "cpu")
    require(gpu.shape == cpu.shape == (BATCH, 48), "logits (256, 48)")
    require(torch.isfinite(gpu).all().item(), "finite logits")
    diff = (gpu - cpu).abs().max().item()
    require(diff <= 1e-3, f"logits max abs diff {diff} > 1e-3")
    sure = cpu.abs() > 1e-3
    require(((gpu >= 0) == (cpu >= 0))[sure].all().item(),
            "hard decisions agree where |logit| > 1e-3")
    emit("decode_vs_cpu", logits_max_abs_diff=diff,
         decisions_compared=int(sure.sum().item()))


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
    return fwd, bwd


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


def phase_train_vs_cpu(torch, dev):
    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.ldpc import BASE_LR, train_step

    model = init_weights(LDPCModel(), seed=2)
    batch = next(ContinuousCodesSP(length=BATCH, seed=3).batches(BATCH))
    runs = {}
    for where in (dev, "cpu"):
        m = copy.deepcopy(model).to(where)
        metrics = train_step(m, make_optimizer(m.parameters(), BASE_LR),
                             batch, where)
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
    emit("train_vs_cpu", loss=gm["loss"], loss_cpu=cm["loss"],
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


def _syn_args(workload, tmp, steps, eval_batches):
    from fgnn_tpu_torch.train.synthetic import parse_args

    return parse_args([
        "--train-epoches", "1",
        "--train-size", str(steps * SYN_BATCH),
        "--test-size", str(eval_batches * SYN_BATCH),
        "--batch-size", str(SYN_BATCH), "--seed", "0",
        "--work-dir", os.path.join(tmp, workload)], workload)


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


def phase_syn_train_vs_cpu(torch, dev):
    from fgnn_tpu_torch.data import batches
    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train.common import make_optimizer
    from fgnn_tpu_torch.train.synthetic import BASE_LR, SynWorkload, \
        parse_args, train_step

    args = parse_args(["--seed", "3"], "hop")
    wl = SynWorkload("hop", args)
    init_weights(wl.model, 2)
    wl.to(dev)
    data = batches(wl.dataset, SYN_BATCH, SYN_WARM_STEPS + 1)
    opt = make_optimizer(wl.model.parameters(), BASE_LR, weight_decay=0.0)
    for _ in range(SYN_WARM_STEPS):
        train_step(wl, opt, next(data), dev)
    start = {k: v.cpu() for k, v in wl.model.state_dict().items()}
    batch = next(data)
    runs = {}
    for name, where, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("f64", "cpu", torch.float64)):
        wl = SynWorkload("hop", args)
        wl.model.load_state_dict(start)
        wl.to(where)
        wl.model.to(dtype)
        wl.static = {k: v.to(dtype) if k.startswith("ef") else v
                     for k, v in wl.static.items()}
        staged = {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in wl.stage(batch, where).items()}
        opt = make_optimizer(wl.model.parameters(), BASE_LR,
                             weight_decay=0.0)
        metrics = train_step(wl, opt, staged, where)
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {n: None if p.grad is None else p.grad.cpu().double()
                       for n, p in wl.model.named_parameters()})
    (gm, gg), (cm, cg), (_, rg) = runs["card"], runs["cpu"], runs["f64"]
    require(math.isfinite(gm["loss"]), "finite loss")
    require(abs(gm["loss"] - cm["loss"]) <= LOSS_RTOL * abs(cm["loss"]),
            f"loss: card {gm['loss']} vs CPU {cm['loss']}")
    readings, bad = {}, []
    for side, grads in (("card", gg), ("cpu", cg)):
        rel, noise, floor, failed = _grad_errors(torch, grads, rg)
        readings[side] = rel
        bad += [f"{side}: {m}" for m in failed]
        bad += ([f"{side} {n}: relative L2 error {v}" for n, v in rel.items()
                 if v > GRAD_REL_L2]
                + [f"{side} {n}: max abs err {v} > {floor}"
                   for n, v in noise.items() if v > floor])
    card, cpu = readings["card"], readings["cpu"]
    vs_cpu, _, _, _ = _grad_errors(torch, gg, cg)
    worst = sorted(card, key=card.get, reverse=True)[:5]
    emit("syn_train_vs_cpu", warm_steps=SYN_WARM_STEPS, loss=gm["loss"],
         loss_cpu=cm["loss"], acc=gm["acc"], acc_cpu=cm["acc"],
         lp_acc=gm["lp_acc"], tensors_rel_l2=len(card),
         tensors_at_noise_floor=len(noise), noise_floor=floor,
         card_vs_f64_rel_l2_worst=max(card.values()),
         cpu_vs_f64_rel_l2_worst=max(cpu.values()),
         card_vs_cpu_rel_l2_worst=max(vs_cpu.values()),
         worst_tensors={n: {"card_vs_f64": card[n], "cpu_vs_f64": cpu[n]}
                        for n in worst},
         tol_rel_l2=GRAD_REL_L2, failed=bad)
    require(not bad, "hop gradients on the card and on the CPU within "
                     "GRAD_REL_L2 of the f64 run")


def phase_syn_fixed(torch, fused_mp, dev, tmp):
    args = _syn_args("fixed", tmp, FIXED_STEPS, 1)
    require(args.model_name == "mp_nn", "the fixed workload runs mp_nn")
    res = _run_syn(torch, fused_mp, dev, "fixed", args, FIXED_STEPS, 1,
                   FIXED_PER_STEP)
    emit("syn_fixed", batch_size=SYN_BATCH, model_name=args.model_name,
         **res)
    return res


def main():
    import torch

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
    phase_build(fused_mp)
    worst, shapes = phase_kernel_check(torch, fused_mp)
    worst_bwd, shapes_bwd = phase_kernel_check_bwd(torch, fused_mp)
    worst_ext, shapes_ext = phase_kernel_check_ext(torch, fused_mp)
    worst_ext_bwd, shapes_ext_bwd = phase_kernel_check_ext_bwd(torch,
                                                               fused_mp)
    with tempfile.TemporaryDirectory() as tmp:
        model, batch, counts = phase_decode(torch, fused_mp, dev, tmp)
        phase_decode_vs_cpu(torch, model, batch, dev)
        fwd_train, bwd_train = phase_train(torch, fused_mp, dev, tmp)
        phase_train_vs_cpu(torch, dev)
        syn = phase_syn_train(torch, fused_mp, dev, tmp)
        phase_syn_train_vs_cpu(torch, dev)
        fixed = phase_syn_fixed(torch, fused_mp, dev, tmp)

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
        return res

    print(json.dumps({"kernels": [{
        "name": "typed_mp_fwd", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_fwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:243",
        "tpu_kernel": "_fwd_kernel",
        "checked": True,
        "launches": counts["kernel_launches"] + fwd_train["kernel_launches"],
        "launches_by_path": {"decode": counts["kernel_launches"],
                             "train": fwd_train["kernel_launches"]},
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
        "launches": bwd_train["kernel_launches"],
        "launches_by_path": {"decode": 0,
                             "train": bwd_train["kernel_launches"]},
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
        "launches": syn["fwd_launches"] + fixed["fwd_launches"],
        "launches_by_path": {"syn_train": syn["fwd_launches"],
                             "syn_fixed": fixed["fwd_launches"]},
        "max_abs_err": worst_ext,
        **entry(shapes_ext, "per_hop_step"),
        "library_ms": None,
        "per": f"one hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
               "launches, 10 with the argmax",
        "fixed_step": {**entry(shapes_ext, "per_fixed_step"),
                       "per": f"one fixed (mp_nn) train step: "
                              f"{FIXED_PER_STEP} launches"},
    }, {
        "name": "typed_mp_bwd (DIFF/NEIGHBOR mode)", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_bwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:297",
        "tpu_kernel": "_bwd_kernel, extension mode",
        "checked": True,
        "launches": syn["bwd_launches"] + fixed["bwd_launches"],
        "launches_by_path": {"syn_train": syn["bwd_launches"],
                             "syn_fixed": fixed["bwd_launches"]},
        "max_abs_err": worst_ext_bwd,
        **entry(shapes_ext_bwd, "per_hop_step"),
        "library_ms": None,
        "per": f"one hop train step at B={SYN_BATCH}: {HOP_PER_STEP} "
               "launches",
        "fixed_step": {**entry(shapes_ext_bwd, "per_fixed_step"),
                       "per": f"one fixed (mp_nn) train step: "
                              f"{FIXED_PER_STEP} launches"},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
