#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, one JSON line each:

  device        the card (nvidia-smi name and power limit); TF32 off
  build         nvcc builds every kernel of the port from csrc/
  kernel_check  each kernel against its plain PyTorch version on the card,
                at the decode path's shapes and a ragged one, all four
                aggregators; kernel, plain and bound times at each shape
  decode        the LDPC decoder at the reference width (seeded random
                weights) decodes a 3840-word eval grid in 15 batches of 256
                through ``train.ldpc.evaluate``; every kernel must have run
                there, and no plain version
  decode_vs_cpu one batch through the same weights on the port's CPU path

then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before any phase.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from argparse import Namespace

# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): HBM3 rate and
# float32 outside the tensor cores, the rate this kernel's FMAs run at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# (name, B, N_src, Nd, K, T, C, launches per decode forward): the LDPC
# type-0 convs at B=256 (C=128 in layer 2, C=64 in the other seven), and
# ragged shapes (C=30 takes the scalar path)
SHAPES = [
    ("f2v_c64", 256, 48, 96, 3, 4, 64, 7),
    ("f2v_c128", 256, 48, 96, 3, 4, 128, 1),
    ("v2f_c64", 256, 96, 48, 6, 4, 64, 7),
    ("v2f_c128", 256, 96, 48, 6, 4, 128, 1),
    ("ragged_c24", 5, 136, 8, 5, 3, 24, 0),
    ("ragged_c30", 3, 17, 11, 2, 1, 30, 0),
]
AGGS = ("max", "sum", "mean", "softmax")
EDGES_PER_WORD = (96 * 3 + 48 * 6 + 96 + 96) * 8  # 6144, as bench.py
EVAL_PER_CELL = 128
BATCH = 256


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
    seconds, log = fused_mp.build(force=True)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, library=os.path.relpath(fused_mp.LIBRARY),
         ptxas=ptxas)


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
    for si, (name, B, N, Nd, K, T, C, per_fwd) in enumerate(SHAPES):
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
            require(err <= 1e-5 * scale,
                    f"{name} {agg}: max_abs_err {err} > 1e-5 * {scale}")
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
        nbytes = 4 * (h.numel() + idx.numel() + et.numel() + B * Nd * C)
        ops = B * Nd * K * C * (2 * T + 1)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        shapes.append(dict(
            name=name, B=B, N_src=N, Nd=Nd, K=K, T=T, C=C,
            launches_per_forward=per_fwd, ms=t_kernel, plain_ms=t_plain,
            wrapper_host_ms=host_kernel, bound_ms=bound, bytes=nbytes, ops=ops,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_OPS_PER_S else "operations",
            gbytes_per_s=nbytes / t_kernel / 1e6))
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
    with tempfile.TemporaryDirectory() as tmp:
        model, batch, counts = phase_decode(torch, fused_mp, dev, tmp)
    phase_decode_vs_cpu(torch, model, batch, dev)

    def per_forward(key):
        return sum(s[key] * s["launches_per_forward"] for s in shapes)

    fwd_bytes = per_forward("bytes") / HBM_BYTES_PER_S
    fwd_ops = per_forward("ops") / F32_OPS_PER_S
    print(json.dumps({"kernels": [{
        "name": "typed_mp_fwd", "route": "cuda",
        "source": "fgnn_tpu_torch/csrc/typed_mp_fwd.cu",
        "replaces": "fgnn_tpu/ops/fused_mp.py:243",
        "tpu_kernel": "_fwd_kernel",
        "checked": True, "launches": counts["kernel_launches"],
        "max_abs_err": worst,
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": max(fwd_bytes, fwd_ops) * 1e3,
        "bound_by": "bytes" if fwd_bytes >= fwd_ops else "operations",
        "library_ms": None,
        "per": "one decode forward at B=256: 16 launches",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
