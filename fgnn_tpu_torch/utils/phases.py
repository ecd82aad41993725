"""Where a launch of the bf16 DIFF/NEIGHBOR designs spends its time on the
card, phase by phase.

    python -m fgnn_tpu_torch.utils.phases

Builds the forward and backward kernel sources once as they are and once
for each cut of ``CUTS``, a copy of ``csrc/`` in which a text of the
source is replaced so that a phase does no work (its loop runs no item, or
the kernel returns before it stages anything), all with ``nvcc`` at once.
Then, at the hop step's C=64 shapes (``SHAPES``), it launches each build's
design (``typed_mp_fwd_staged`` design 1 and ``typed_mp_bwd_ext``, with the
plan ``ops/fused_mp.py`` makes) on the same inputs and prints one JSON line
per (kernel, shape, build) with its device time in microseconds, timed as
``chip_smoke.py`` times kernels: 200 launches queued behind a spin kernel.
The difference between two builds is the time of the phase one of them
cuts; a cut build computes nothing usable.  The first line is the card's
name and power limit.

Needs a CUDA device and nvcc; it does not run on the CPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..ops import fused_mp
from ..ops.typed_mp import GatherTable

# (name, B, N, K, T, C): the hop step's pw and hop tables at C=64
SHAPES = (("hop_pw_c64", 32, 60, 2, 16, 64),
          ("hop_high_c64", 32, 60, 9, 16, 64))

# source -> build -> the (text, replacement) pairs that cut its phases; each
# text must be found exactly once in the shipped source
CUTS = {
    "typed_mp_fwd": {
        # the messages: no item
        "stage_only": [("  const int items = nd * cv * G;\n",
                        "  const int items = ET ? 0 : nd * cv * G;\n")],
        # the launch alone: the design returns before it stages
        "launch_only": [(
            "  // 1. stage the slab of h and the rows' part of the table "
            "(and etype)\n",
            "  if (ET) return;\n")],
    },
    "typed_mp_bwd": {
        "no_d_etype": [("  const int items = nd * runs * cv;\n",
                        "  const int items = 0;\n")],
        "no_dh": [("  for (int q = tid; q < 2 * nd * runs * cv; q += nt) {\n",
                   "  for (int q = tid; q < 0; q += nt) {\n")],
        "stage_only": [("  const int items = nd * runs * cv;\n",
                        "  const int items = 0;\n"),
                       ("  for (int q = tid; q < 2 * nd * runs * cv; "
                        "q += nt) {\n",
                        "  for (int q = tid; q < 0; q += nt) {\n")],
        "launch_only": [(
            "  // 1. stage, in two groups of copies: what dh needs",
            "  if (N > 0) return;\n  // 1. stage")],
    },
}
ENTRY = {"typed_mp_fwd": "typed_mp_fwd_staged",
         "typed_mp_bwd": "typed_mp_bwd_ext"}


def cut_source(text: str, cuts) -> str:
    """``text`` with each (text, replacement) of ``cuts`` applied; each
    text must be found exactly once."""
    for old, new in cuts:
        if text.count(old) != 1:
            raise ValueError(f"the cut text {old.strip()!r} is found "
                             f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_variants(tmp: str) -> dict:
    """{(source, build): the C entry of the design} for every build of
    CUTS and the shipped sources ("full"), compiled at once."""
    procs = {}
    for name, builds in CUTS.items():
        for build, cuts in {"full": [], **builds}.items():
            src_dir = os.path.join(tmp, f"{name}_{build}")
            shutil.copytree(fused_mp._CSRC, src_dir,
                            ignore=shutil.ignore_patterns("build"))
            src = os.path.join(src_dir, f"{name}.cu")
            with open(src) as f:
                text = cut_source(f.read(), cuts)
            with open(src, "w") as f:
                f.write(text)
            lib = os.path.join(src_dir, f"lib{name}.so")
            procs[name, build] = (lib, subprocess.Popen(
                [fused_mp.nvcc_path(), *fused_mp.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    entries = {}
    for (name, build), (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({build}):\n{err}")
        fn = getattr(ctypes.CDLL(lib), ENTRY[name])
        fn.argtypes = fused_mp._ARGTYPES[ENTRY[name]]
        fn.restype = ctypes.c_int
        entries[name, build] = fn
    return entries


def device_us(fn, n: int = 200) -> float:
    """Device microseconds per call of ``fn``, the n calls queued behind a
    spin kernel that outlasts their host time (``chip_smoke.device_ms``)."""
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
        torch.cuda._sleep(int(host_s * 4e9 * 2 ** tries))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n * 1e3
    raise RuntimeError("could not queue the timed calls ahead of the card")


def _calls(entries: dict, shape) -> dict:
    """{(source, build): a call of that build's design} at ``shape``."""
    _, B, N, K, T, C = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    h = torch.randn(B, 2 * N, T, C, device="cuda", generator=gen).to(bf16)
    idx = torch.randint(0, N, (N, K), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    table = GatherTable(idx.numpy(), N).to("cuda")
    et = torch.randn(B, N, K, T, device="cuda", generator=gen)
    g = torch.randn(B, N, C, device="cuda", generator=gen).to(bf16)
    out = torch.empty(B, N, C, dtype=bf16, device="cuda")
    am = fused_mp.typed_gather_mix_agg(h, table.idx, et, "max", 3.0, True,
                                       ext=True)[1]
    dh, d_etype = torch.empty_like(h), torch.empty_like(et)
    fs, ft = fused_mp.fwd_bf16_plan(B, 2 * N, N, K, T, C)
    bs, bt = fused_mp.bwd_ext_plan(B, 2 * N, N, K, T, C, "max")
    part = et.new_empty((B, C // bs) + et.shape[1:])
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for (name, build), fn in entries.items():
        if name == "typed_mp_fwd":
            args = (h.data_ptr(), table.idx.data_ptr(), et.data_ptr(),
                    out.data_ptr(), am.data_ptr(), None, B, N, N, K, T, C,
                    fused_mp.AGGREGATORS["max"], 3.0, 1, 1, fs, 1, ft, stream)
        else:
            args = (g.data_ptr(), am.data_ptr(), h.data_ptr(),
                    table.idx.data_ptr(), table.ext_ptr.data_ptr(),
                    table.ext_edge.data_ptr(), et.data_ptr(), dh.data_ptr(),
                    d_etype.data_ptr(), B, N, K, T, C,
                    fused_mp.AGGREGATORS["max"], part.data_ptr(), bs, bt,
                    stream)
        calls[name, build] = (lambda fn=fn, args=args: fn(*args),
                              (fs, ft) if name == "typed_mp_fwd" else (bs, bt))
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("phases: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        entries = build_variants(tmp)
        for shape in SHAPES:
            for (name, build), (call, plan) in _calls(entries,
                                                      shape).items():
                if call() != 0:
                    raise RuntimeError(f"{name} ({build}) refused {shape}")
                print(json.dumps({
                    "kernel": ENTRY[name], "shape": shape[0], "build": build,
                    "slab": plan[0], "tiles": plan[1],
                    "us": device_us(call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
