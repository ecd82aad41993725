"""Where the decode time goes on the card.

    python -m fgnn_tpu_torch.utils.profiling [--batch-size 256] [--steps 10]

Runs the LDPC decoder forward at the reference width (seeded random
weights) on one batch already on the card and prints one JSON object:

* ``batch_build_ms``: host clock of ``batch_to_features`` for one batch,
  the host work of ``Codes.batches`` in ``train.ldpc.evaluate``;
* ``inputs_ms``: host clock of ``train.ldpc.model_inputs`` (the table
  check and the host-to-device copies), ending in a synchronize;
* ``wall_ms``: host clock per forward, ending in a synchronize, without
  the profiler;
* ``device_busy_ms``: the union of the kernels' device intervals per
  forward, from a ``torch.profiler`` trace (CUPTI) of ``--steps`` forwards;
* ``idle_share``: 1 - device_busy_ms / wall_ms;
* ``kernels_per_forward`` and the kernels with the most device time.

Needs a CUDA device; it does not run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import torch


def _kernel_events(trace_path: str):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_decode(batch_size: int = 256, steps: int = 10, seed: int = 0,
                   top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..data import ContinuousCodesSP, batch_to_features
    from ..models import LDPCModel, init_weights
    from ..ops import fused_mp
    from ..train.ldpc import model_inputs

    if not torch.cuda.is_available():
        raise RuntimeError("profiling the decoder needs a CUDA device")
    dev = torch.device("cuda", 0)
    model = init_weights(LDPCModel(), seed).to(dev).eval()
    batch = next(ContinuousCodesSP(length=batch_size, seed=seed)
                 .batches(batch_size))
    inputs = model_inputs(model, batch, dev)

    def forward():
        with torch.inference_mode():
            model(**inputs)

    def host_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    ys = batch["node_feature"][..., 0]
    batch_build_ms = host_ms(lambda: batch_to_features(ys, batch["snr_db"]))
    inputs_ms = host_ms(lambda: model_inputs(model, batch, dev))
    wall_ms = host_ms(forward)

    fused_mp.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
    launches = fused_mp.COUNTS["kernel_launches"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = _kernel_events(path)
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the device")

    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    busy_ms = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels) \
        / steps / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device": torch.cuda.get_device_name(0),
        "batch_size": batch_size, "steps": steps,
        "batch_build_ms": batch_build_ms, "inputs_ms": inputs_ms,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_forward": len(kernels) / steps,
        "typed_mp_fwd_launches_per_forward": launches / steps,
        "top_kernels": [
            {"name": name[:80], "per_forward": n / steps,
             "ms_per_forward": us / steps / 1e3}
            for name, (n, us) in ranked],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(profile_decode(args.batch_size, args.steps, args.seed)))


if __name__ == "__main__":
    main()
