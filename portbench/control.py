"""The readings that set the upper end of each limit: the control (the
plain reference put in the program's place, computed in bfloat16, the
precision below the configurations' float32) and the faults a cell can
have, each against the float32 reference at the cell's own size.

    python3 -m portbench.control --workload <name> --seeds 11,12,13

prints one JSON line per seed: for a train cell the numbers of the
control and of half of every batch left out (the mean taken over the
rest); for the decode cell those of the control, of half of every batch
left out (its decisions never written) and of one answer altered.  A
step that returns its state unchanged reads 1 on ``change_gap`` by the
measure's definition and needs no run.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness, weights
from .registry import Cell

BF16 = torch.bfloat16
F32 = torch.float32


def readings(cell, seed, device="cuda", n_workers=None,
             look=False) -> dict:
    """The control's and the faults' numbers for one seed; with ``look``
    (train cells) also the program's first steps against the float32 and
    the float64 reference, and float64 against float32: which leaves and
    steps the gaps come from, and whether the reference itself moves as
    much between precisions."""
    run = harness.Run(cell, seed, 0, 0, device=device, n_workers=n_workers)
    run.make_pool()
    prog = None
    if look and run.train:
        run.set_up()
        prog = (run.losses_p, run.grad_p, run.change_p)
        run.free_program()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    fam, cfg = run.family, cell.config
    specs = fam.specs(cfg)
    flat0, P = weights.make(specs, seed, dev)
    ref = fam.Reference(cfg, cell.mix, dev)
    out = {"workload": cell.name, "seed": seed, "batch": run.batch}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if run.train:
        n = harness.CHECKED_STEPS
        batches = run.pool_host[:n]
        base = harness.reference_readings(ref, specs, flat0, batches, F32, n)
        ctl = harness.reference_readings(ref, specs, flat0, batches, BF16, n)
        half = harness.reference_readings(ref, specs, flat0, batches, F32, n,
                                          rows=slice(0, run.batch // 2))
        out["control"] = harness.train_numbers(ctl, base)
        out["half_batch"] = harness.train_numbers(half, base)
        if prog is not None:
            f64 = harness.reference_readings(ref, specs, flat0, batches,
                                             torch.float64, n)
            out["program_vs_f32"] = harness.train_numbers(prog, base, True)
            out["program_vs_f64"] = harness.train_numbers(prog, f64, True)
            out["f32_vs_f64"] = harness.train_numbers(base, f64, True)
            out["losses"] = {"program": prog[0], "f32": base[0],
                             "f64": f64[0]}
        if dev.type == "cuda":
            out["reference_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        return out
    batch0 = run.pool_host[0]
    logits = ref.decode_logits(P, batch0, F32)
    ctl = (ref.decode_logits({k: v.to(BF16) for k, v in P.items()}, batch0,
                             BF16) >= 0).cpu().numpy()
    half = (logits >= 0).cpu().numpy().astype(np.int32)
    half[run.batch // 2:] = 0
    altered = (logits >= 0).cpu().numpy().astype(np.int32)
    altered[0] = 1 - altered[0]
    out["control"] = {"decision_gap": harness.decision_gap(ctl, logits)}
    out["half_batch"] = {"decision_gap": harness.decision_gap(half, logits)}
    out["answer_altered"] = {"decision_gap": harness.decision_gap(altered,
                                                                  logits)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--look", action="store_true",
                   help="also the program against float32 and float64")
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, look=args.look)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
