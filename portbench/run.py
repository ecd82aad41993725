"""Run one cell of the port's benchmark on the card in this machine.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Prints one
JSON object as the last line of standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
traced window; in both the comparison with the plain reference that
decides ``correct``, each number beside its limit, which also end
standard error.  Exits non-zero, printing no result, where CUDA or the
cell's cards are missing, or where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYCACHE = os.path.join(ROOT, ".portbench_cache", "pyc")


def cache_bytecode():
    """Keep the compiled bytecode of every module this run and its worker
    processes import under the checkout, at a fixed path, so that only the
    first run there compiles the Python sources of PyTorch and the
    program.  An installation that writes no bytecode of its own
    (``PYTHONDONTWRITEBYTECODE``) would otherwise compile them in every
    run's set-up."""
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main(argv=None) -> int:
    cache_bytecode()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from .registry import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from .harness import ForbiddenModules, execute

    try:
        out = execute(cell, args.seed, args.seconds, args.trace,
                      t_start=T_START)
    except ForbiddenModules as e:
        print(f"JAX or the JAX package was loaded: {e}", file=sys.stderr)
        return 4
    for line in out.pop("_notes"):
        print(line, file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
