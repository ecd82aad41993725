"""Run a function on N ranks of a fresh process group, one process each.

    results = run_ranks(fn, 2, "gloo", "cpu", arg, ...)

Each rank is a process of the ``spawn`` start method (a parent that has
initialised CUDA cannot fork safely), meets the others through a file in a
temporary directory (no fixed port: several runs may share the host), runs
with one intra-op thread, and calls ``fn(device, *args)`` with its device
from ``mesh.init_distributed``.  ``fn`` must be importable by name
(spawn re-imports its module in every child) and return something
picklable; its return values come back in rank order, counters of the
child included.  A rank that raises fails the run with its traceback.
The CLIs are started with ``torchrun`` instead.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_distributed


def _rank_main(fn, rank, world_size, backend, device, init_method, results,
               args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    try:
        dev = init_distributed(device, backend, init_method)
        try:
            out = fn(dev, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        # by value: a tensor put as it is would be shared through a file
        # descriptor that the rank's exit closes
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, backend: str, device, *args,
              timeout: float = 900.0) -> list:
    """``fn(device, *args)`` on ``world_size`` spawned ranks over
    ``backend``; each rank's return value, in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world_size, backend, str(device), init, results,
            args)) for rank in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        done = False
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        # a rank that died before it could report
                        time.sleep(1.0)
                        if results.empty():
                            raise RuntimeError(
                                f"a rank exited with code {dead[0].exitcode}"
                                " before it reported") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks did not finish in "
                            f"{timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = pickle.loads(out)
            done = True
        finally:
            # after a failure the other ranks may wait in a collective
            for p in procs:
                p.join(timeout=60 if done else 0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [got[r] for r in range(world_size)]
