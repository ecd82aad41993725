"""Seeds and worker processes of the traffic generators.

A pool of batches is made of chunks, each drawn from a ``RandomState`` of
its own whose seed comes from the run's ``--seed`` (any whole number) by
``numpy.random.SeedSequence``: the same seed gives the same pool however
many workers made it.  Workers are spawned (the process holds threads, so
it does not fork), import the generator's module alone (numpy, scipy),
and are joined before the pool is returned, with the resource tracker
that their queues start.
"""

from __future__ import annotations

import multiprocessing
import os
import zlib
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import resource_tracker

import numpy as np


def sub_seeds(seed: int, what: str, n: int) -> list:
    """n seeds below 2**31 for the stream ``what`` of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                 zlib.crc32(what.encode())])
    return [int(s) for s in ss.generate_state(n, np.uint32) % (2 ** 31)]


def default_workers() -> int:
    return max(1, min(7, (os.cpu_count() or 2) - 1))


def map_jobs(fn, jobs: list, n_workers: int) -> list:
    """[fn(job) for job in jobs], in spawned worker processes where
    ``n_workers`` > 1; every worker has ended when this returns, and a
    worker that dies raises here rather than being replaced."""
    if n_workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    with ProcessPoolExecutor(min(n_workers, len(jobs)),
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as pool:
        out = list(pool.map(fn, jobs))
    # the pool's queues started multiprocessing's resource tracker, a
    # process of its own: stop it too, and wait for it
    resource_tracker._resource_tracker._stop()
    return out


def concat(parts: list) -> dict:
    """Batches (dicts of arrays) concatenated along the first axis."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
