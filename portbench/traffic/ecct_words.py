"""Received words of the MacKay 96.3.963 code for ECCT: the words of
``ldpc_words.draw`` (its frozen channel and code), with the received
values as float32, the codewords and the SNRs kept and nothing else.

Each batch is drawn in chunks of ``mix["chunk"]`` words, each from a seed
of its own drawn from the run's seed (stream ``ecct_words``), so the pool
does not depend on the workers.
"""

from __future__ import annotations

import numpy as np

from .. import workers
from .ldpc_words import draw


def _chunk(args):
    raw = draw(*args)
    return {"y": raw["y"].astype(np.float32), "label": raw["label"],
            "snr_db": raw["snr_db"]}


def make_pool(mix: dict, seed: int, batch: int, n_workers: int) -> list:
    """``mix["pool_batches"]`` batches of ``batch`` words: {y (B, 96) f32,
    label (B, 96) int32, snr_db (B,) f32}."""
    chunk = int(mix["chunk"])
    if batch % chunk:
        chunk = batch
    per = batch // chunk
    n = int(mix["pool_batches"]) * per
    seeds = workers.sub_seeds(seed, "ecct_words", n)
    jobs = [(s, chunk, mix["snr_db"], mix["sigma_b"], mix["burst_prob"])
            for s in seeds]
    parts = workers.map_jobs(_chunk, jobs, n_workers)
    return [workers.concat(parts[i * per:(i + 1) * per])
            for i in range(n // per)]
