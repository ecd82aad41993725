"""Cells of the benchmark cut to a size the CPU runs in seconds: the
widths of the program's layers it lets a caller set, the batch, the
chains and the pool."""

from __future__ import annotations

import os

from portbench.registry import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")

TINY = {
    "ldpc": dict(dims=[8, 8, 8, 16, 32, 32, 16, 8, 8]),
    "hop": dict(chain_length=12, hop_order=5, dims=[8, 8, 16, 16, 8, 8, 2]),
}
CELLS = ("ldpc_decode.b4096", "ldpc_train.b4096", "hop_train.b2048",
         "hop_coo_mixed.b512")


def tiny(name: str, batch: int = 8, bench: str = BENCH) -> Cell:
    c = Cell(name, bench)
    c.config.update(TINY[c.config["family"]])
    if c.config["family"] == "hop":
        c.mix["lengths"] = [9, 12, 15] if c.mix["coo"] else [12]
        c.mix["hop_order"] = 5
    c.mix.update(batch=batch, chunk=2,
                 pool_batches=max(3, c.mix["pool_batches"]))
    return c
