"""Run logging (counterpart of ``fgnn_tpu/utils/logging.py``): a file and
console logger, and a writer of scalar metrics to ``metrics.jsonl``.

The JAX package mirrors the scalars to TensorBoard when tensorboardX is
importable; the port writes only the JSONL stream.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def init_logger(log_path: str, log_file: str, print_log: bool = True,
                level=logging.INFO) -> None:
    os.makedirs(log_path, exist_ok=True)
    handlers = [logging.FileHandler(os.path.join(log_path, f"{log_file}.log"))]
    if print_log:
        handlers.append(logging.StreamHandler(sys.stdout))
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(process)d] [%(threadName)-12.12s] "
               "[%(levelname)-5.5s]  %(message)s",
        handlers=handlers,
        force=True,
    )


class MetricsWriter:
    """Append-only JSONL scalar writer, one object per scalar:
    {tag, value, step, time}."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "time": time.time()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
