"""The benchmark's fixed arithmetic: the card's peaks, the bytes and
operations of the typed gather-mix-aggregate kernels, and the spread of a
set of runs.

The kernels' arithmetic is a frozen copy of the kernel table's rules in
the repository's ``chip_smoke.py`` (each input read once, each output
written once; operations per edge and channel as there), so that a later
change to the program is read against the same yardstick.
"""

from __future__ import annotations

import statistics

# One NVIDIA H100 SXM at its 700 W limit (data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores, the rate the port runs at with
# TF32 off.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def typed_fwd_cost(B, N, Nd, K, T, C, esz=4, ext=False, argmax=False):
    """(bytes, operations) of one forward launch.  h has N rows per
    sample (2 Nd for the DIFF/NEIGHBOR mode, ``ext``); out and h have
    ``esz``-byte elements, etype and the table 4, the argmax 1."""
    nbytes = (esz * (B * N * T * C + B * Nd * C) + 4 * (Nd * K + B * Nd * K * T)
              + (B * Nd * C if argmax else 0))
    ops = B * Nd * K * C * ((3 if ext else 2) * T + 1)
    return nbytes, ops


def typed_bwd_cost(B, N, Nd, K, T, C, aggregator, esz=4, ext=False):
    """(bytes, operations) of one backward launch: read g, the argmax
    (max, 1 byte) or out (softmax, 4), h, etype and the table with its
    transposed form once; write dh and d_etype."""
    saved = B * Nd * C * (1 if aggregator == "max" else
                          4 if aggregator == "softmax" else 0)
    tables = Nd * K + (N + 1) + (N * K if ext else Nd * K)
    nbytes = (esz * B * Nd * C + saved + 2 * esz * B * N * T * C
              + 2 * 4 * B * Nd * K * T + 4 * tables)
    if ext:
        ops = B * Nd * K * C * (7 * T + 1 + (3 * T if aggregator == "softmax"
                                             else 0))
    else:
        ops = B * Nd * K * C * (4 * T + 1)
    return nbytes, ops


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, quartiles as ``statistics.quantiles(n=4)``."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)
