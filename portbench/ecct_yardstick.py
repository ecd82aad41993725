"""The ECCT cell's fixed arithmetic: the least time of the code-aware
masked attention's forward work, from the shapes the op trace recorded.

Work of one call on q, k, v (B, h, L, d): q, k and v read once and the
output written once (4 B h L d elements); 4 d operations per allowed pair
of the code's mask and head (the score's and the weighted sum's
multiply-adds), ``SOFTMAX_OPS`` more per allowed pair (the scale, the
row's max, the subtraction, the exponential and the sum) and one per
output element (the division by the sum).  The allowed pairs are the
2198 of the code's mask (``reference/ecct.py``), not L^2: a kernel that
computes the masked pairs too gets no credit for them.  The
peaks are ``yardstick.py``'s.  The shapes come from the program's ops
inside each ``attention`` range, never from a library kernel's name, so
the count reads the same whatever implements the op.
"""

from __future__ import annotations

import bisect

from . import program_spans, yardstick
from .reference.ecct import N_TOKENS, allowed_pairs

SOFTMAX_OPS = 5
SPAN = "attention"


def attention_fwd_cost(B, heads, L, d, pairs, esz=4):
    """(bytes, operations) of one forward call over ``pairs`` allowed
    pairs, with ``esz``-byte elements."""
    nbytes = 4 * esz * B * heads * L * d
    ops = B * heads * (pairs * (4 * d + SOFTMAX_OPS) + L * d)
    return nbytes, ops


def _esz(types) -> int:
    t = str((types or ["float"])[0])
    return 2 if ("BFloat16" in t or "Half" in t) else 4


def attention_calls(ops) -> list:
    """[(B, h, L, d, esz)] of each ``attention`` range in the op trace's
    window: the first 4-d input of the first op inside it."""
    spans = program_spans.ranges(ops, SPAN)
    inner = sorted(
        (float(e["ts"]), e) for e in ops.events
        if e.get("cat") in program_spans.RANGES and e.get("name") != SPAN
        and (e.get("args", {}).get("Input Dims") or []))
    keys = [t for t, _ in inner]
    out = []
    for a, b in spans:
        for ts, e in inner[bisect.bisect_left(keys, a):
                           bisect.bisect_right(keys, b)]:
            args = e["args"]
            dims = [d for d in args["Input Dims"] if len(d) == 4]
            if dims:
                out.append((*dims[0], _esz(args.get("Input type"))))
                break
    return out


def attention_roofline(ops):
    """The least time of every traced attention call over the device time
    of the kernels launched inside the ``attention`` ranges, in %; None
    without such a range, its shapes or device time, or at a token count
    other than the code's."""
    per_step_ms = program_spans.device_ms(ops, SPAN)
    calls = attention_calls(ops)
    if not per_step_ms or not calls:
        return None
    least = 0.0
    for B, h, L, d, esz in calls:
        if L != N_TOKENS:
            return None
        least += yardstick.least_seconds(
            *attention_fwd_cost(B, h, L, d, allowed_pairs(), esz))
    seconds = per_step_ms * program_spans.steps(ops) * 1e-3
    return 100.0 * least / seconds
