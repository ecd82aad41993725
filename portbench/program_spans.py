"""The program's own spans, as the op trace holds them.

The port names its work with ``fgnn_tpu_torch.utils.profiling.annotate``:
``step`` and ``decode`` around a train step or a decoded batch, ``stage``,
``forward``, ``loss``, ``backward``, ``optimizer`` (holding ``clip``) and
``metrics`` inside them, ``conv`` around each ``MPConv``'s message passing
and ``norm`` around each BatchNorm and instance norm.  While a
``torch.profiler`` trace runs, each is a range of that name, so the op
trace (host and device, ``Run.profile``) holds them as host events
(``cpu_op``, or ``user_annotation`` where a ``record_function`` opened
them) on the thread that opened them.  A program that opens no such
range, as the port before them, reads None here.

A launch belongs to a range by time, on any thread: autograd launches the
backward's kernels from its own thread while the main thread waits inside
``backward``.  Ranges of one name may nest (``stage`` inside ``step``):
a launch counts once.
"""

from __future__ import annotations

import bisect

from .trace import _span, _union

RANGES = ("cpu_op", "user_annotation")
STEPS = ("step", "decode")


def ranges(ops, name: str) -> list:
    """[(start, end)] in trace us of the program's ranges called ``name``
    that start in the op trace's window, sorted."""
    return sorted(_span(e) for e in ops.events
                  if e.get("cat") in RANGES and e.get("name") == name
                  and ops.t0 <= float(e["ts"]) <= ops.t1)


def steps(ops) -> int:
    """The ``step`` and ``decode`` ranges outside another such range."""
    return len(_union(ranges(ops, "step") + ranges(ops, "decode")))


def device_ms(ops, name: str):
    """Device ms per step of the kernels, copies and memsets in the window
    launched inside a range called ``name``; None without such a range,
    without a step, or where the trace holds no device work (the CPU)."""
    if ops is None or not ops.device:
        return None
    n, spans = steps(ops), _union(ranges(ops, name))
    if not n or not spans:
        return None
    starts = [a for a, _ in spans]
    total = 0.0
    for e, a, b in ops._clipped():
        ev = ops.launch.get(e.get("args", {}).get("correlation"))
        if ev is None:
            continue
        ts = float(ev["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            total += b - a
    return total * 1e-3 / n
