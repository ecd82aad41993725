"""What the benchmark reads from a ``torch.profiler`` trace (its Chrome
JSON form).

Two traces of one run:

* the window trace, of the device only (``ProfilerActivity.CUDA``: the
  kernels, copies and CUDA runtime calls, which costs the host little), of
  steps run as the measured window runs them, between two marker kernels
  (``torch.cuda._sleep``) launched on an idle card.  The window is the
  first marker's start to the last one's end; a trace without both
  markers has no window (``NoWindow``).  The benchmark's host spans
  (``input``, ``dispatch``, ``sync``), timed with ``time.perf_counter``,
  are put on the trace's clock by the first marker's launch.  From it: the
  busy time, the device operations that took most time, the idle gaps by
  what the host was doing, and each span's host time less the time its
  launches spent blocked on a full queue.  Tracing the runtime calls
  costs the host a few microseconds a launch, which these spans include.
* the op trace, of host and device with input shapes, of a few steps
  inside a ``portbench.window`` range: the typed gather-mix-aggregate ops
  with the device time of the kernels launched inside them.

A kernel belongs to the host range that contains the call that launched
it (matched by the CUDA correlation id), on the launching thread.
"""

from __future__ import annotations

import bisect
import collections
import json
import statistics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"
WINDOW = "portbench.window"
OP = "TypedGatherMixAgg"


class NoWindow(ValueError):
    """A trace that holds neither the window range nor both markers."""


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window.  ``spans``: [(name, start, end)]
    in ``time.perf_counter`` seconds, ``mark``: the perf_counter time just
    before the first marker's launch (window traces)."""

    def __init__(self, events: list, spans=(), mark=None):
        self.events = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS]
        self.launch = {}
        self.runtime = []
        for e in self.events:
            if e.get("cat") in RUNTIME_CATS:
                self.runtime.append(e)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = e
        wins = [e for e in self.events if e.get("name") == WINDOW
                and e.get("cat") != "gpu_user_annotation"]
        markers = sorted((e for e in self.device if MARKER in e["name"]),
                         key=lambda e: e["ts"])
        self.device = [e for e in self.device if MARKER not in e["name"]]
        off = None
        if wins:
            self.t0, self.t1 = _span(max(wins, key=lambda e: e.get("dur", 0)))
        elif len(markers) >= 2:
            self.t0, self.t1 = _span(markers[0])[0], _span(markers[-1])[1]
            ev = self.launch.get(markers[0].get("args", {}).get("correlation"))
            if ev is not None and mark is not None:
                off = float(ev["ts"]) - mark * 1e6
        else:
            raise NoWindow(f"the trace has neither a window range nor two "
                           f"marker kernels ({len(markers)} found)")
        self.spans = ([] if off is None else
                      [(n, a * 1e6 + off, b * 1e6 + off) for n, a, b in spans])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self):
        for e in self.device:
            a, b = _span(e)
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                yield e, a, b

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(
            (a, b) for _, a, b in self._clipped())) * 1e-6

    def device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the n device operations (by name) that took
        most time in the window."""
        tot = collections.Counter()
        for e, a, b in self._clipped():
            tot[e["name"]] += (b - a) * 1e-6
        return [[k, v] for k, v in tot.most_common(n)]

    def _span_at(self, ts: float) -> str:
        """The innermost host span that holds trace time ``ts``."""
        best = None
        for name, a, b in self.spans:
            if a <= ts <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "other"

    def idle_gaps(self, n: int = 10) -> list:
        """[description, seconds] of the idle time in the window, by what
        the host was doing when it launched the work that ended each gap
        (``queued`` where that work was launched before the gap began),
        largest first."""
        busy = _union((a, b) for _, a, b in self._clipped())
        starts = sorted(((a, e) for e, a, _ in self._clipped()),
                        key=lambda x: x[0])
        keys = [s for s, _ in starts]
        gaps = collections.defaultdict(list)
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            j = bisect.bisect_left(keys, b)
            what = "window end"
            if j < len(starts):
                ev = self.launch.get(
                    starts[j][1].get("args", {}).get("correlation"))
                if ev is None:
                    what = "other"
                elif float(ev["ts"]) + float(ev.get("dur", 0)) < a:
                    what = "queued"
                else:
                    what = self._span_at(float(ev["ts"]))
            gaps[what].append((b - a) * 1e-6)
        rows = sorted(((sum(v), k, len(v), max(v)) for k, v in gaps.items()),
                      reverse=True)
        return [[f"{k}: {c} gaps, longest {m} s", s] for s, k, c, m in rows[:n]]

    def span_ms(self, name: str):
        """The median host ms of the spans called ``name``, each less the
        time its launches waited for room in a full launch queue: what a
        launch takes beyond twice an unblocked one (the 10th percentile of
        the window's launch calls)."""
        if not self.spans:
            return None
        rt = sorted((float(e["ts"]), float(e.get("dur", 0.0)))
                    for e in self.runtime if "Launch" in e.get("name", ""))
        keys = [t for t, _ in rt]
        free = 2 * statistics.quantiles([d for _, d in rt], n=10)[0] \
            if len(rt) > 1 else 0.0
        out = []
        for n, a, b in self.spans:
            if n != name:
                continue
            lo, hi = bisect.bisect_left(keys, a), bisect.bisect_right(keys, b)
            blocked = sum(max(0.0, d - free) for _, d in rt[lo:hi])
            out.append((b - a - blocked) * 1e-3)
        return statistics.median(out) if out else None

    def typed_ops(self):
        """(forward ops, backward ops, kernel seconds) of the typed
        gather-mix-aggregate autograd function in the window: each op a
        dict with its input dims, dtypes and sequence number; the seconds
        are those of every kernel launched inside one of its ranges."""
        fwd, bwd, engine = [], [], []
        ranges = collections.defaultdict(list)
        for e in self.events:
            name = e.get("name", "")
            if e.get("cat") != "cpu_op" or OP not in name:
                continue
            a, b = _span(e)
            if not (self.t0 <= a <= self.t1):
                continue
            ranges[e.get("tid")].append((a, b))
            args = e.get("args", {})
            op = dict(dims=args.get("Input Dims"), types=args.get("Input type"),
                      seq=args.get("Sequence number"), ts=a)
            if name == OP:
                fwd.append(op)
            elif name.endswith(OP + "Backward"):
                (engine if name.startswith("autograd::") else bwd).append(op)
        seconds = 0.0
        for e, a, b in self._clipped():
            if e.get("cat") != "kernel":
                continue
            ev = self.launch.get(e.get("args", {}).get("correlation"))
            if ev is None:
                continue
            ts = float(ev["ts"])
            if any(x <= ts <= y for x, y in ranges.get(ev.get("tid"), ())):
                seconds += (b - a) * 1e-6
        return fwd, bwd or engine, seconds
