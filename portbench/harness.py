"""One run of one cell: set-up, the measured window, the traced window,
and the comparison with the plain reference that decides ``correct``.

Two loops, chosen by the traffic mix's ``loop``:

* ``decode_closed``: a closed loop of ``in_flight`` batches.  Each batch
  of the pool goes through the program's decoder (staging, forward,
  decisions) and its decisions are copied back to pinned host memory; the
  host waits only on the oldest batch.  Latency: submission to decisions
  on the host.
* ``train``: one optimizer step per batch, staged from the pinned pool
  and never waited on inside the window.

Set-up makes the pool from the seed (``traffic/<generator>.py``, in
worker processes while the rest of set-up goes on), the weights on the
card (``weights.py``), builds the program with them and
runs its first steps through the window's own calls, which also warm up
every shape the window uses.  A train cell's first three steps are the
ones the reference follows.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import trace as trace_mod
from . import weights as weights_mod
from . import workers, yardstick
from .reference import common as C
from .registry import metric_reader

CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "fgnn_tpu")


class Dev:
    """The run's device, with no-op events on the CPU (tests)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            return ev
        return None

    def wait(self, ev):
        if ev is not None:
            ev.synchronize()

    def pin(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self.cuda else t
        return out


class _Span:
    """Appends (name, start, end) in perf_counter seconds to a list."""

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, time.perf_counter()))
        return False


def marker(dev):
    """A kernel of its own name on the card."""
    torch.cuda._sleep(1000)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.load(path)
    finally:
        os.unlink(path)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def median(xs):
    return statistics.median(xs) if xs else None


class Context:
    """What the per-layer readers see: the window's steps, seconds and
    operations per step, the window trace, the op trace, the convs the
    reference counted and the staging probes."""

    def __init__(self, loop, train, window, trace, ops, convs, probes=()):
        self.loop, self.train = loop, train
        self.window, self.trace, self.ops = window, trace, ops
        self.convs, self.probes = convs, list(probes)

    def span_ms(self, name):
        """Host ms of one step's ``input`` or ``dispatch`` in the window
        trace, blocked time left out; a decode step stages its own batch,
        so its staging (probed alone) is taken out of its dispatch."""
        if self.trace is None:
            return None
        if self.loop != "train" and name == "input":
            return median(self.probes)
        v = self.trace.span_ms(name)
        if v is not None and self.loop != "train" and self.probes:
            v -= median(self.probes)
        return v

    def mfu(self):
        w = self.window
        if not w["seconds"]:
            return None
        return (100.0 * w["flops_per_step"] * w["steps"] / w["seconds"]
                / yardstick.F32_FLOPS_PER_S)

    def idle_share(self):
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)

    def typed_mp_roofline(self):
        """Least time of every typed gather-mix-aggregate op traced over
        the device time of the kernels launched inside them, in %."""
        if self.ops is None:
            return None
        fwd, bwd, seconds = self.ops.typed_ops()
        if not fwd or seconds <= 0:
            return None
        least = 0.0
        by_seq = {op["seq"]: op for op in fwd if op["seq"] is not None}
        unmatched = list(fwd)
        for op in fwd:
            least += self._op_seconds(op, None)
        for op in sorted(bwd, key=lambda o: o["ts"]):
            f = by_seq.get(op["seq"])
            if f is None:
                f = self._latest_like(unmatched, op)
            if f is None:
                continue
            if f in unmatched:
                unmatched.remove(f)
            least += self._op_seconds(f, "bwd")
        return 100.0 * least / seconds

    @staticmethod
    def _latest_like(fwd, bwd_op):
        g = (bwd_op.get("dims") or [[]])[0]
        like = [f for f in fwd if len(g) == 3
                and f["dims"][0][0] == g[0] and f["dims"][1][1] == g[1]
                and f["dims"][0][3] == g[2] and f["ts"] < bwd_op["ts"]]
        return max(like, key=lambda f: f["ts"]) if like else None

    def _op_seconds(self, op, kind):
        (B, N, T, Cc), (_, Nd, K, _) = op["dims"][0], op["dims"][1]
        esz = 2 if "BFloat16" in str((op.get("types") or ["float"])[0]) else 4
        ext = N == 2 * Nd
        agg = "max"
        for c in self.convs:
            if (c["nd"], c["k"], c["t"], c["c"], c["ext"]) == (Nd, K, T, Cc,
                                                                 ext):
                agg = c["aggregator"]
                break
        if kind == "bwd":
            nbytes, ops = yardstick.typed_bwd_cost(B, N, Nd, K, T, Cc, agg,
                                                   esz, ext)
        else:
            nbytes, ops = yardstick.typed_fwd_cost(
                B, N, Nd, K, T, Cc, esz, ext, self.train and agg == "max")
        return yardstick.least_seconds(nbytes, ops)


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------- the run

class Run:
    def __init__(self, cell, seed, seconds, traced, *, device="cuda",
                 t_start=None, n_workers=None, hooks=None,
                 program_batch=None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.traced = bool(traced)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cfg, self.mix = cell.config, cell.mix
        self.loop = self.mix["loop"]
        self.train = self.loop == "train"
        self.batch = int(self.mix["batch"])
        self.n_workers = (workers.default_workers() if n_workers is None
                          else n_workers)
        self.device_name = device
        self.family = cell.family()
        self.phases = {}
        self.hooks = hooks
        self.program_batch = program_batch or self.batch

    # -- set-up
    def _phase(self, name, t0):
        self.phases[name] = time.perf_counter() - t0
        return time.perf_counter()

    def make_pool(self, background=False):
        """The host pool from the seed.  With ``background`` it is made in
        a thread, whose generator waits on worker processes, while set-up
        goes on; ``set_up`` joins it before it pins the pool."""
        gen = self.cell.generator()

        def work():
            t0 = time.perf_counter()
            try:
                self.pool_host = gen.make_pool(self.mix, self.seed,
                                               self.batch, self.n_workers)
            except BaseException as e:  # raised again where it is joined
                self._pool_error = e
            self._phase("pool", t0)

        self._pool_error = None
        if not background:
            work()
            self._join_pool()
            return
        self._pool_thread = threading.Thread(target=work, name="pool")
        self._pool_thread.start()

    def _join_pool(self):
        thread = getattr(self, "_pool_thread", None)
        if thread is not None:
            thread.join()
            self._pool_thread = None
        if self._pool_error is not None:
            raise self._pool_error

    def set_up(self):
        t0 = time.perf_counter()
        dev = self.dev = Dev(self.device_name)
        if dev.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.reset_peak_memory_stats(dev.device)
        self.specs = self.family.specs(self.cfg)
        self.flat0, state = weights_mod.make(self.specs, self.seed,
                                             dev.device)
        t0 = self._phase("card and weights", t0)
        self.prog = self.family.Program(self.cfg, self.mix,
                                        self.program_batch, dev.device)
        if self.hooks is not None:
            self.hooks(self.prog)
        got = {k: tuple(v.shape) for k, v in
               self.prog.model.state_dict().items()}
        want = {n: tuple(s) for n, s, _ in self.specs}
        if got != want:
            raise RuntimeError(
                "the program's parameters are not the configuration's: "
                f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
        self.prog.model.load_state_dict(state)
        t0 = self._phase("program", t0)
        self._join_pool()
        t0 = self._phase("pool wait", t0)
        self.pool = [dev.pin(b) for b in self.pool_host]
        t0 = self._phase("pinned pool", t0)
        if self.train:
            self._first_steps()
        else:
            self.prog.model.eval()
            for i in range(3):
                self.prog.decode(self.pool[i % len(self.pool)])
        dev.sync()
        self._phase("first steps", t0)

    def _first_steps(self):
        """The checked steps, through the window's calls, and two more."""
        opt = self.prog.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        named = dict(self.prog.model.named_parameters())
        p0 = weights_mod.views(self.flat0, self.specs)
        self.losses_p = []
        for s in range(CHECKED_STEPS + 2):
            m = self.prog.step(self.prog.stage(self.pool[s % len(self.pool)]))
            if s >= CHECKED_STEPS:
                continue
            self.losses_p.append([float(m[k]) for k in self.family.LOSSES])
            if s == 0:
                self.grad_p = {
                    k: (float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                        if p in opt.state else 0.0)
                    for k, p in named.items()}
            if s == CHECKED_STEPS - 1:
                with torch.no_grad():
                    self.change_p = {k: float((p - p0[k]).norm())
                                     for k, p in named.items()}
        self.steps_done = CHECKED_STEPS + 2

    # -- the measured window
    def window(self):
        gc.collect()
        gc.disable()
        try:
            if self.train:
                return self._train_window()
            return self._decode_steps(seconds=self.seconds, keep=True)
        finally:
            gc.enable()

    def _train_window(self):
        dev, pool = self.dev, self.pool
        i, n = self.steps_done, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            self.prog.step(self.prog.stage(pool[i % len(pool)]))
            i += 1
            n += 1
        dev.sync()
        t1 = time.perf_counter()
        self.steps_done = i
        return dict(steps=n, seconds=t1 - t0, t0=t0)

    def _decode_steps(self, seconds=None, n=None, keep=False, span=None):
        """Batches through the closed loop for ``seconds`` (or ``n``
        batches), each timed from submission to its decisions on the
        host; with ``keep`` a seeded uniform sample of the completed
        batches' decisions is kept for the comparison.  ``span(name)``
        wraps the host's work in the benchmark's trace ranges."""
        dev, pool = self.dev, self.pool
        k = int(self.mix["in_flight"])
        outs = [torch.empty((self.batch, 48), dtype=torch.int32,
                            pin_memory=dev.cuda) for _ in range(k)]
        rng = np.random.RandomState(workers.sub_seeds(self.seed, "sample",
                                                      1)[0])
        n_keep = int(self.mix["check_batches"]) if keep else 0
        span = span or (lambda name: contextlib.nullcontext())
        kept, lat, pending = {}, [], collections.deque()
        i = done = 0

        def complete():
            nonlocal done
            j, ts, ev, slot = pending.popleft()
            with span("sync"):
                dev.wait(ev)
            lat.append(time.perf_counter() - ts)
            if n_keep:  # reservoir sampling over the completed batches
                r = done if done < n_keep else rng.randint(0, done + 1)
                if r < n_keep:
                    kept[r] = (j, outs[slot].numpy().copy())
            done += 1

        t0 = time.perf_counter()
        while (i < n) if n is not None else (
                time.perf_counter() - t0 < seconds):
            ts = time.perf_counter()
            with span("dispatch"):
                dec = self.prog.decode(pool[i % len(pool)])
                outs[i % k].copy_(dec, non_blocking=dev.cuda)
                pending.append((i, ts, dev.event(), i % k))
            i += 1
            if len(pending) >= k:
                complete()
        while pending:
            complete()
        t1 = time.perf_counter()
        if keep:
            self.kept = [kept[r] for r in sorted(kept)]
        return dict(steps=i, seconds=t1 - t0, latencies=lat, t0=t0)

    # -- the traced windows
    def probe_input(self, n=5):
        """Host ms of staging one decode batch alone, on an empty queue."""
        out = []
        for s in range(n):
            self.dev.sync()
            t0 = time.perf_counter()
            self.prog.probe_stage(self.pool[s % len(self.pool)])
            out.append((time.perf_counter() - t0) * 1e3)
        self.dev.sync()
        return out

    def profile(self):
        """(window trace, op trace): ``trace_steps`` steps as the window
        runs them, traced on the device only between two marker kernels
        (none on the CPU, which has no device to trace), then
        ``op_steps`` steps traced on host and device with shapes."""
        from torch.profiler import ProfilerActivity, profile, record_function

        dev = self.dev
        window = self._window_trace() if dev.cuda else None
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.cuda else [])
        with profile(activities=acts, record_shapes=True) as prof:
            with record_function(trace_mod.WINDOW):
                self._traced_steps(int(self.mix["op_steps"]),
                                   lambda n: contextlib.nullcontext())
                dev.sync()
        return window, trace_mod.Trace(_events(prof))

    def _window_trace(self, attempts=3):
        """The window trace.  A first, empty trace starts the activity
        tracing before the window's; a trace that lost a marker is taken
        again, and where every attempt lost one the run fails."""
        from torch.profiler import ProfilerActivity, profile

        dev = self.dev
        with profile(activities=[ProfilerActivity.CUDA]):
            marker(dev)
            dev.sync()
        for attempt in range(attempts):
            spans = []

            def span(name):
                return _Span(spans, name)

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                dev.sync()
                time.sleep(0.05)  # time for the activity tracing to start
                mark = time.perf_counter()
                marker(dev)
                self._traced_steps(int(self.mix["trace_steps"]), span)
                with span("sync"):
                    dev.sync()
                marker(dev)
                dev.sync()
            try:
                return trace_mod.Trace(_events(prof), spans, mark)
            except trace_mod.NoWindow as e:
                print(f"window trace {attempt + 1} of {attempts}: {e}",
                      file=sys.stderr)
                if attempt == attempts - 1:
                    raise

    def _traced_steps(self, n, span):
        if not self.train:
            self._decode_steps(n=n, span=span)
            return
        pool = self.pool
        for s in range(n):
            with span("input"):
                staged = self.prog.stage(pool[s % len(pool)])
            with span("dispatch"):
                self.prog.step(staged)

    # -- the comparison
    def free_program(self):
        self.prog = None
        self.pool = None
        gc.collect()
        if self.dev.cuda:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = self.family.Reference(self.cfg, self.mix, self.dev.device)
        lim = self.cell.limits
        if self.train:
            nums = train_numbers(
                (self.losses_p, self.grad_p, self.change_p),
                reference_readings(ref, self.specs, self.flat0,
                                   self.pool_host[:CHECKED_STEPS],
                                   torch.float32, CHECKED_STEPS),
                detail=True)
        else:
            nums = {"decision_gap": decode_gap(
                ref, weights_mod.views(self.flat0, self.specs),
                self.pool_host, self.kept, torch.float32)}
        self.readings = nums
        return {k: {"value": nums[k], "limit": lim[k]} for k in lim}

    def flops_per_step(self, ref=None):
        ref = ref or self.family.Reference(self.cfg, self.mix,
                                           torch.device("cpu"))
        c1 = ref.count(self.pool_host[0], 1)
        c2 = ref.count(self.pool_host[0], 2)
        per = c1.flops + (c2.flops - c1.flops) * (self.batch - 1)
        return per * (3 if self.train else 1), c1.convs


# ------------------------------------------------------------ comparisons

def norms(d: dict) -> dict:
    return {k: (0.0 if v is None else float(v.double().norm()))
            for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf |prog - ref| / max(ref, median leaf of ref)."""
    keys = list(keys)
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def worst(gaps: dict) -> float:
    vals = list(gaps.values())
    if any(map(math.isnan, vals)):
        return float("nan")
    return max(vals, default=0.0)


def reference_readings(ref, specs, flat0, batches, dtype, n_steps,
                       rows=slice(None)):
    """The reference's first ``n_steps`` steps from the weights ``flat0``
    on ``batches``, in ``dtype``: (each step's losses, the first
    gradient's leaf norms, the leaf norms of the change after the
    steps)."""
    p0 = weights_mod.views(flat0, specs)
    P = {k: v.detach().clone().to(dtype) for k, v in p0.items()}
    losses, g1 = ref.train(P, batches, dtype, n_steps, rows)
    leaves = [s[0] for s in specs if C.is_parameter(s)]
    grads = norms({k: g1.get(k) for k in leaves})
    change = {k: float((P[k].double() - p0[k].double()).norm())
              for k in leaves}
    return losses, grads, change


def train_numbers(prog, ref, detail=False) -> dict:
    """Readings (losses, grads, change) of the program's first steps
    against the reference's.  ``loss_gap``: the worst relative gap of a
    step's loss (``loss_gap_first``: the first step's); ``grad_gap``: the
    worst leaf's gap of the first gradient's norm, against the larger of
    the reference's leaf norm and its median leaf's (``grad_gap_median``:
    the median leaf's gap); ``change_gap`` and ``change_gap_median``: the
    same of the parameters' change after the steps, leaves whose
    reference gradient is under a thousandth of the median leaf's left
    out."""
    losses_p, grad_p, change_p = prog
    losses_r, grad_r, change_r = ref
    med_g = statistics.median(grad_r.values())
    moved = [k for k in grad_r if grad_r[k] >= 1e-3 * med_g]
    rel = [[abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
           for lp, lr in zip(losses_p, losses_r)]
    g = leaf_gaps(grad_p, grad_r, grad_r)
    c = leaf_gaps(change_p, change_r, moved)
    out = {"loss_gap": max(max(r) for r in rel),
           "loss_gap_first": max(rel[0]),
           "grad_gap": worst(g),
           "grad_gap_median": statistics.median(g.values()),
           "change_gap": worst(c),
           "change_gap_median": statistics.median(c.values()) if c else 0.0}
    if detail:
        out["loss_gap_steps"] = [max(r) for r in rel]
        out["worst_grad_leaves"] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        out["worst_change_leaves"] = sorted(
            c.items(), key=lambda kv: -kv[1])[:3]
    return out


def decision_gap(dec, logits) -> float:
    """The largest |reference logit|, over the median |reference logit|,
    of a bit whose decision differs from the reference's (0: none)."""
    logits = logits.double().cpu().numpy()
    ref_dec = logits >= 0
    bad = np.asarray(dec).astype(bool) != ref_dec
    scale = float(np.median(np.abs(logits)))
    return float(np.abs(logits[bad]).max() / scale) if bad.any() else 0.0


def decode_gap(ref, P, pool_host, kept, dtype) -> float:
    """``decision_gap`` of every sampled batch, worst first."""
    cache, worst = {}, 0.0
    for j, dec in kept:
        p = j % len(pool_host)
        if p not in cache:
            cache[p] = ref.decode_logits(P, pool_host[p], dtype)
        worst = max(worst, decision_gap(dec, cache[p]))
    return worst


# ------------------------------------------------------------- the result

def execute(cell, seed, seconds, traced, *, device="cuda", t_start=None,
            n_workers=None, hooks=None, program_batch=None) -> dict:
    """One run; returns the result object (without printing it).  For
    tests: ``hooks(program)`` may replace the program's calls once it is
    built, and ``program_batch`` builds it for another batch."""
    run = Run(cell, seed, seconds, traced, device=device, t_start=t_start,
              n_workers=n_workers, hooks=hooks, program_batch=program_batch)
    run.make_pool(background=True)
    run.set_up()
    setup_s = time.perf_counter() - run.t_start
    win = run.window()
    flops, convs = run.flops_per_step()
    trace = ops = None
    probes = []
    if traced:
        if not run.train:
            probes = run.probe_input()
        trace, ops = run.profile()
    dev = run.dev
    peak = (torch.cuda.max_memory_allocated(dev.device) if dev.cuda else 0)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    run.free_program()
    checks = run.check()
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    units = run.batch * win["steps"] / win["seconds"]
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s,
                  "decode_words_per_s": units, "train_samples_per_s": units}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Context(run.loop, run.train,
                      dict(steps=win["steps"], seconds=win["seconds"],
                           flops_per_step=flops,
                           latencies=win.get("latencies")),
                      trace, ops, convs, probes)
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(dev.device) if dev.cuda
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if dev.cuda:
        device["nvidia_smi"] = power_limit()
    out = {"correct": bool(correct), "attempted": int(win["steps"]),
           "failed": 0, "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.device_ops(),
                            "idle_gaps": trace.idle_gaps()}
    out["check"] = checks
    out["_notes"] = notes(run, win, trace, ops, setup_s)
    return out


def notes(run, win, trace, ops, setup_s) -> list:
    """Lines for standard error: the window and what the trace held."""
    lines = [f"window: {win['steps']} steps in {win['seconds']:.4f} s, "
             f"batch {run.batch}, setup {setup_s:.3f} s"]
    if win.get("latencies"):
        lat = np.asarray(win["latencies"]) * 1e3
        lines.append(f"latency ms: median {np.median(lat):.3f} p95 "
                     f"{np.percentile(lat, 95):.3f} max {lat.max():.3f}")
    if ops is not None:
        fwd, bwd, sec = ops.typed_ops()
        lines.append(
            f"op trace: typed ops {len(fwd)} fwd {len(bwd)} bwd, "
            f"{sum(o['seq'] is not None for o in fwd + bwd)} with sequence "
            f"numbers, their kernels {sec:.5f} s, window {ops.window_s:.4f} "
            f"s busy {ops.busy_s():.4f} s")
    if trace is not None:
        lines.append(
            f"trace: window {trace.window_s:.4f} s busy {trace.busy_s():.4f} "
            f"s, {len(trace.runtime)} runtime calls, {len(trace.spans)} "
            f"spans")
    lines.append("readings: " + json.dumps(run.readings))
    lines.append("set-up phases: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.phases.items()))
    return lines


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in this process: " + ", ".join(names))
        self.names = names
