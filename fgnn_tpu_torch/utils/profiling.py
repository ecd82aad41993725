"""Where the decode and the train-step time go on the card.

    python -m fgnn_tpu_torch.utils.profiling [--batch-size 256] [--steps 10]
    python -m fgnn_tpu_torch.utils.profiling --train [--batch-size 256]
    python -m fgnn_tpu_torch.utils.profiling --syn hop [--batch-size 32]
    python -m fgnn_tpu_torch.utils.profiling --syn hop --coo \
        [--mixed-lengths 24,30,36]
    python -m fgnn_tpu_torch.utils.profiling --train --bf16
    python -m fgnn_tpu_torch.utils.profiling --train --bp-features

Runs the LDPC decoder forward (or, with ``--train``, one Adam train step of
``train.ldpc.train_step``; with ``--syn``, one train step of a synthetic
MAP workload, ``train.synthetic.train_step``) at the reference width,
seeded random weights, on one batch already on the card, and prints one
JSON object:

* ``batch_build_ms``: host clock of building one batch: ``batch_to_features``
  (the host work of ``Codes.batches`` in ``train.ldpc.evaluate``), or for
  ``--syn`` the inline synthesis with oracle labels (``data.rpgm``);
* ``inputs_ms``: host clock of ``train.ldpc.model_inputs`` (the table
  check and the host-to-device copies), ``stage_batch`` or
  ``SynWorkload.stage``, ending in a synchronize;
* ``wall_ms``: host clock per forward (or step), ending in a synchronize,
  without the profiler;
* ``device_busy_ms``: the union of the kernels' device intervals per
  forward (or step), from a ``torch.profiler`` trace (CUPTI) of
  ``--steps`` of them;
* ``idle_share``: 1 - device_busy_ms / wall_ms;
* ``kernels_per_forward`` (``kernels_per_step``), the typed-mp kernels'
  launches per forward (step), in each mode and, for the backward, on each
  route (staged, kept), with ``..._bf16_launches_per_...`` the launches of
  their bf16 mode, the norm kernels' (``norm_act_launches_per_...``),
  the code-aware attention's (``code_attention_launches_per_...`` and
  ``code_attention_bwd_launches_per_...``), the device time of each of
  the port's ``__global__`` functions, and the
  kernels with the most device time.

``--bf16`` runs any of them under the bf16 compute policy
(``models/policy.py``), as the trainers' flag.  ``--bp-features`` runs the
LDPC forward or step with the sum-product features (the 50-loop batched
decode on the card, ``ops/bp.py``, inside each one), as ``train.ldpc``'s
flag.  ``--coo`` (with ``--syn hop``) profiles the step of the COO model
over a flat disjoint union, ``--mixed-lengths`` its composite batches, as
the trainer's flags.

Needs a CUDA device; it does not run on the CPU.

The module also holds the helpers of ``fgnn_tpu/utils/profiling.py``, which
run on either device:

* ``trace(logdir)``: a ``torch.profiler`` trace (CPU, and CUDA where there
  is a card) of a block, written into ``logdir`` for TensorBoard;
* ``annotate(name)``: a named span, the one span primitive of the program
  (the trainers' step phases, ``MPConv``'s message passing, the norms):
  a range in any ``torch.profiler`` trace, a ``Span`` under
  ``record_spans()``, and otherwise one shared no-op;
* ``record_spans()``: records every ``annotate`` span of the block in
  memory, on ``time.perf_counter``'s clock, and yields the list;
* ``device_memory_stats()``: bytes in use and their peak per CUDA device
  (``{}`` without one);
* ``StepTimer``: steps, edges and samples per second of a loop.

The JAX package's ``enable_compilation_cache`` has no counterpart here:
the port compiles nothing at run time but its kernels, which
``ops.fused_mp.build`` builds once into ``csrc/build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler


# the port's __global__ functions (csrc/*.cu), by name: the kept, the
# staged and the bf16 sample forward, the staged backward and its sum over
# slabs, the bf16 DIFF/NEIGHBOR backward's design, the two of the kept
# backward, the eval BatchNorm and instance norm with their activation, and
# the code-aware attention's forward and backward
PORT_KERNELS = ("typed_mp_fwd_kernel", "staged_fwd_kernel",
                "sample_fwd_kernel", "staged_bwd_kernel", "sum_slabs",
                "ext_bwd_kernel", "d_etype_kernel", "dh_kernel",
                "bn_act_kernel", "in_act_kernel", "code_attn_fwd_kernel",
                "code_attn_bwd_kernel")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU ops, and the card's kernels where CUDA is
    available) and write a TensorBoard-loadable trace into ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


_NO_SPAN = contextlib.nullcontext()
# a range in a torch.profiler trace: the C++ RecordFunction guard that
# record_function wraps, at a sixth of its host cost a range or less; the
# trace shows it as a host op ("cpu_op") of the span's name
_RANGE = torch._C._profiler._RecordFunctionFast
_recorder = None  # the _Recorder of the open record_spans() block


@dataclass(slots=True)
class Span:
    """One ``annotate`` span under ``record_spans``.  ``parent``: the index
    of the span that held it on its thread (-1: none), so a step's spans
    are those whose parents lead to its span; ``thread``: the opening
    thread's ``threading.get_ident()``; ``t0``, ``t1``: its start and end
    in ``time.perf_counter`` seconds."""

    name: str
    parent: int
    thread: int
    t0: float = float("nan")
    t1: float = float("nan")


class _Recorder:
    """The spans of one ``record_spans`` block, with each thread's stack of
    open spans."""

    def __init__(self):
        self.spans = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Annotation:
    """``annotate``'s span while a recorder or a profiler is on."""

    __slots__ = ("name", "rec", "range", "span")

    def __init__(self, name: str, rec):
        self.name, self.rec = name, rec
        self.range = (_RANGE(name) if _autograd_profiler._is_profiler_enabled
                      else None)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        rec = self.rec
        if rec is not None:
            stack = rec.stack()
            self.span = Span(self.name, stack[-1] if stack else -1,
                             threading.get_ident())
            with rec._lock:
                stack.append(len(rec.spans))
                rec.spans.append(self.span)
            self.span.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            self.span.t1 = time.perf_counter()
            rec.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str):
    """A named span: ``with annotate("step"): ...``.  Under any
    ``torch.profiler`` trace (``trace``, or the caller's own) a range of
    that name; under ``record_spans`` a ``Span``; with neither, one shared
    no-op context manager, which allocates nothing and reads no clock."""
    if _recorder is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Annotation(name, _recorder)


@contextlib.contextmanager
def record_spans():
    """Record every ``annotate`` span opened in the block, on every
    thread, and yield the list of ``Span`` records, filled in as the spans
    open and close.  Nothing is written anywhere: the caller reads the
    list."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("record_spans() blocks do not nest")
    _recorder = _Recorder()
    try:
        yield _recorder.spans
    finally:
        _recorder = None


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} of the caching
    allocator on each CUDA device; {} where there is none, as the JAX
    package reports no CPU device."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            stats[str(torch.device("cuda", i))] = {
                "bytes_in_use": s.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            }
    return stats


@dataclass
class StepTimer:
    """Throughput counter: call ``step(n_edges, n_samples)`` once per
    step; ``snapshot()`` gives the rates since the start or ``reset()``."""

    window: int = 50
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0
    _edges: int = 0
    _samples: int = 0

    def step(self, n_edges: int = 0, n_samples: int = 0) -> None:
        self._steps += 1
        self._edges += n_edges
        self._samples += n_samples

    def snapshot(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"steps_per_s": self._steps / dt,
                "edges_per_s": self._edges / dt,
                "samples_per_s": self._samples / dt}

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = self._edges = self._samples = 0


def _kernel_events(trace_path: str):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _host_ms(fn, steps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def kernels_per_call(fn, steps: int = 1) -> tuple:
    """(kernels launched, device busy ms) per call of ``fn``, from a
    ``torch.profiler`` trace of ``steps`` calls after one untraced."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = _kernel_events(path)
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the device")
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    return len(kernels) / steps, busy_us / steps / 1e3


def _trace(fn, steps: int, wall_ms: float, per: str, top: int) -> dict:
    """Device busy time, idle share, launches and top kernels of ``steps``
    calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import fused_mp

    fused_mp.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    counts = {name: dict(c) for name, c in fused_mp.ROUTES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = _kernel_events(path)
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the device")

    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    busy_ms = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels) \
        / steps / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    port = defaultdict(lambda: [0, 0.0])
    for name, (n, us) in by_name.items():
        for kernel in PORT_KERNELS:
            if f"::{kernel}<" in name or f"::{kernel}(" in name:
                port[kernel][0] += n
                port[kernel][1] += us
    out = {
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        f"kernels_per_{per}": len(kernels) / steps,
    }
    for name, c in counts.items():
        if c["kernel_launches"] or name == "typed_mp_fwd":
            out[f"{name}_launches_per_{per}"] = c["kernel_launches"] / steps
        for key, n in c.items():  # bf16_launches, bwd_launches
            if n and key != "kernel_launches" and key.endswith("_launches"):
                out[f"{name}_{key}_per_{per}"] = n / steps
    out["port_kernels"] = {
        kernel: {f"per_{per}": n / steps, f"ms_per_{per}": us / steps / 1e3}
        for kernel, (n, us) in port.items()}
    out["top_kernels"] = [
        {"name": name[:80], f"per_{per}": n / steps,
         f"ms_per_{per}": us / steps / 1e3} for name, (n, us) in ranked]
    return out


def _device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(batch_size: int, seed: int, train: bool, bp_features: bool):
    from ..data import ContinuousCodesSP
    from ..models import LDPCModel, init_weights

    dev = _device()
    model = init_weights(LDPCModel(node_feature_dim=4 if bp_features
                                   else 2), seed).to(dev).train(train)
    batch = next(ContinuousCodesSP(length=batch_size, seed=seed)
                 .batches(batch_size))
    return dev, model, batch


def profile_decode(batch_size: int = 256, steps: int = 10, seed: int = 0,
                   top: int = 12, bp_features: bool = False) -> dict:
    from ..data import batch_to_features
    from ..train.ldpc import augment_bp_features, model_inputs

    dev, model, batch = _setup(batch_size, seed, False, bp_features)
    inputs = model_inputs(model, batch, dev)

    def forward():
        with torch.inference_mode():
            if bp_features:
                model(**{**inputs, "node_feature": augment_bp_features(
                    inputs["node_feature"])})
            else:
                model(**inputs)

    ys = batch["node_feature"][..., 0]
    batch_build_ms = _host_ms(
        lambda: batch_to_features(ys, batch["snr_db"]), steps)
    inputs_ms = _host_ms(lambda: model_inputs(model, batch, dev), steps)
    wall_ms = _host_ms(forward, steps)
    return {
        "device": torch.cuda.get_device_name(0),
        "batch_size": batch_size, "steps": steps,
        "batch_build_ms": batch_build_ms, "inputs_ms": inputs_ms,
        "wall_ms": wall_ms,
        **_trace(forward, steps, wall_ms, "forward", top),
    }


def profile_train(batch_size: int = 256, steps: int = 10, seed: int = 0,
                  top: int = 12, bp_features: bool = False) -> dict:
    """One Adam step of ``train.ldpc.train_step`` on a batch staged on the
    card (``stage_batch``), under the caller's compute policy, TF32 off."""
    from ..train.common import make_optimizer
    from ..train.ldpc import BASE_LR, stage_batch, train_step

    dev, model, batch = _setup(batch_size, seed, True, bp_features)
    opt = make_optimizer(model.parameters(), BASE_LR)
    staged = stage_batch(model, batch, dev)
    inputs_ms = _host_ms(lambda: stage_batch(model, batch, dev), steps)

    def step():
        train_step(model, opt, staged, dev, bp_features=bp_features)

    wall_ms = _host_ms(step, steps)
    return {
        "device": torch.cuda.get_device_name(0),
        "batch_size": batch_size, "steps": steps, "inputs_ms": inputs_ms,
        "wall_ms": wall_ms,
        **_trace(step, steps, wall_ms, "step", top),
    }


def profile_syn(workload: str = "hop", batch_size: int = 32,
                steps: int = 10, seed: int = 0, top: int = 12,
                coo: bool = False, mixed_lengths: str = "") -> dict:
    """One train step of ``train.synthetic.train_step`` (the JAX trainer's
    defaults: chain 30, hop order 9, the reference dims; with ``coo`` the
    trainer's ``--coo [--mixed-lengths]``) on a batch staged on the card,
    under the caller's compute policy, TF32 off."""
    from ..data import batches
    from ..models import init_weights
    from ..train.common import make_optimizer
    from ..train.synthetic import BASE_LR, SynWorkload, parse_args, \
        train_step

    dev = _device()
    flags = ["--seed", str(seed), "--batch-size", str(batch_size)]
    if coo:
        flags += ["--coo", "--mixed-lengths", mixed_lengths]
    wl = SynWorkload(workload, parse_args(flags, workload))
    init_weights(wl.model, seed)
    wl.to(dev)
    opt = make_optimizer(wl.model.parameters(), BASE_LR, weight_decay=0.0)
    next(batches(wl.dataset, batch_size, 1))  # first use: imports, caches
    t0 = time.perf_counter()
    host = [next(batches(wl.dataset, batch_size, 1)) for _ in range(3)]
    batch_build_ms = (time.perf_counter() - t0) / 3 * 1e3
    staged = wl.stage(host[0], dev)
    inputs_ms = _host_ms(lambda: wl.stage(host[0], dev), steps)

    def step():
        train_step(wl, opt, staged, dev)

    wall_ms = _host_ms(step, steps)
    return {
        "device": torch.cuda.get_device_name(0), "workload": wl.workload,
        "mixed_lengths": mixed_lengths, "batch_size": batch_size,
        "steps": steps,
        "batch_build_ms": batch_build_ms, "inputs_ms": inputs_ms,
        "wall_ms": wall_ms,
        **_trace(step, steps, wall_ms, "step", top),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true",
                   help="profile one train step instead of a forward")
    p.add_argument("--syn", choices=("fixed", "pw", "hop"), default=None,
                   help="profile one train step of this synthetic workload")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 256 (LDPC) or 32 (--syn)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="the bf16 compute policy, as the trainers' flag")
    p.add_argument("--coo", action="store_true",
                   help="(--syn hop) the COO model over a flat disjoint "
                        "union, as the trainer's flag")
    p.add_argument("--mixed-lengths", type=str, default="",
                   help="(--syn hop --coo) comma list of chain lengths, "
                        "as the trainer's flag")
    p.add_argument("--bp-features", action="store_true",
                   help="(LDPC) the sum-product features, as train.ldpc's "
                        "flag")
    args = p.parse_args(argv)
    from ..models.policy import bf16_policy

    with bf16_policy(args.bf16):
        if args.syn:
            out = profile_syn(args.syn, args.batch_size or 32, args.steps,
                              args.seed, coo=args.coo,
                              mixed_lengths=args.mixed_lengths)
        else:
            fn = profile_train if args.train else profile_decode
            out = fn(args.batch_size or 256, args.steps, args.seed,
                     bp_features=args.bp_features)
    print(json.dumps({"bf16": args.bf16, "bp_features": args.bp_features,
                      **out}))


if __name__ == "__main__":
    main()
