"""The readers of the program's own spans (``portbench/program_spans.py``
and the five metrics on them) on hand-made op traces: device ms per step
launched inside a span, a launch from another thread counted by time, a
span nested in a span of the same name counted once; a trace without the
program's ranges (the port before them) reads None and leaves every older
reader's value as it is; the loader takes the five new entries; a CPU run,
with the program's spans and without, reports none of them."""

import json
import sys

import pytest

from portbench import harness, program_spans, trace
from portbench.registry import Cell, metric_reader
from portbench.tests.test_bench_trace import CONVS, X
from portbench.tests.tiny import BENCH, tiny

NEW = ("forward_device_ms.train", "backward_device_ms.train",
       "optimizer_device_ms.train", "conv_device_ms.decode",
       "norm_device_ms.decode")


def R(name, ts, dur, tid=1, cat="cpu_op"):
    return X(name, cat, ts, dur, tid=tid)


def launch(ts, corr, tid=1, dur=5):
    return X("cudaLaunchKernel", "cuda_runtime", ts, dur, tid=tid,
             correlation=corr)


def train_events(program=True):
    """Two steps in trace us: step 1 stages (a copy), runs a forward (a
    typed op's kernel inside ``conv``, one inside ``norm``, one outside
    both), a backward whose kernel autograd's thread (tid 2) launches, and
    an optimizer; step 2 a forward alone."""
    # a record_function's range is a user annotation
    spans = [R("stage", 10, 50, cat="user_annotation"), R("step", 100, 800),
             R("forward", 110, 290),
             R("conv", 120, 80), R("norm", 210, 90), R("backward", 450, 350),
             R("optimizer", 810, 80), R("step", 950, 250),
             R("forward", 960, 140)]
    return [X("portbench.window", "user_annotation", 0, 2000),
            launch(20, 1), X("Memcpy HtoD", "gpu_memcpy", 100, 30, tid=8,
                             correlation=1),
            X("TypedGatherMixAgg", "cpu_op", 125, 60,
              **{"Input Dims": [[2, 48, 4, 64], [2, 96, 3, 4], [96, 3]],
                 "Input type": ["float", "float", "int"],
                 "Sequence number": 7}),
            launch(130, 2), X("typed_mp_fwd_kernel", "kernel", 200, 100,
                              tid=7, correlation=2),
            launch(220, 3), X("mul", "kernel", 300, 50, tid=7,
                              correlation=3),
            launch(350, 4), X("add", "kernel", 400, 20, tid=7,
                              correlation=4),
            X("TypedGatherMixAggBackward", "cpu_op", 490, 50, tid=2,
              **{"Input Dims": [[2, 96, 64]], "Sequence number": 7}),
            launch(500, 5, tid=2), X("staged_bwd_kernel", "kernel", 600,
                                     200, tid=7, correlation=5),
            launch(820, 6), X("adam", "kernel", 850, 10, tid=7,
                              correlation=6),
            launch(970, 7), X("gemm", "kernel", 1100, 40, tid=7,
                              correlation=7)] + (spans if program else [])


def decode_events(program=True):
    """Two decoded batches, each staging a copy (the first's launch waits
    400 us for room in the queue), the first's forward a kernel in ``conv``
    and one in ``norm``; a ``stage`` outside any ``decode``; eight launches
    outside every span."""
    spans = [R("decode", 100, 900), R("stage", 110, 500),
             R("forward", 620, 370), R("conv", 630, 50), R("norm", 700, 50),
             R("decode", 1100, 400), R("stage", 1110, 130),
             R("stage", 2000, 300)]
    free = [launch(3000 + 10 * i, 20 + i, dur=4) for i in range(8)]
    return [X("portbench.window", "user_annotation", 0, 5000),
            launch(120, 11, dur=400), X("Memcpy HtoD", "gpu_memcpy", 700, 10,
                                        tid=8, correlation=11),
            launch(1120, 12, dur=4), X("Memcpy HtoD", "gpu_memcpy", 1300, 10,
                                       tid=8, correlation=12),
            launch(640, 13), X("typed_mp_fwd_kernel", "kernel", 800, 40,
                                tid=7, correlation=13),
            launch(710, 14), X("mul", "kernel", 850, 20, tid=7,
                               correlation=14)] + free + (
        spans if program else [])


def test_device_ms_by_span_per_step():
    t = trace.Trace(train_events())
    assert program_spans.steps(t) == 2
    ms = lambda n: program_spans.device_ms(t, n)  # noqa: E731
    assert ms("forward") == pytest.approx((100 + 50 + 20 + 40) * 1e-3 / 2)
    assert ms("conv") == pytest.approx(100e-3 / 2)
    assert ms("norm") == pytest.approx(50e-3 / 2)
    # launched on autograd's thread while the main thread is in backward
    assert ms("backward") == pytest.approx(200e-3 / 2)
    assert ms("optimizer") == pytest.approx(10e-3 / 2)
    assert ms("stage") == pytest.approx(30e-3 / 2)
    assert ms("loss") is None


def test_decode_device_ms_by_span_per_batch():
    t = trace.Trace(decode_events())
    assert program_spans.steps(t) == 2
    # each batch's copy was launched in its ``stage`` inside its ``decode``
    assert program_spans.device_ms(t, "decode") == pytest.approx(40e-3)
    assert program_spans.device_ms(t, "stage") == pytest.approx(10e-3)
    assert program_spans.device_ms(t, "conv") == pytest.approx(20e-3)
    assert program_spans.device_ms(t, "norm") == pytest.approx(10e-3)
    nested = trace.Trace(decode_events() + [R("stage", 115, 10)])
    assert program_spans.device_ms(nested, "stage") == pytest.approx(10e-3)


@pytest.mark.parametrize("events,loop", [(train_events, "train"),
                                         (decode_events, "decode_closed")])
def test_without_the_programs_spans(events, loop):
    plain, spanned = trace.Trace(events(False)), trace.Trace(events(True))
    for name in ("forward", "conv", "stage", "backward"):
        assert program_spans.device_ms(plain, name) is None
    assert program_spans.steps(plain) == 0
    assert plain.busy_s() == spanned.busy_s()
    assert plain.device_ops() == spanned.device_ops()
    assert plain.typed_ops() == spanned.typed_ops()
    ctx = [harness.Context(loop, loop == "train", {}, None, t, CONVS)
           for t in (plain, spanned)]
    assert ctx[0].typed_mp_roofline() == ctx[1].typed_mp_roofline()
    got = [{n: metric_reader(n).read(c) for n in NEW} for c in ctx]
    assert set(got[0].values()) == {None}
    assert any(v is not None for v in got[1].values())


def test_the_loader_takes_the_new_entries():
    bench = json.load(open(BENCH))
    entries = {m["name"]: m for m in bench["per_layer"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in NEW:
        m, mod = entries[name], metric_reader(name)
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]]["workloads"]
            assert name in [x["name"] for x in Cell(w, BENCH).per_layer]
    assert [m["name"] for m in bench["per_layer"]][-len(NEW):] == list(NEW)


def _spans_off(monkeypatch):
    """The program as it was before its spans: every ``annotate`` a no-op
    that opens no range."""
    from fgnn_tpu_torch.utils import profiling

    original = profiling.annotate
    for mod in list(sys.modules.values()):
        if getattr(mod, "annotate", None) is original:
            monkeypatch.setattr(mod, "annotate",
                                lambda name: profiling._NO_SPAN)


@pytest.mark.parametrize("spans", [True, False])
def test_cpu_decode_run_with_and_without_the_programs_spans(spans,
                                                            monkeypatch):
    import fgnn_tpu_torch.train.ldpc  # noqa: F401  (its spans, patched)

    if not spans:
        _spans_off(monkeypatch)
    out = harness.execute(tiny("ldpc_decode.b4096"), 2 ** 31 + 7, 0.2, 1,
                          device="cpu", n_workers=1)
    assert out["correct"], out["check"]
    got = set(out["metrics"])
    # no device on the CPU: the device readers have nothing to read
    assert not got & set(NEW)
    assert "mfu.decode" in got
