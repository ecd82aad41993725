"""The trace reader on hand-made Chrome traces: the window between two
markers, busy time, idle gaps by host span, host spans less blocked
launches, and the typed ops with the kernels launched inside them."""

import pytest

from portbench import harness, trace
from portbench import yardstick as y


def X(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                pid=1, args=args)


def window_events():
    # trace clock in us; the first marker is launched at 1000 us, which the
    # host saw at perf_counter 5.0 s
    return [X("cudaLaunchKernel", "cuda_runtime", 1000, 4, correlation=1),
            X("at::cuda::spin_kernel(long)", "kernel", 1010, 2, tid=7,
              correlation=1),
            X("cudaLaunchKernel", "cuda_runtime", 1020, 5, correlation=2),
            X("gemm", "kernel", 1100, 200, tid=7, correlation=2),
            # launched in the input span, then waited 400 us for the queue
            X("cudaLaunchKernel", "cuda_runtime", 1310, 400, correlation=3),
            X("add", "kernel", 1800, 100, tid=7, correlation=3),
            # queued long before it ran
            X("cudaLaunchKernel", "cuda_runtime", 1320, 5, correlation=4),
            X("Memcpy HtoD", "gpu_memcpy", 1950, 50, tid=8, correlation=4),
            X("cudaLaunchKernel", "cuda_runtime", 2040, 4, correlation=5),
            X("at::cuda::spin_kernel(long)", "kernel", 2100, 2, tid=7,
              correlation=5)]


SPANS = [("dispatch", 5.000015, 5.000290), ("input", 5.000300, 5.000800),
         ("sync", 5.000900, 5.001050)]


def test_window_between_markers():
    t = trace.Trace(window_events(), SPANS, mark=5.0)
    assert t.window_s == pytest.approx((2102 - 1010) * 1e-6)
    assert t.busy_s() == pytest.approx(350e-6)
    names = [n for n, _ in t.device_ops()]
    assert names == ["gemm", "add", "Memcpy HtoD"]


def test_idle_gaps_by_host_span():
    t = trace.Trace(window_events(), SPANS, mark=5.0)
    gaps = {d.split(":")[0]: s for d, s in t.idle_gaps()}
    # 1010-1100 ends at the gemm launched in the dispatch span; 1300-1800
    # at the add launched in the input span; 1900-1950 at a copy queued
    # before the gap began; 2000-2102 at the window's end
    assert gaps["dispatch"] == pytest.approx(90e-6)
    assert gaps["input"] == pytest.approx(500e-6)
    assert gaps["queued"] == pytest.approx(50e-6)
    assert gaps["window end"] == pytest.approx(102e-6)


def test_spans_less_blocked_launches():
    t = trace.Trace(window_events(), SPANS, mark=5.0)
    # launches take 4, 5, 400, 5, 4 us: an unblocked one twice the 10th
    # percentile, 8 us; the input span's launch waited 400 - 8 us
    assert t.span_ms("dispatch") == pytest.approx(0.275)
    assert t.span_ms("input") == pytest.approx(0.5 - 0.392)


def op_events():
    return [X("portbench.window", "user_annotation", 0, 1000),
            X("TypedGatherMixAgg", "cpu_op", 20, 30,
              **{"Input Dims": [[2, 48, 4, 64], [2, 96, 3, 4], [96, 3]],
                 "Input type": ["float", "float", "int"],
                 "Sequence number": 7}),
            X("cudaLaunchKernel", "cuda_runtime", 25, 5, correlation=1),
            X("typed_mp_fwd_kernel", "kernel", 100, 50, tid=7, correlation=1),
            X("cudaLaunchKernel", "cuda_runtime", 510, 5, correlation=2),
            X("elementwise", "kernel", 600, 100, tid=7, correlation=2),
            X("TypedGatherMixAggBackward", "cpu_op", 300, 50, tid=2,
              **{"Input Dims": [[2, 96, 64]], "Sequence number": 7}),
            X("cudaLaunchKernel", "cuda_runtime", 310, 5, tid=2,
              correlation=3),
            X("staged_bwd_kernel", "kernel", 800, 50, tid=7, correlation=3)]


CONVS = [dict(n_src=48, nd=96, k=3, t=4, c=64, ext=False, aggregator="max")]


def test_typed_ops_and_roofline():
    t = trace.Trace(op_events())
    fwd, bwd, seconds = t.typed_ops()
    assert len(fwd) == 1 and len(bwd) == 1
    assert seconds == pytest.approx(100e-6)
    ctx = harness.Context("train", True, {}, None, t, CONVS)
    want = (y.least_seconds(*y.typed_fwd_cost(2, 48, 96, 3, 4, 64,
                                              argmax=True))
            + y.least_seconds(*y.typed_bwd_cost(2, 48, 96, 3, 4, 64, "max")))
    assert ctx.typed_mp_roofline() == pytest.approx(100 * want / 100e-6)


def test_backward_paired_by_shape_without_sequence_numbers():
    ev = op_events()
    for e in ev:
        e["args"].pop("Sequence number", None)
    t = trace.Trace(ev)
    ctx = harness.Context("train", True, {}, None, t, CONVS)
    fwd, bwd, _ = t.typed_ops()
    assert ctx._latest_like(fwd, bwd[0]) is fwd[0]
    assert ctx.typed_mp_roofline() > 0


def test_no_window_is_an_error():
    with pytest.raises(ValueError):
        trace.Trace([X("k", "kernel", 0, 1)])


def test_a_lost_marker_is_an_error():
    ev = [e for e in window_events() if e["args"].get("correlation") != 1
          or e["cat"] != "kernel"]
    with pytest.raises(trace.NoWindow):
        trace.Trace(ev, SPANS, mark=5.0)
