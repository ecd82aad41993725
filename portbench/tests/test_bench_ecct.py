"""The ECCT cell on the CPU: a tiny run comes out correct; its generator
gives ``ldpc_words.draw``'s words bit for bit; the program's CPU path
against the plain reference at a tiny width; the attention reader's count
against a hand count, on the shapes a real CPU trace of the program
records and on a hand-made op trace."""

import numpy as np
import pytest
import torch

from portbench import ecct_yardstick, harness, program_spans, trace, weights
from portbench.reference import common as C
from portbench.reference import ecct as R
from portbench.registry import Cell, metric_reader
from portbench.tests.test_bench_trace import X
from portbench.tests.tiny import BENCH
from portbench.traffic import ecct_words, ldpc_words

CELL = "ecct_train.b4096"
DEV = torch.device("cpu")


def tiny(batch=8):
    c = Cell(CELL, BENCH)
    c.config.update(dims=32, layers=2)
    c.mix.update(batch=batch, chunk=4, pool_batches=4)
    return c


def test_a_cpu_run_is_correct():
    out = harness.execute(tiny(), 2 ** 31 + 99, 0.2, 0, device="cpu",
                          n_workers=1)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s"}


def test_the_words_are_ldpc_words_draws():
    mix = tiny().mix
    seed = 2 ** 31 + 12345
    pool = ecct_words.make_pool(mix, seed, 8, 1)
    seeds = iter(harness.workers.sub_seeds(seed, "ecct_words", 8))
    assert len(pool) == 4
    for b in pool:
        parts = [ldpc_words.draw(next(seeds), 4, mix["snr_db"],
                                 mix["sigma_b"], mix["burst_prob"])
                 for _ in range(2)]
        assert set(b) == {"y", "label", "snr_db"}
        assert b["y"].dtype == np.float32
        assert np.array_equal(b["y"], np.concatenate(
            [p["y"] for p in parts]).astype(np.float32))
        for k in ("label", "snr_db"):
            assert np.array_equal(b[k], np.concatenate([p[k] for p in parts]))


def test_program_against_the_reference():
    cell = tiny(4)
    fam = cell.family()
    specs = fam.specs(cell.config)
    flat, state = weights.make(specs, 5, DEV)
    prog = fam.Program(cell.config, cell.mix, 4, DEV)
    prog.model.load_state_dict(state)
    batch = ecct_words.make_pool(cell.mix, 9, 4, 1)[0]
    ref = fam.Reference(cell.config, cell.mix, DEV)
    y, f = ref.inputs(batch, torch.float32)
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.views(flat, specs).items()}
    staged = prog.stage({k: torch.as_tensor(v) for k, v in batch.items()})
    assert torch.equal(staged["y"], y)
    assert torch.equal(staged["flips"].float(), f)
    with torch.no_grad():
        flip = prog.model(y) > 0
    assert torch.equal(prog.decode(batch), ((y > 0) ^ flip).to(torch.int32))
    lp = prog.model(staged["y"])
    lr = R.forward(P, cell.config, ref.tabs, y)
    # f32 round-off over two layers reads under 1e-6
    assert float((lp - lr).detach().norm() / lr.detach().norm()) < 1e-5
    torch.nn.functional.binary_cross_entropy_with_logits(lp, f).backward()
    leaves = [s[0] for s in specs if C.is_parameter(s)]
    g = torch.autograd.grad(
        torch.nn.functional.binary_cross_entropy_with_logits(lr, f),
        [P[k] for k in leaves])
    named = dict(prog.model.named_parameters())
    # against the larger of the leaf's norm and a thousandth of the largest
    # leaf's: the key maps' biases have a gradient of round-off alone (a
    # score shifted alike for every key of a query leaves the softmax)
    floor = 1e-3 * max(float(gr.norm()) for gr in g)
    for k, gr in zip(leaves, g):
        assert float((named[k].grad - gr).norm()) <= 1e-4 * max(
            float(gr.norm()), floor), k


def test_attention_shapes_from_a_cpu_trace_and_the_hand_count():
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = tiny(4)
    fam = cell.family()
    prog = fam.Program(cell.config, cell.mix, 4, DEV)
    batch = {k: torch.as_tensor(v) for k, v in
             ecct_words.make_pool(cell.mix, 9, 4, 1)[0].items()}
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function(trace.WINDOW):
            prog.step(prog.stage(batch))
    ops = trace.Trace(harness._events(prof))
    calls = ecct_yardstick.attention_calls(ops)
    assert calls == [(4, 8, 144, 4, 4)] * 2
    assert program_spans.steps(ops) == 1
    # the CPU trace holds no device work: the readers give nothing
    assert program_spans.device_ms(ops, "attention") is None
    assert ecct_yardstick.attention_roofline(ops) is None
    # by hand: q, k, v and out of 4 x 8 x 144 x 4 f32; 2198 allowed pairs,
    # each 4 d = 16 operations and 5 of the softmax, and one division per
    # output element
    assert R.allowed_pairs() == 2198
    nbytes, flops = ecct_yardstick.attention_fwd_cost(4, 8, 144, 4, 2198)
    assert nbytes == 4 * 4 * (4 * 8 * 144 * 4)
    assert flops == 4 * 8 * (2198 * 21 + 144 * 4)


def test_attention_roofline_on_a_hand_made_trace():
    dims = [[2, 8, 144, 16]] * 3 + [[144, 144]]
    events = [X("portbench.window", "user_annotation", 0, 3000),
              X("step", "cpu_op", 10, 2000),
              X("attention", "cpu_op", 100, 100),
              X("aten::scaled_dot_product_attention", "cpu_op", 105, 90,
                **{"Input Dims": dims,
                   "Input type": ["float"] * 3 + ["bool"]}),
              X("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=1),
              X("fmha_kernel", "kernel", 300, 40, tid=7, correlation=1),
              X("attention", "cpu_op", 400, 100),
              X("aten::transpose", "cpu_op", 402, 3,
                **{"Input Dims": [[2, 8, 144, 16], [], []],
                   "Input type": ["c10::BFloat16", "", ""]}),
              X("cudaLaunchKernel", "cuda_runtime", 410, 5, correlation=2),
              X("softmax", "kernel", 600, 60, tid=7, correlation=2),
              X("cudaLaunchKernel", "cuda_runtime", 700, 5, correlation=3),
              X("gemm", "kernel", 800, 500, tid=7, correlation=3)]
    ops = trace.Trace(events)
    assert ecct_yardstick.attention_calls(ops) == [(2, 8, 144, 16, 4),
                                                   (2, 8, 144, 16, 2)]
    least = sum(max(b / 3.35e12, f / 67e12) for b, f in (
        (4 * 4 * 2 * 8 * 144 * 16, 2 * 8 * (2198 * 69 + 144 * 16)),
        (4 * 2 * 2 * 8 * 144 * 16, 2 * 8 * (2198 * 69 + 144 * 16))))
    ctx = harness.Context("train", True, {}, None, ops, [])
    got = metric_reader("attention_roofline.train").read(ctx)
    assert got == pytest.approx(100.0 * least / 100e-6, rel=1e-12)
    assert metric_reader("attention_device_ms.train").read(ctx) == \
        pytest.approx(0.1)
    # a decode loop, and a trace without the program's spans, read nothing
    assert metric_reader("attention_roofline.train").read(
        harness.Context("decode_closed", False, {}, None, ops, [])) is None
    bare = trace.Trace([e for e in events if e["name"] != "attention"])
    ctx = harness.Context("train", True, {}, None, bare, [])
    assert metric_reader("attention_roofline.train").read(ctx) is None
    assert metric_reader("attention_device_ms.train").read(ctx) is None
