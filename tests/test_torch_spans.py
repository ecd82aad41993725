"""The port's spans (``utils.profiling.annotate`` and ``record_spans``) on
the CPU: the shared no-op when nothing records, nested records with their
parent and thread (a step's spans lead by their parents to its span), the
span trees of the LDPC train and decode steps and of the hop train step
(dense tables and ``--coo``) at small widths, one ``conv`` span per
``MPConv`` call and one ``norm`` span per BatchNorm or instance norm, the
typed-mp launches of a step by route and its plain norm calls
(``fused_mp.ROUTES``), the same bits with the recorder on and off, and the
ranges a ``torch.profiler`` trace holds."""

import copy
import json
import sys
import threading
from argparse import Namespace
from collections import Counter

import pytest
import torch

from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.data import ContinuousCodesSP, batches
from fgnn_tpu_torch.models import norm as tnorm
from fgnn_tpu_torch.models.mp_conv import MPConv
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train import synthetic as t_syn
from fgnn_tpu_torch.utils import profiling
from fgnn_tpu_torch.utils.profiling import annotate, record_spans

SMALL = dict(dim_mapping_list=(16, 16, 32, 160, 32), skip_link={3: 1})
PHASES = ["forward", "loss", "backward", "optimizer", "metrics"]


def _ldpc(train=True):
    model = tm.init_weights(tm.LDPCModel(**SMALL), 0).train(train)
    opt = t_common.make_optimizer(model.parameters(), 1e-2)
    batch = next(ContinuousCodesSP(length=8, seed=1).batches(4))

    def step(m, o):
        return t_ldpc.train_step(m, o, batch, "cpu")

    return model, opt, step


def _hop(coo):
    args = Namespace(chain_length=12, hop_cap=3, hop_order=5, seed=2,
                     model_name="hop", neighbour=8, dims=(8, 8, 72, 8, 2),
                     batch_size=4, coo=coo, mixed_lengths="",
                     length_dist="")
    wl = t_syn.SynWorkload("hop", args)
    tm.init_weights(wl.model, 0)
    opt = t_common.make_optimizer(wl.model.parameters(), 3e-3,
                                  weight_decay=0.0)
    batch = next(batches(wl.dataset, 4, 1))

    def step(m, o):
        w = copy.copy(wl)
        w.model = m
        return t_syn.train_step(w, o, batch, "cpu")

    return wl.model, opt, step


WORKLOADS = {"ldpc": _ldpc, "hop": lambda: _hop(False),
             "hop_coo": lambda: _hop(True)}


@pytest.fixture
def calls(monkeypatch):
    """Counts of ``MPConv`` calls and of BatchNorm and instance-norm
    calls, as the model makes them."""
    seen = Counter()
    hooks = []

    def hook_all(model):
        for m in model.modules():
            kind = ("conv" if isinstance(m, MPConv) else
                    "norm" if isinstance(m, tnorm.BatchNorm) else None)
            if kind:
                hooks.append(m.register_forward_pre_hook(
                    lambda *_, k=kind: seen.update([k])))

    original = tnorm.instance_norm

    def counted(*a, **kw):
        seen.update(["norm"])
        return original(*a, **kw)

    for name, mod in list(sys.modules.items()):
        if (name.startswith("fgnn_tpu_torch.")
                and getattr(mod, "instance_norm", None) is original):
            monkeypatch.setattr(mod, "instance_norm", counted)
    yield seen, hook_all
    for h in hooks:
        h.remove()


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _ancestors(spans, s):
    while s.parent >= 0:
        s = spans[s.parent]
        yield s.name


def _root(spans, i):
    """The index of the outermost span that held span ``i``."""
    while spans[i].parent >= 0:
        i = spans[i].parent
    return i


def test_annotate_off_is_one_shared_noop(monkeypatch):
    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(profiling.time, "perf_counter", no_clock)
    a, b = annotate("step"), annotate("conv")
    assert a is b
    with a:
        with b:
            pass
    assert profiling._recorder is None


def test_nested_records_with_parent_step_and_thread():
    with record_spans() as spans:
        with annotate("stage"):
            pass
        with annotate("step"):
            with annotate("forward"):
                with annotate("conv"):
                    pass
                with annotate("step"):  # inside a step: not a step of its own
                    pass

        def work():
            with annotate("stage"):
                with annotate("norm"):
                    pass

        t = threading.Thread(target=work)
        t.start()
        t.join()
        with annotate("decode"):
            with annotate("stage"):
                pass
        with pytest.raises(RuntimeError):
            with record_spans():
                pass
    assert annotate("step") is annotate("norm")
    got = [(s.name, s.parent) for s in spans]
    assert got == [("stage", -1), ("step", -1), ("forward", 1), ("conv", 2),
                   ("step", 2), ("stage", -1), ("norm", 5), ("decode", -1),
                   ("stage", 7)]
    # a step's spans: those whose parents lead to it, on its thread
    assert [_root(spans, i) for i in range(len(spans))] == [
        0, 1, 1, 1, 1, 5, 5, 7, 7]
    main = threading.get_ident()
    assert [s.thread == main for s in spans] == [True] * 5 + [False] * 2 \
        + [True] * 2
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_train_step_span_tree(name, calls):
    seen, hook_all = calls
    model, opt, step = WORKLOADS[name]()
    hook_all(model)
    fused_mp.reset_counts()
    with record_spans() as spans:
        step(model, opt)
    counts = {r: {k: v for k, v in c.items() if v}
              for r, c in fused_mp.ROUTES.items()}
    top = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in top] == ["step"]
    assert _children(spans, 0) == ["stage"] + PHASES
    opt_i = [i for i, s in enumerate(spans) if s.name == "optimizer"][0]
    assert _children(spans, opt_i) == ([] if name == "ldpc" else ["clip"])
    n = Counter(s.name for s in spans)
    assert n["conv"] == seen["conv"] > 0
    assert n["norm"] == seen["norm"] > 0
    for i, s in enumerate(spans):
        assert _root(spans, i) == 0
        if s.name in ("conv", "norm"):
            assert "forward" in _ancestors(spans, s)
    # the step's typed-mp launches by route: the COO step makes none; on
    # the CPU every norm is a plain call
    routes = {r: c for r, c in counts.items() if c}
    assert routes.pop("norm_act") == {"plain_calls": n["norm"]}
    if name == "hop_coo":
        assert routes == {}
    else:
        fwd = "typed_mp_fwd" if name == "ldpc" else "typed_mp_fwd_ext"
        assert routes[fwd]["plain_calls"] > 0


def test_decode_step_span_tree(calls):
    seen, hook_all = calls
    model, _, _ = _ldpc(train=False)
    hook_all(model)
    batch = next(ContinuousCodesSP(length=8, seed=3).batches(4))
    fused_mp.reset_counts()
    with record_spans() as spans:
        t_ldpc.decode_step(model, batch, "cpu")
        t_ldpc.decode_step(model, batch, "cpu")
    tops = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in tops] == ["decode", "decode"]
    for i in tops:
        assert _children(spans, i) == ["stage", "forward"]
    assert [_root(spans, j) for j in range(len(spans))] == [
        max(i for i in tops if i <= j) for j in range(len(spans))]
    routes = {r: {k: v for k, v in c.items() if v}
              for r, c in fused_mp.ROUTES.items()}
    n = Counter(s.name for s in spans)
    assert {r: c for r, c in routes.items() if c} == {
        "typed_mp_fwd": {"plain_calls": fused_mp.COUNTS["plain_calls"]},
        "norm_act": {"plain_calls": n["norm"]}}
    assert fused_mp.COUNTS["plain_calls"] % 2 == 0
    assert n["conv"] == seen["conv"] > 0 and n["norm"] == seen["norm"] > 0


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_same_bits_with_the_recorder_on_and_off(name):
    model, opt, step = WORKLOADS[name]()
    model2 = copy.deepcopy(model)
    opt2 = type(opt)(model2.parameters(), **opt.defaults)
    m1 = step(model, opt)
    with record_spans() as spans:
        m2 = step(model2, opt2)
    assert spans
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for (k, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert (p.grad is None and p2.grad is None) or torch.equal(
            p.grad, p2.grad), k
        assert torch.equal(p, p2), k
    for (k, b), b2 in zip(model.named_buffers(), model2.buffers()):
        assert torch.equal(b, b2), k


def test_profiler_trace_holds_the_spans(tmp_path):
    model, opt, step = _ldpc()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e["name"] for e in events if e.get("cat") == "cpu_op")
    for name in ["step", "stage"] + PHASES:
        assert names[name] == 1, name
    assert names["conv"] > 0 and names["norm"] > 0
    assert annotate("step") is annotate("conv")  # off again afterwards


def test_one_route_registry():
    dicts = [v for k, v in vars(fused_mp).items()
             if k.split("_")[-1] == "COUNTS" and isinstance(v, dict)]
    assert len(fused_mp.ROUTES) == len(dicts) == 13
    assert {id(c) for c in fused_mp.ROUTES.values()} == {id(c) for c in dicts}
    for c in dicts:
        c["kernel_launches"] += 3
    fused_mp.reset_counts()
    assert all(v == 0 for c in dicts for v in c.values())
