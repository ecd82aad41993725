"""The kink check of ``chip_smoke.py`` syn_train_vs_cpu (and of
syn_coo_vs_dense's COO step), on the CPU.

The phase holds each f32 hop train step to an f64 run that flips only the
ReLU and max decisions the f32 run took otherwise, and requires each of
those to sit at its kink.  Here the CPU's plain path stands in for the card
(B=4, 3 warm steps): the sound step passes, and a planted wrong argmax
where the gap between messages is clear fails the kink check, even with
the loss check, which catches it first, turned off.
"""

import contextlib
import json

import pytest
import torch

import chip_smoke
from fgnn_tpu_torch.ops import fused_mp


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SYN_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "SYN_WARM_STEPS", 3)


def _emitted(capsys):
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    (line,) = [ln for ln in lines if ln["phase"] == "syn_train_vs_cpu"]
    return line


def test_sound_step_passes_with_flips_at_their_kinks(small, capsys):
    card, cpu, card_vs_cpu, flipped = chip_smoke._syn_train_vs_cpu(
        torch, "cpu", 21, 22)
    line = _emitted(capsys)
    assert line["failed"] == []
    assert sum(flipped["card"].values()) > 0
    assert max(line["flipped_kink_distance_worst"].values()) \
        <= chip_smoke.KINK_TOL
    assert max(card, cpu, card_vs_cpu) <= chip_smoke.GRAD_REL_L2


def test_coo_step_passes_with_flips_at_their_kinks(small, capsys):
    """The COO model (``--coo``, uniform length): its max decisions are
    the sets of edges at each segment's max (amax's), recorded and
    replayed beside the ReLUs'."""
    card, cpu, card_vs_cpu, flipped = chip_smoke._syn_train_vs_cpu(
        torch, "cpu", 21, 22, coo=True)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    (line,) = [ln for ln in lines if ln["phase"] == "syn_coo_vs_cpu"]
    assert line["failed"] == []
    assert flipped["card"]["amax"] > 0
    assert "argmax" not in flipped["card"]   # no typed-mp kernel
    assert max(line["flipped_kink_distance_worst"].values()) \
        <= chip_smoke.KINK_TOL
    assert max(card, cpu, card_vs_cpu) <= chip_smoke.GRAD_REL_L2


def test_wrong_argmax_at_a_clear_gap_fails(small, monkeypatch, capsys):
    real, branches = fused_mp.typed_gather_mix_agg, chip_smoke._branches
    calls = []

    def wrong(h, nn_idx, etype, aggregator, gamma=3.0, want_argmax=False,
              ext=False, **kw):
        res = real(h, nn_idx, etype, aggregator, gamma, want_argmax,
                   ext=ext, **kw)
        if aggregator != "max" or not want_argmax:
            return res
        _, am = res
        hx, et = fused_mp._operands(h, etype)
        msgs = (fused_mp._gathered(hx, nn_idx.long(), ext)
                * et[..., None]).sum(dim=3)
        am = am.clone()
        am[0, 0, 0] = (int(am[0, 0, 0]) + 1) % msgs.shape[2]
        return msgs.gather(2, am[:, :, None].long()).squeeze(2), am

    @contextlib.contextmanager
    def planted(torch_, fm, **kw):
        # the first run of the step stands for the card
        calls.append(kw)
        if len(calls) == 1:
            monkeypatch.setattr(fused_mp, "typed_gather_mix_agg", wrong)
        try:
            with branches(torch_, fm, **kw):
                yield
        finally:
            monkeypatch.setattr(fused_mp, "typed_gather_mix_agg", real)

    monkeypatch.setattr(chip_smoke, "_branches", planted)
    monkeypatch.setattr(chip_smoke, "LOSS_RTOL", 1.0)
    with pytest.raises(RuntimeError, match="at their kinks"):
        chip_smoke._syn_train_vs_cpu(torch, "cpu", 21, 22)
    line = _emitted(capsys)
    assert line["flipped_kink_distance_worst"]["card"] \
        > 1e3 * chip_smoke.KINK_TOL
    assert line["flipped_kink_distance_worst"]["cpu"] <= chip_smoke.KINK_TOL


def test_unrounded_build_finds_each_rounding_once_in_the_shipped_header():
    """``--unrounded`` switches off every bf16 rounding of the kernels:
    rnd<TH>, both forms of the packed mul_rnd2 and the pair form rnd2,
    each found exactly once in csrc/typed_mp_common.cuh."""
    with open(fused_mp.os.path.join(fused_mp._CSRC,
                                    "typed_mp_common.cuh")) as f:
        text = f.read()
    assert len(chip_smoke.UNROUNDED) == 4
    for rounded in chip_smoke.UNROUNDED:
        assert text.count(rounded) == 1
    bare = chip_smoke.unrounded_header(text)
    assert 'asm("mul.rn.bf16x2' not in bare
    assert "__float2bfloat162_rn(w)" not in bare
    assert "from_f32<TH>(v)" not in bare
    assert "__floats2bfloat162_rn(a, b)" not in bare
    for unrounded in chip_smoke.UNROUNDED.values():
        assert unrounded in bare


def test_unrounded_build_refuses_a_header_without_a_rounding():
    (rounded, _), *_ = chip_smoke.UNROUNDED.items()
    with open(fused_mp.os.path.join(fused_mp._CSRC,
                                    "typed_mp_common.cuh")) as f:
        text = f.read()
    for broken in (text.replace(rounded, ""), text + rounded):
        with pytest.raises(RuntimeError, match="found once"):
            chip_smoke.unrounded_header(broken)


def test_ext_bf16_routes_name_the_wrappers_counters():
    """``kernel_check_ext_bf16`` holds each bf16 DIFF/NEIGHBOR route to the
    counter it names: every name is one of fused_mp's counters, reset by
    ``reset_counts``, and every route's arguments are the wrappers'."""
    import inspect

    names = [c for _, _, c in chip_smoke.EXT_BF16_FWD_ROUTES
             + chip_smoke.EXT_BF16_BWD_ROUTES if c]
    names += ["EXT_BWD_COUNTS"]  # the backward design's, where it runs
    for name in names:
        counts = getattr(fused_mp, name)
        counts["bf16_launches"] = 5
        fused_mp.reset_counts()
        assert counts["bf16_launches"] == 0
    for routes, fn in ((chip_smoke.EXT_BF16_FWD_ROUTES,
                        fused_mp.typed_gather_mix_agg),
                       (chip_smoke.EXT_BF16_BWD_ROUTES,
                        fused_mp.typed_gather_mix_agg_bwd)):
        params = inspect.signature(fn).parameters
        assert all(k in params for _, extra, _ in routes for k in extra)
