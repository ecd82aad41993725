"""The slab planner of the typed-mp backward (``fused_mp.bwd_slab``).

The staged CUDA kernel runs one block per (sample, slab of channels) out of
shared memory; the planner picks the slab from the shapes alone, or the
kept kernels where no slab fits.  The kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); these tests hold the plan to
what the kernel takes, at every shape that chip_smoke.py drives.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.typed_mp import GatherTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

AGGS = ["max", "sum", "mean", "softmax"]
# (name, B, rows of h per sample, Nd, K, T, C, the main path's aggregator
# or None)
SMOKE = ([(n, B, N, Nd, K, T, C, "max" if per_step else None)
          for n, B, N, Nd, K, T, C, _, per_step in chip_smoke.SHAPES]
         + [(n, B, 2 * N, N, K, T, C, agg)
            for n, B, N, K, T, C, agg, _, _ in chip_smoke.EXT_SHAPES])


def _valid(cs, rows, Nd, K, T, C, agg):
    return (C % cs == 0 and C // cs <= fused_mp.MAX_SLABS
            and (C % 4 or cs % 4 == 0)
            and fused_mp.staged_bytes(rows, Nd, K, T, cs, agg)
            <= fused_mp.SMEM_PER_BLOCK)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("shape", SMOKE, ids=[s[0] for s in SMOKE])
def test_smoke_shapes_take_the_staged_route(shape, agg):
    _, B, rows, Nd, K, T, C, _ = shape
    cs = fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg)
    assert cs > 0 and _valid(cs, rows, Nd, K, T, C, agg)
    assert fused_mp.staged_bytes(rows, Nd, K, T, cs, agg) <= 227 * 1024


@pytest.mark.parametrize("name,cs,nbytes", [
    # LDPC f2v/v2f (max): one slab a sample, two at v2f C=128
    ("f2v_c64", 64, 88144), ("f2v_c128", 128, 168016),
    ("v2f_c64", 64, 122128), ("v2f_c128", 64, 122128),
    # hop pw and hop tables (four slabs), C=2 (one), the fixed chain (four)
    ("hop_pw_c64", 16, 139216), ("hop_high_c64", 16, 171136),
    ("hop_pw_c2", 2, 29776), ("hop_high_c2", 2, 71776),
    ("fixed_nbr_c64", 16, 100096), ("fixed_diff_c64", 16, 83296)])
def test_path_shapes_plan(name, cs, nbytes):
    (shape,) = [s for s in SMOKE if s[0] == name]
    _, B, rows, Nd, K, T, C, agg = shape
    assert agg is not None  # on a main path
    assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg) == cs
    assert fused_mp.staged_bytes(rows, Nd, K, T, cs, agg) == nbytes


def test_a_grid_that_leaves_most_sms_idle_takes_narrower_slabs():
    # the fixed chain at C=64: 32 channels fit, but 32 samples x 2 slabs
    # would leave half the SMs idle
    assert fused_mp.staged_bytes(60, 30, 8, 16, 32, "max") \
        <= fused_mp.SMEM_PER_BLOCK
    assert fused_mp.bwd_slab(32, 60, 30, 8, 16, 64, "max") == 16
    assert fused_mp.bwd_slab(128, 60, 30, 8, 16, 64, "max") == 32


@pytest.mark.parametrize("rows,Nd", [(4096, 64), (8192, 4096), (9000, 3)])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_wide_graphs_take_the_kept_route(rows, Nd, agg):
    assert fused_mp.bwd_slab(2, rows, Nd, 3, 4, 64, agg) == 0
    assert fused_mp.checked_slab(None, 2, rows, Nd, 3, 4, 64, agg) == 0


@pytest.mark.parametrize("C", [1, 2, 3, 6, 8, 24, 30, 64, 96, 128, 256])
@pytest.mark.parametrize("rows,Nd,K,T", [(48, 96, 3, 4), (120, 60, 9, 16),
                                         (1500, 750, 4, 16)])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_slab_is_the_widest_valid_divisor(C, rows, Nd, K, T, agg):
    valid = [c for c in range(1, C + 1)
             if _valid(c, rows, Nd, K, T, C, agg)]
    assert fused_mp.staged_slabs(rows, Nd, K, T, C, agg) == valid[::-1]
    for B in (1, 32, 256):
        cs = fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg)
        if not valid:
            assert cs == 0
            continue
        busy = [c for c in valid if 2 * B * (C // c) >= fused_mp.SMS]
        assert cs == max(busy or valid)
        assert C % cs == 0


def test_softmax_stages_dm_the_others_g_and_the_argmax():
    # dm is (Nd K, cs) f32 and softmax pads the etype rows by 4 words; g
    # and the argmax (Nd, cs) take 5 bytes a channel
    rows, Nd, K, T, cs = 48, 96, 3, 4, 64
    diff = (fused_mp.staged_bytes(rows, Nd, K, T, cs, "softmax")
            - fused_mp.staged_bytes(rows, Nd, K, T, cs, "max"))
    assert diff == 4 * Nd * K * cs - 5 * Nd * cs + 4 * Nd * K * 4
    assert all(fused_mp.staged_bytes(rows, Nd, K, T, cs, a) == 88144
               for a in ("max", "sum", "mean"))


def test_plan_reads_the_shapes_only():
    plans = {fused_mp.bwd_slab(b, r, n, k, t, c, a)
             for b, r, n, k, t, c, a in [(32, 120, 60, 9, 16, 64, "max")] * 3}
    assert plans == {16}
    assert fused_mp.checked_slab(None, 32, 120, 60, 9, 16, 64, "max") == 16


@pytest.mark.parametrize("slab", [3, 5, 128, -4])
def test_checked_slab_refuses_what_the_kernel_does_not_take(slab):
    # 3 and 5 do not divide 64, 128 is wider than C, -4 is no width
    with pytest.raises(ValueError, match="no staged slab"):
        fused_mp.checked_slab(slab, 16, 48, 96, 3, 4, 64, "max")


def test_checked_slab_refuses_too_many_slabs_and_bytes():
    with pytest.raises(ValueError, match="slab of 4 channels"):
        fused_mp.checked_slab(4, 16, 48, 96, 3, 4, 64, "max")  # 16 slabs
    # the hop table at 32 channels: 240 KB of h alone
    with pytest.raises(ValueError, match=r"needs 296896\)"):
        fused_mp.checked_slab(32, 32, 120, 60, 9, 16, 64, "max")


@pytest.mark.parametrize("slab", [0, 8, 16, 32, 64])
def test_checked_slab_takes_the_kept_route_and_every_fitting_slab(slab):
    assert fused_mp.checked_slab(slab, 16, 48, 96, 3, 4, 64, "max") == slab


@pytest.mark.parametrize("slab", [None, 0, 8])
def test_cpu_backward_is_the_plain_version_on_either_route(slab):
    rng = np.random.default_rng(0)
    B, N, Nd, K, T, C = 2, 6, 5, 3, 2, 8
    h = torch.from_numpy(rng.standard_normal((B, N, T, C), np.float32))
    idx = rng.integers(0, N, (Nd, K)).astype(np.int32)
    table = GatherTable(idx, N)
    et = torch.from_numpy(rng.standard_normal((B, Nd, K, T), np.float32))
    g = torch.from_numpy(rng.standard_normal((B, Nd, C), np.float32))
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, "sum",
        slab=slab)
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(g, h, table.idx, et, "sum")
    assert fused_mp.BWD_COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 1}
    assert fused_mp.KEPT_BWD_COUNTS == {"kernel_launches": 0}
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the bf16 mode's packed route: the staged kernel's plan with bf16 slabs


@pytest.mark.parametrize("name,cs,nbytes", [
    # one slab a sample at every LDPC shape in bf16 (v2f C=128 takes two in
    # f32): the same blocks as the kept scalar route
    ("f2v_c64", 64, 51280), ("f2v_c128", 128, 94288),
    ("v2f_c64", 64, 66832), ("v2f_c128", 128, 125200)])
def test_ldpc_shapes_take_the_packed_bf16_route(name, cs, nbytes):
    (shape,) = [s for s in SMOKE if s[0] == name]
    _, B, rows, Nd, K, T, C, agg = shape
    assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg, 2) == cs
    assert fused_mp.staged_bytes(rows, Nd, K, T, cs, agg, 2) == nbytes
    assert nbytes <= fused_mp.SMEM_PER_BLOCK == 232448
    assert cs % 4 == 0  # the packed pairs: the vector path


@pytest.mark.parametrize("name,cs", [
    ("f2v_c64", 64), ("f2v_c128", 128), ("v2f_c64", 64), ("v2f_c128", 64)])
def test_f32_backward_keeps_its_plan(name, cs):
    (shape,) = [s for s in SMOKE if s[0] == name]
    _, B, rows, Nd, K, T, C, agg = shape
    assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg) == cs
    assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg, 4) == cs


@pytest.mark.parametrize("rows,Nd", [(4096, 64), (9000, 3)])
def test_a_graph_too_wide_takes_no_bf16_slab(rows, Nd):
    # no staged slab, hence no packed route; the kept kernels take f32 only
    assert fused_mp.bwd_slab(2, rows, Nd, 3, 4, 64, "max", 2) == 0


@pytest.mark.parametrize("packed", [None, False, True])
def test_cpu_bf16_backward_is_the_plain_version_on_either_route(packed):
    rng = np.random.default_rng(3)
    B, N, Nd, K, T, C = 2, 6, 5, 3, 2, 8
    h = torch.from_numpy(rng.standard_normal((B, N, T, C), np.float32))
    h = h.to(torch.bfloat16)
    table = GatherTable(rng.integers(0, N, (Nd, K)).astype(np.int32), N)
    et = torch.from_numpy(rng.standard_normal((B, Nd, K, T), np.float32))
    g = torch.from_numpy(rng.standard_normal((B, Nd, C), np.float32))
    g = g.to(torch.bfloat16)
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, "mean",
        packed=packed)
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(g, h, table.idx, et,
                                                  "mean")
    assert fused_mp.BWD_COUNTS["plain_calls"] == 1
    assert fused_mp.KEPT_BF16_BWD_COUNTS == {"kernel_launches": 0,
                                             "bf16_launches": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("agg,esz,C,cs,packed", [
    # max, sum and mean of the bf16 mode on the vector path
    ("max", 2, 64, 64, True), ("sum", 2, 64, 64, True),
    ("mean", 2, 64, 64, True), ("max", 2, 128, 64, True),
    ("max", 2, 24, 12, True),
    # softmax's dm is f32; f32 has the scalar route; C or the slab not a
    # multiple of 4 is the scalar path; no slab is the kept kernels
    ("softmax", 2, 64, 64, False), ("max", 4, 64, 64, False),
    ("max", 2, 30, 30, False), ("max", 2, 2, 2, False),
    ("max", 2, 24, 6, False), ("max", 2, 64, 0, False)])
def test_packed_products_where_both_operands_are_bf16_pairs(agg, esz, C, cs,
                                                            packed):
    assert fused_mp.bwd_packed(C, cs, agg, esz) == packed


@pytest.mark.parametrize("name", ["hop_pw_c64", "hop_high_c64", "hop_pw_c2",
                                  "hop_high_c2"])
def test_hop_path_packs_its_max_convs_and_not_its_softmax_convs(name):
    """The hop step's bf16 backward: on the kept staged route the 10 DIFF
    max convs (C=64) take the packed products and the 2 softmax convs
    (C=2) the scalar ones; the bf16 design runs the max convs on
    ext_bwd_kernel and the softmax convs on the staged kernel in tiles of
    rows."""
    (shape,) = [s for s in chip_smoke.EXT_SHAPES if s[0] == name]
    _, B, N, K, T, C, agg, per_hop, _ = shape
    cs = fused_mp.bwd_slab(B, 2 * N, N, K, T, C, agg, 2)
    assert fused_mp.bwd_packed(C, cs, agg, 2) == (agg == "max")
    slab, tiles = fused_mp.bwd_ext_plan(B, 2 * N, N, K, T, C, agg)
    assert (slab > 0) == (agg == "max")
    if agg != "max":
        assert fused_mp.bwd_ext_tiles(B, N, C, cs) > 1
    assert chip_smoke.HOP_EXT_PER_STEP == 10


# --------------------------------------------------------------------------
# the bf16 DIFF/NEIGHBOR backward's design: ext_bwd_kernel (max, sum and
# mean on 16-byte vectors of 8 channels), elsewhere the staged kernel in
# tiles of destination rows

EXT = [(n, B, 2 * N, N, K, T, C) for n, B, N, K, T, C, _, _, _
       in chip_smoke.EXT_SHAPES]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("shape", EXT, ids=[s[0] for s in EXT])
def test_bf16_design_plans_every_extension_shape(shape, agg):
    _, B, rows, Nd, K, T, C = shape
    cs, tiles = fused_mp.bwd_ext_plan(B, rows, Nd, K, T, C, agg)
    if agg == "softmax" or C % 8:
        # the staged kernel in tiles of rows; the kept route's slab
        assert (cs, tiles) == (0, 0)
        slab = fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg, 2)
        assert 1 <= fused_mp.bwd_ext_tiles(B, Nd, C, slab) <= Nd
        return
    assert cs % 8 == 0 and C % cs == 0 and C // cs <= fused_mp.MAX_SLABS
    assert cs == fused_mp.bwd_ext_slabs(B, rows, Nd, K, T, C, agg)[0]
    assert tiles == fused_mp.bwd_ext_tiles(B, Nd, C, cs)
    assert fused_mp.ext_bwd_bytes(Nd, -(-Nd // tiles), K, T, cs) <= 232448
    assert 1 <= tiles <= Nd


@pytest.mark.parametrize("name,cs,tiles,nbytes,blocks", [
    # the whole of C in four tiles of rows, one block an SM and no partial
    # sums of d_etype: the 60 (30) neighbour rows and the tile's 15 (8) self
    # rows of 16 x 64 channels (128 bytes a type: no pad), g and the argmax
    # of every row, f32 etype and the tables
    ("hop_pw_c64", 64, 4, 75 * 1024 * 2 + 60 * 64 * 3 + 4 * (
        120 * 16 + 120 + 124 + 240), 128),
    ("hop_high_c64", 64, 4, 75 * 1024 * 2 + 60 * 64 * 3 + 4 * (
        540 * 16 + 540 + 124 + 1080), 128),
    ("fixed_diff_c64", 64, 4, 38 * 1024 * 2 + 30 * 64 * 3 + 4 * (
        240 * 16 + 240 + 64 + 480), 128)])
def test_bf16_design_path_shapes_plan(name, cs, tiles, nbytes, blocks):
    (shape,) = [s for s in EXT if s[0] == name]
    _, B, rows, Nd, K, T, C = shape
    assert fused_mp.bwd_ext_plan(B, rows, Nd, K, T, C, "max") == (cs, tiles)
    assert fused_mp.ext_bwd_bytes(Nd, -(-Nd // tiles), K, T, cs) == nbytes
    assert B * (C // cs) * tiles == blocks


def test_bf16_design_stages_the_neighbour_rows_and_the_tiles_self_rows():
    # one tile: the slab of all 2 N rows, as the staged kernel's layout
    for cs in (8, 16, 32):
        assert fused_mp.ext_bwd_bytes(60, 60, 9, 16, cs) == \
            fused_mp.staged_bytes(120, 60, 9, 16, cs, "max", 2)
    # the whole of C at the hop table: all 2 N rows would not fit
    assert fused_mp.staged_bytes(120, 60, 9, 16, 64, "max", 2) > 232448


@pytest.mark.parametrize("name,slab,tiles", [
    # the softmax convs at C=2: 32 one-slab blocks, in four tiles each
    ("hop_pw_c2", 2, 4), ("hop_high_c2", 2, 4),
    # the fixed chain's softmax conv: four slabs, already a block an SM
    ("fixed_nbr_c64", 16, 1), ("ragged_c6", 6, 13)])
def test_bf16_design_tiles_the_staged_kernel(name, slab, tiles):
    (shape,) = [s for s in EXT if s[0] == name]
    _, B, rows, Nd, K, T, C = shape
    agg = "softmax" if name != "ragged_c6" else "max"
    assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg, 2) == slab
    assert fused_mp.bwd_ext_tiles(B, Nd, C, slab) == tiles


@pytest.mark.parametrize("C,slabs", [
    # multiples of 8, 8 times a power of two, at most MAX_SLABS a sample
    (64, [64, 32, 16, 8]), (24, [8]), (128, [128, 64, 32, 16]),
    (48, [16, 8]),
    (12, []), (2, [])])
def test_bf16_design_slabs(C, slabs):
    assert fused_mp.bwd_ext_slabs(32, 60, 30, 8, 16, C, "sum") == [
        cs for cs in slabs
        if fused_mp.ext_bwd_bytes(
            30, -(-30 // fused_mp.bwd_ext_tiles(32, 30, C, cs)), 8, 16, cs)
        <= fused_mp.SMEM_PER_BLOCK]
    assert fused_mp.bwd_ext_slabs(32, 60, 30, 8, 16, C, "softmax") == []


def test_f32_ext_backward_keeps_its_plan():
    # the f32 mode has no design: its slab is the kept rule's, at every
    # extension shape
    for _, B, rows, Nd, K, T, C in EXT:
        for agg in AGGS:
            assert fused_mp.bwd_slab(B, rows, Nd, K, T, C, agg) == \
                fused_mp._busiest(fused_mp.staged_slabs(
                    rows, Nd, K, T, C, agg), B, C)


@pytest.mark.parametrize("route", [dict(), dict(kept=True),
                                   dict(packed=False), dict(slab=8)])
@pytest.mark.parametrize("agg", AGGS)
def test_cpu_bf16_ext_backward_is_the_plain_version_on_every_route(route,
                                                                    agg):
    rng = np.random.default_rng(5)
    B, N, K, T, C = 2, 6, 3, 2, 8
    h = torch.from_numpy(rng.standard_normal((B, 2 * N, T, C), np.float32))
    h = h.to(torch.bfloat16)
    table = GatherTable(rng.integers(0, N, (N, K)).astype(np.int32), N)
    et = torch.from_numpy(rng.standard_normal((B, N, K, T), np.float32))
    g = torch.from_numpy(rng.standard_normal((B, N, C), np.float32))
    g = g.to(torch.bfloat16)
    am = (torch.from_numpy(rng.integers(0, K, (B, N, C)).astype(np.uint8))
          if agg == "max" else None)
    out = (torch.from_numpy(rng.standard_normal((B, N, C), np.float32))
           if agg == "softmax" else None)
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
        argmax=am, out=out, ext=True, **route)
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out, ext=True)
    assert fused_mp.EXT_BWD_COUNTS == {"kernel_launches": 0,
                                       "bf16_launches": 0, "plain_calls": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_kept_backward_selects_the_extension_mode_only():
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((2, 6, 2, 8), np.float32))
    table = GatherTable(rng.integers(0, 6, (5, 3)).astype(np.int32), 6)
    et = torch.from_numpy(rng.standard_normal((2, 5, 3, 2), np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 8), np.float32))
    with pytest.raises(ValueError, match="DIFF/NEIGHBOR mode's kept bf16"):
        fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.src_ptr, table.src_edge, et, "sum",
            kept=True)


def test_bf16_design_plan_reads_the_shapes_only():
    plans = {fused_mp.bwd_ext_plan(32, 120, 60, 9, 16, 64, "max")
             for _ in range(3)}
    assert plans == {(64, 4)}
    # max, sum and mean stage the same bytes: one plan
    assert {fused_mp.bwd_ext_plan(32, 120, 60, 9, 16, 64, a)
            for a in ("max", "sum", "mean")} == {(64, 4)}
    # more samples take fewer tiles: at B=64 two tiles of the whole of C
    # would not fit, so two slabs in one tile each; a graph too wide takes
    # no design slab
    assert fused_mp.bwd_ext_plan(64, 120, 60, 9, 16, 64, "max") == (32, 1)
    assert fused_mp.bwd_ext_plan(256, 120, 60, 9, 16, 64, "max") == (32, 1)
    assert fused_mp.bwd_ext_plan(2, 8192, 4096, 3, 4, 64, "max") == (0, 0)
    with pytest.raises(ValueError, match="unknown aggregator"):
        fused_mp.bwd_ext_plan(32, 120, 60, 9, 16, 64, "min")
