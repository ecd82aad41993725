"""The slab planner of the typed-mp forward's DIFF/NEIGHBOR mode
(``fused_mp.fwd_slab``).

The staged CUDA kernel runs one block per (sample, slab of channels, tile
of rows) out of shared memory; the planner picks the slab from the shapes
alone, or the kept kernel where no slab fits.  The kernels run only on the
card (tests/test_torch_cuda.py, chip_smoke.py); these tests hold the plan
to what the kernel takes, at every extension shape that chip_smoke.py
drives.
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
SMOKE = [(n, B, 2 * N, N, K, T, C, agg)
         for n, B, N, K, T, C, agg, _, _ in chip_smoke.EXT_SHAPES]


def _valid(cs, rows, Nd, K, T, C):
    return (C % cs == 0 and (C % 4 or cs % 4 == 0)
            and fused_mp.fwd_bytes(rows, Nd, K, T, cs)
            <= fused_mp.SMEM_PER_BLOCK)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("shape", SMOKE, ids=[s[0] for s in SMOKE])
def test_smoke_shapes_take_the_staged_route(shape, agg):
    _, B, rows, Nd, K, T, C, _ = shape
    cs = fused_mp.fwd_slab(B, rows, Nd, K, T, C, agg)
    assert cs > 0 and _valid(cs, rows, Nd, K, T, C)
    assert fused_mp.checked_fwd_slab(None, B, rows, Nd, K, T, C, agg) == cs


@pytest.mark.parametrize("name,cs,nbytes", [
    # the hop model's pw and hop tables: four slabs of 16 channels at C=64,
    # one of 2 at C=2; the fixed chain: four slabs of 16
    ("hop_pw_c64", 16, 131040), ("hop_high_c64", 16, 132720),
    ("hop_pw_c2", 2, 17760), ("hop_high_c2", 2, 19440),
    ("fixed_nbr_c64", 16, 66240), ("fixed_diff_c64", 16, 66240)])
def test_path_shapes_plan(name, cs, nbytes):
    (shape,) = [s for s in SMOKE if s[0] == name]
    _, B, rows, Nd, K, T, C, agg = shape
    assert agg is not None  # on a main path
    assert fused_mp.fwd_slab(B, rows, Nd, K, T, C, agg) == cs
    assert fused_mp.fwd_bytes(rows, Nd, K, T, cs) == nbytes


def test_fwd_bytes_counts_h_and_table():
    # hop table at 16 channels: 120 rows of 16 x 16 + 16 words (a stride of
    # 16 modulo 32), 540 table entries
    assert fused_mp.fwd_bytes(120, 60, 9, 16, 16) == 4 * (120 * 272 + 540)
    # 8 channels at T=5: 40 words, rounded to 64, plus 8
    assert fused_mp.fwd_bytes(26, 13, 3, 5, 8) == 4 * (26 * 72 + 40)
    # 32 channels need no pad; C=2 takes the backward's 4 words
    assert fused_mp.fwd_bytes(26, 13, 3, 5, 32) == 4 * (26 * 160 + 40)
    assert fused_mp.fwd_bytes(120, 60, 9, 16, 2) == 4 * (120 * 36 + 540)


def test_the_rule_is_the_backwards():
    # the fixed chain at C=64: 32 channels fit, but 32 samples x 2 slabs
    # would leave half the SMs idle; at B=128 they would not
    assert 32 in fused_mp.fwd_slabs(60, 30, 8, 16, 64)
    for B, cs in ((32, 16), (128, 32)):
        assert fused_mp.fwd_slab(B, 60, 30, 8, 16, 64, "max") == cs
        assert fused_mp.bwd_slab(B, 60, 30, 8, 16, 64, "max") == cs


@pytest.mark.parametrize("N", [4096, 9000])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_wide_graphs_take_the_kept_route(N, agg):
    assert fused_mp.fwd_slabs(2 * N, N, 3, 4, 64) == []
    assert fused_mp.fwd_slab(2, 2 * N, N, 3, 4, 64, agg) == 0
    assert fused_mp.checked_fwd_slab(None, 2, 2 * N, N, 3, 4, 64, agg) == 0


@pytest.mark.parametrize("T", [128, 256])
def test_types_beyond_shared_memory_take_the_kept_route(T):
    # the hop table at T=128: even 4 channels need 120 rows of 516 words
    assert fused_mp.fwd_bytes(120, 60, 9, T, 4) > fused_mp.SMEM_PER_BLOCK
    assert fused_mp.fwd_slab(32, 120, 60, 9, T, 64, "max") == 0
    assert fused_mp.fwd_slab(32, 120, 60, 9, 16, 64, "max") == 16


@pytest.mark.parametrize("C,cs", [(6, 6), (30, 30), (2, 2), (3, 3),
                                  (1, 1)])
def test_ragged_channels_take_the_scalar_staged_route(C, cs):
    # one sample: no slab keeps every second SM busy, so the widest runs
    # (the kernel's row tiles spread such a grid instead)
    assert fused_mp.fwd_slab(1, 26, 13, 3, 5, C, "max") == cs
    # 32 samples: the widest divisor that gives every second SM a block
    assert fused_mp.fwd_slab(32, 26, 13, 3, 5, C, "max") == \
        next((c for c in range(C, 0, -1)
              if C % c == 0 and 64 * (C // c) >= fused_mp.SMS), C)


@pytest.mark.parametrize("C", [1, 2, 3, 6, 8, 24, 30, 64, 96, 128, 256])
@pytest.mark.parametrize("rows,Nd,K,T", [(120, 60, 9, 16), (60, 30, 8, 16),
                                         (1500, 750, 4, 16)])
def test_slab_is_the_widest_valid_divisor(C, rows, Nd, K, T):
    valid = [c for c in range(1, C + 1) if _valid(c, rows, Nd, K, T, C)]
    assert fused_mp.fwd_slabs(rows, Nd, K, T, C) == valid[::-1]
    for B in (1, 32, 256):
        cs = fused_mp.fwd_slab(B, rows, Nd, K, T, C, "sum")
        if not valid:
            assert cs == 0
            continue
        busy = [c for c in valid if 2 * B * (C // c) >= fused_mp.SMS]
        assert cs == max(busy or valid)


def test_plan_reads_the_shapes_only():
    plans = {fused_mp.fwd_slab(b, r, n, k, t, c, a)
             for b, r, n, k, t, c, a in [(32, 120, 60, 9, 16, 64, "max")] * 3}
    assert plans == {16}
    # the aggregator changes no byte a block stages
    assert {fused_mp.fwd_slab(32, 60, 30, 8, 16, 64, a) for a in AGGS} \
        == {16}
    with pytest.raises(ValueError, match="unknown aggregator"):
        fused_mp.fwd_slab(32, 60, 30, 8, 16, 64, "min")


@pytest.mark.parametrize("slab", [3, 5, 128, -4])
def test_checked_fwd_slab_refuses_what_the_kernel_does_not_take(slab):
    # 3 and 5 do not divide 64, 128 is wider than C, -4 is no width
    with pytest.raises(ValueError, match="no forward slab"):
        fused_mp.checked_fwd_slab(slab, 32, 120, 60, 9, 16, 64, "max")


def test_checked_fwd_slab_refuses_too_many_bytes():
    # the hop table at 32 channels: 240 KB of h alone
    with pytest.raises(ValueError, match=r"needs 247920\)"):
        fused_mp.checked_fwd_slab(32, 32, 120, 60, 9, 16, 64, "max")


@pytest.mark.parametrize("slab", [0, 4, 8, 16])
def test_checked_fwd_slab_takes_the_kept_route_and_every_fitting_slab(slab):
    # no bound on the number of slabs: they write disjoint channels
    assert fused_mp.checked_fwd_slab(slab, 32, 120, 60, 9, 16, 64,
                                     "max") == slab


def _ext_inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, N, K, T, C = 2, 6, 3, 2, 8
    h = torch.from_numpy(rng.standard_normal((B, 2 * N, T, C), np.float32))
    table = GatherTable(rng.integers(0, N, (N, K)).astype(np.int32), N)
    et = torch.from_numpy(rng.standard_normal((B, N, K, T), np.float32))
    return h, table, et


@pytest.mark.parametrize("slab", [None, 0, 8])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_cpu_forward_is_the_plain_version_on_either_route(slab, agg):
    h, table, et = _ext_inputs()
    want = agg == "max"
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0, want,
                                        ext=True, slab=slab)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              want, ext=True)
    assert fused_mp.EXT_COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 1}
    assert fused_mp.KEPT_EXT_COUNTS == {"kernel_launches": 0,
                                        "bf16_launches": 0}
    for a, b in zip(got if want else (got,), ref if want else (ref,)):
        assert torch.equal(a, b)


def test_reset_counts_clears_the_kept_forward():
    fused_mp.KEPT_EXT_COUNTS["kernel_launches"] = 3
    fused_mp.reset_counts()
    assert fused_mp.KEPT_EXT_COUNTS == {"kernel_launches": 0,
                                        "bf16_launches": 0}


def test_no_extension_has_one_forward_route():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((2, 5, 2, 8), np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, (4, 3)).astype(np.int32))
    et = torch.from_numpy(rng.standard_normal((2, 4, 3, 2), np.float32))
    with pytest.raises(ValueError, match="DIFF/NEIGHBOR mode only"):
        fused_mp.typed_gather_mix_agg(h, idx, et, "max", slab=8)
    # 0 (the kept kernel) and None are the NO_EXTENSION route itself
    for slab in (None, 0):
        torch.testing.assert_close(
            fused_mp.typed_gather_mix_agg(h, idx, et, "max", slab=slab),
            fused_mp.typed_gather_mix_agg_plain(h, idx, et, "max"))


def test_a_newer_shared_header_rebuilds_the_library(tmp_path, monkeypatch):
    """``build`` compares a library with its source and the headers both
    sources include, so an edit of the header alone rebuilds it."""
    assert any(f.endswith(".cuh") for f in os.listdir(os.path.dirname(
        fused_mp.source("typed_mp_fwd"))))
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(fused_mp, "_CSRC", str(csrc))
    monkeypatch.setattr(fused_mp, "BUILD_DIR", str(build_dir))

    def nvcc_path():
        raise RuntimeError("no nvcc in this test")

    monkeypatch.setattr(fused_mp, "nvcc_path", nvcc_path)
    src, header = csrc / "typed_mp_fwd.cu", csrc / "typed_mp_common.cuh"
    src.write_text("")
    header.write_text("")
    build_dir.mkdir()
    lib = build_dir / "libtyped_mp_fwd.so"
    lib.write_bytes(b"")
    for path, t in ((src, 100), (lib, 200), (header, 150)):
        os.utime(path, (t, t))
    assert fused_mp.sources_mtime("typed_mp_fwd") == 150
    assert fused_mp.build(("typed_mp_fwd",)) == {}  # up to date: no nvcc
    os.utime(header, (300, 300))  # newer than the library, the .cu is not
    with pytest.raises(RuntimeError, match="no nvcc in this test"):
        fused_mp.build(("typed_mp_fwd",))


# --------------------------------------------------------------------------
# the bf16 NO_EXTENSION forward's sample route: one block per sample with
# the whole of the sample's h in shared memory

LDPC = [(n, B, N, Nd, K, T, C) for n, B, N, Nd, K, T, C, per_fwd, _
        in chip_smoke.SHAPES if per_fwd]


@pytest.mark.parametrize("name,nbytes", [
    # h (N, T, C) bf16, etype (Nd K T) f32, the table (Nd K) int32
    ("f2v_c64", 48 * 4 * 64 * 2 + 4 * 96 * 3 * 4 + 4 * 96 * 3),
    ("f2v_c128", 48 * 4 * 128 * 2 + 4 * 96 * 3 * 4 + 4 * 96 * 3),
    ("v2f_c64", 96 * 4 * 64 * 2 + 4 * 48 * 6 * 4 + 4 * 48 * 6),
    ("v2f_c128", 96 * 4 * 128 * 2 + 4 * 48 * 6 * 4 + 4 * 48 * 6)])
def test_ldpc_shapes_take_the_bf16_sample_route(name, nbytes):
    (shape,) = [s for s in LDPC if s[0] == name]
    _, B, N, Nd, K, T, C = shape
    assert fused_mp.sample_bytes(N, Nd, K, T, C) == nbytes
    assert nbytes <= fused_mp.SMEM_PER_BLOCK == 232448
    assert fused_mp.fwd_sample(B, N, Nd, K, T, C, 2)


@pytest.mark.parametrize("shape", chip_smoke.SHAPES,
                         ids=[s[0] for s in chip_smoke.SHAPES])
def test_f32_forward_keeps_the_kept_kernel(shape):
    """f32 keeps today's plans: the first kernel for NO_EXTENSION, at
    every shape, whatever fits; bf16 takes the sample route at the path
    shapes (B=256) and the kept kernel at the ragged ones (a few samples,
    C % 8 != 0)."""
    _, B, N, Nd, K, T, C, per_fwd, _ = shape
    assert fused_mp.fwd_sample(B, N, Nd, K, T, C, 2) == bool(per_fwd)
    assert not fused_mp.fwd_sample(B, N, Nd, K, T, C)
    assert not fused_mp.fwd_sample(B, N, Nd, K, T, C, 4)


@pytest.mark.parametrize("N,T,C", [(4096, 4, 64), (96, 4, 1024),
                                   (48, 256, 128)])
def test_a_sample_too_wide_takes_the_kept_bf16_forward(N, T, C):
    assert fused_mp.sample_bytes(N, 96, 3, T, C) > fused_mp.SMEM_PER_BLOCK
    assert not fused_mp.fwd_sample(256, N, 96, 3, T, C, 2)


def test_the_sample_route_plan_reads_the_shapes_only():
    # the largest sample that fits: 113 KB of bf16 h leaves room for the
    # rest at v2f's table
    assert fused_mp.fwd_sample(256, 96, 48, 6, 4, 256, 2)
    assert not fused_mp.fwd_sample(256, 96, 48, 6, 4, 320, 2)
    assert fused_mp.sample_bytes(96, 48, 6, 4, 256) == \
        96 * 4 * 256 * 2 + 4 * 48 * 6 * 4 + 4 * 48 * 6


@pytest.mark.parametrize("B,sample", [
    # one block a sample: the route needs a sample for every second SM
    (1, False), (32, False), (65, False), (66, True), (132, True),
    (256, True), (4096, True)])
def test_the_sample_route_needs_a_block_for_every_second_sm(B, sample):
    assert fused_mp.SMS == 132
    assert fused_mp.fwd_sample(B, 48, 96, 3, 4, 64, 2) == sample


@pytest.mark.parametrize("C,sample", [
    # 8 channels (16 bytes of bf16) a thread: C % 8 == 0 only
    (8, True), (16, True), (64, True), (4, False), (28, False),
    (30, False), (60, False)])
def test_the_sample_route_takes_whole_16_byte_vectors(C, sample):
    assert fused_mp.fwd_sample(256, 48, 96, 3, 4, C, 2) == sample


@pytest.mark.parametrize("slab", [None, 0])
@pytest.mark.parametrize("agg", AGGS)
def test_cpu_bf16_forward_is_the_plain_version_on_either_route(slab, agg):
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((2, 5, 2, 8), np.float32))
    h = h.to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 5, (4, 3)).astype(np.int32))
    et = torch.from_numpy(rng.standard_normal((2, 4, 3, 2), np.float32))
    kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg(h, idx, et, agg, slab=slab, **kw)
    ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, **kw)
    assert fused_mp.COUNTS == {"kernel_launches": 0, "bf16_launches": 0,
                               "plain_calls": 1}
    assert fused_mp.KEPT_BF16_COUNTS == {"kernel_launches": 0,
                                         "bf16_launches": 0}
    two = agg in ("max", "softmax")
    for a, b in zip(got if two else (got,), ref if two else (ref,)):
        assert torch.equal(a, b)


def test_reset_counts_clears_the_kept_bf16_routes():
    for counts in (fused_mp.KEPT_BF16_COUNTS, fused_mp.KEPT_BF16_BWD_COUNTS,
                   fused_mp.KEPT_BF16_EXT_BWD_COUNTS):
        counts["kernel_launches"] = counts["bf16_launches"] = 2
    fused_mp.reset_counts()
    assert all(c == {"kernel_launches": 0, "bf16_launches": 0} for c in (
        fused_mp.KEPT_BF16_COUNTS, fused_mp.KEPT_BF16_BWD_COUNTS,
        fused_mp.KEPT_BF16_EXT_BWD_COUNTS))


# --------------------------------------------------------------------------
# the bf16 DIFF/NEIGHBOR forward's design: etype rounded once in shared
# memory, 8 channels a thread where whole 16-byte vectors allow, its own
# slab and row tiles


def _design_bytes(rows, Nd, K, T, cs, tiles):
    return fused_mp.fwd_bytes(rows, -(-Nd // tiles), K, T, cs, 2, True)


@pytest.mark.parametrize("shape", SMOKE, ids=[s[0] for s in SMOKE])
def test_bf16_design_plans_every_extension_shape(shape):
    _, B, rows, Nd, K, T, C, _ = shape
    cs, tiles = fused_mp.fwd_bf16_plan(B, rows, Nd, K, T, C)
    assert cs in fused_mp.fwd_bf16_slabs(rows, Nd, K, T, C)
    assert 1 <= tiles <= Nd
    assert _design_bytes(rows, Nd, K, T, cs, tiles) <= 232448
    assert cs % (8 if C % 8 == 0 else 1) == 0


@pytest.mark.parametrize("name,cs,tiles,nbytes,blocks", [
    # four slabs of 16 channels, one tile: 128 blocks, rows of the kept
    # design's stride; etype 4 words a (d, k, t) beside the slab; C=2: one
    # slab, five tiles of 12 rows, rows of 16 x 2 channels padded by 16
    # bytes
    ("hop_pw_c64", 16, 1, 120 * 272 * 2 + 4 * 120 + 4 * 60 * 2 * 16, 128),
    ("hop_high_c64", 16, 1, 120 * 272 * 2 + 4 * 540 + 4 * 60 * 9 * 16, 128),
    ("hop_pw_c2", 2, 5, 120 * 40 * 2 + 4 * 24 + 4 * 12 * 2 * 16, 160),
    ("hop_high_c2", 2, 5, 120 * 40 * 2 + 4 * 108 + 4 * 12 * 9 * 16, 160),
    ("fixed_nbr_c64", 16, 1, 60 * 272 * 2 + 4 * 240 + 4 * 30 * 8 * 16, 128),
    ("fixed_diff_c64", 16, 1, 60 * 272 * 2 + 4 * 240 + 4 * 30 * 8 * 16,
     128)])
def test_bf16_design_path_shapes_plan(name, cs, tiles, nbytes, blocks):
    (shape,) = [s for s in SMOKE if s[0] == name]
    _, B, rows, Nd, K, T, C, _ = shape
    assert fused_mp.fwd_bf16_plan(B, rows, Nd, K, T, C) == (cs, tiles)
    assert _design_bytes(rows, Nd, K, T, cs, tiles) == nbytes
    assert B * (C // cs) * tiles == blocks


@pytest.mark.parametrize("B,slab,tiles", [
    # the kept design's rule: one tile where the (sample, slab) blocks give
    # every second SM a block, else enough tiles for every SM
    (32, 16, 1), (32, 32, 3), (32, 64, 5), (1, 2, 60), (3, 6, 44),
    (256, 64, 1)])
def test_bf16_design_tiles(B, slab, tiles):
    assert fused_mp.fwd_bf16_tiles(B, 60, 64 if slab > 6 else slab, slab) \
        == tiles


def test_bf16_design_plan_reads_the_shapes_only():
    plans = {fused_mp.fwd_bf16_plan(32, 120, 60, 9, 16, 64)
             for _ in range(3)}
    assert plans == {(16, 1)}
    # a graph too wide for any slab: no design slab (the kept kernel)
    assert fused_mp.fwd_bf16_plan(2, 8192, 4096, 3, 4, 64) == (0, 0)
    assert fused_mp.fwd_bf16_slabs(8192, 4096, 3, 4, 64) == []


@pytest.mark.parametrize("route", [dict(), dict(slab=0), dict(kept=True),
                                   dict(slab=8)])
@pytest.mark.parametrize("agg", AGGS)
def test_cpu_bf16_ext_forward_is_the_plain_version_on_every_route(route,
                                                                   agg):
    h, table, et = _ext_inputs(4)
    h = h.to(torch.bfloat16)
    kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        ext=True, **kw, **route)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              ext=True, **kw)
    assert fused_mp.EXT_COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 1}
    assert fused_mp.KEPT_BF16_EXT_COUNTS == {"kernel_launches": 0,
                                             "bf16_launches": 0}
    two = agg in ("max", "softmax")
    for a, b in zip(got if two else (got,), ref if two else (ref,)):
        assert torch.equal(a, b)


def test_kept_selects_the_extension_mode_only():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((2, 5, 2, 8), np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, (4, 3)).astype(np.int32))
    et = torch.from_numpy(rng.standard_normal((2, 4, 3, 2), np.float32))
    with pytest.raises(ValueError, match="DIFF/NEIGHBOR mode's kept bf16"):
        fused_mp.typed_gather_mix_agg(h.to(torch.bfloat16), idx, et, "max",
                                      kept=True)


def test_reset_counts_clears_the_kept_bf16_ext_forward():
    fused_mp.KEPT_BF16_EXT_COUNTS["kernel_launches"] = 4
    fused_mp.KEPT_BF16_EXT_COUNTS["bf16_launches"] = 4
    fused_mp.reset_counts()
    assert fused_mp.KEPT_BF16_EXT_COUNTS == {"kernel_launches": 0,
                                             "bf16_launches": 0}
