"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and ``nvcc``; every test skips elsewhere.  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import pytest
import torch

from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.typed_mp import GatherTable, typed_mp_conv

pytestmark = pytest.mark.cuda

# (B, N_src, Nd, K, T, C): LDPC f2v / v2f, ragged, scalar path (C % 4 != 0)
SHAPES = [(16, 48, 96, 3, 4, 64), (16, 96, 48, 6, 4, 128),
          (5, 136, 8, 5, 3, 24), (3, 17, 11, 2, 1, 30)]
# the routes of the backward and of the extension forward: the staged
# kernel with the planned slab (two slabs a sample at the v2f C=128 shape),
# and the kept kernels
ROUTES = {"staged": None, "kept": 0}


def _bwd_counts(route, ext=False):
    if route == "kept":
        return fused_mp.KEPT_EXT_BWD_COUNTS if ext else \
            fused_mp.KEPT_BWD_COUNTS
    return fused_mp.EXT_BWD_COUNTS if ext else fused_mp.BWD_COUNTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, dev, seed=0):
    B, N, Nd, K, T, C = shape
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, N, T, C, generator=g)
    idx = torch.randint(0, N, (Nd, K), generator=g, dtype=torch.int32)
    et = torch.randn(B, Nd, K, T, generator=g)
    return h.to(dev), idx.to(dev), et.to(dev)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_kernel_matches_plain(cuda, shape, agg):
    h, idx, et = _inputs(shape, cuda)
    want = agg == "max"
    before = fused_mp.COUNTS["kernel_launches"]
    got = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, want)
    assert fused_mp.COUNTS["kernel_launches"] == before + 1
    ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0, want)
    torch.cuda.synchronize()
    out, ref_out = (got[0], ref[0]) if want else (got, ref)
    scale = ref_out.abs().max().item()
    assert (out - ref_out).abs().max().item() <= 1e-5 * scale
    if want:
        msgs = (h[:, idx.long()] * et[..., None]).sum(dim=3)
        top2 = msgs.topk(2, dim=2).values
        clear = (top2[:, :, 0] - top2[:, :, 1]) > 1e-5 * top2[:, :, 0].abs()
        assert (got[1] == ref[1])[clear].all()


def test_conv_on_cuda_launches_the_kernel(cuda):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 48, 16, generator=g)
    idx = torch.randint(0, 48, (96, 3), generator=g)
    et = torch.randn(4, 96, 3, 4, generator=g)
    w = torch.randn(16, 8 * 4, generator=g) * 0.1
    ref = typed_mp_conv(x, idx.numpy(), et, w, 8, aggregator="max")
    fused_mp.reset_counts()
    table = GatherTable(idx.numpy(), 48).to(cuda)
    got = typed_mp_conv(x.to(cuda), table, et.to(cuda), w.to(cuda), 8,
                        aggregator="max")
    assert fused_mp.COUNTS == {"kernel_launches": 1,
                               "bf16_launches": 0, "plain_calls": 0}
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(cuda):
    h, idx, et = _inputs(SHAPES[0], cuda)
    with pytest.raises(TypeError):
        fused_mp.typed_gather_mix_agg(h.double(), idx, et, "max")
    with pytest.raises(ValueError):
        fused_mp.typed_gather_mix_agg(h, idx.cpu(), et, "max")


def _bwd_inputs(shape, dev, agg, seed=0):
    """The backward's inputs: the forward's saved tensors (argmax for max,
    out for softmax), a cotangent g and the transposed table."""
    h, idx, et = _inputs(shape, dev, seed)
    table = GatherTable(idx.cpu().numpy(), shape[1]).to(dev)
    res = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, agg == "max")
    out, am = res if agg == "max" else (res, None)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(out.shape, generator=gen).to(dev)
    return g, h, table, et, am, out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_bwd_kernel_matches_plain(cuda, shape, agg, route):
    g, h, table, et, am, out = _bwd_inputs(shape, cuda, agg)
    counts = _bwd_counts(route)
    before = counts["kernel_launches"]
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=out, slab=ROUTES[route])
    assert counts["kernel_launches"] == before + 1
    ref_dh, ref_det = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out)
    torch.cuda.synchronize()
    for got, ref in ((dh, ref_dh), (det, ref_det)):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_bwd_kernel_is_deterministic(cuda, agg, route):
    g, h, table, et, am, out = _bwd_inputs(SHAPES[1], cuda, agg)
    runs = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=out, slab=ROUTES[route]) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("slab", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_bwd_kernel_every_slab_matches_plain(cuda, agg, slab):
    """One to eight slabs a sample (their partial sums of d_etype added by
    a second pass) against the plain version; sixteen are refused."""
    g, h, table, et, am, out = _bwd_inputs(SHAPES[0], cuda, agg)
    before = fused_mp.BWD_COUNTS["kernel_launches"]
    if 64 // slab > fused_mp.MAX_SLABS:
        with pytest.raises(ValueError):
            fused_mp.typed_gather_mix_agg_bwd(
                g, h, table.idx, table.src_ptr, table.src_edge, et, agg,
                3.0, argmax=am, out=out, slab=slab)
        return
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=out, slab=slab)
    assert fused_mp.BWD_COUNTS["kernel_launches"] == before + 1
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_bwd_wide_graph_takes_the_kept_kernels(cuda):
    shape = (2, 4096, 64, 3, 4, 64)  # no slab of h fits a block
    assert fused_mp.bwd_slab(2, 4096, 64, 3, 4, 64, "max") == 0
    g, h, table, et, am, out = _bwd_inputs(shape, cuda, "max")
    fused_mp.reset_counts()
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, "max", 3.0,
        argmax=am)
    assert fused_mp.KEPT_BWD_COUNTS["kernel_launches"] == 1
    assert fused_mp.BWD_COUNTS["kernel_launches"] == 0
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, "max", 3.0, argmax=am)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("case", ["no_argmax", "no_out", "g_shape",
                                  "table_dtype", "t_limit", "g_device"])
def test_bwd_kernel_refuses_what_it_does_not_take(cuda, case):
    agg = "softmax" if case == "no_out" else "max"
    g, h, table, et, am, out = _bwd_inputs(SHAPES[0], cuda, agg)
    ptr, edge = table.src_ptr, table.src_edge
    if case == "no_argmax":
        am = None
    elif case == "no_out":
        out = None
    elif case == "g_shape":
        g = g[:, :-1].contiguous()
    elif case == "table_dtype":
        ptr = ptr.long()
    elif case == "t_limit":
        B, N, T, C = h.shape
        h = torch.zeros(B, N, 17, C, device=cuda)
        et = torch.zeros(B, table.nd, table.k, 17, device=cuda)
    elif case == "g_device":
        g = g.cpu()
    with pytest.raises((ValueError, TypeError)):
        fused_mp.typed_gather_mix_agg_bwd(g, h, table.idx, ptr, edge, et,
                                          agg, 3.0, argmax=am, out=out)


@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_conv_backward_on_cuda_launches_the_kernel(cuda, agg):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 48, 16, generator=gen)
    idx = torch.randint(0, 48, (96, 3), generator=gen)
    et = torch.randn(4, 96, 3, 4, generator=gen)
    w = torch.randn(16, 8 * 4, generator=gen) * 0.1
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, et, w)]
        table = GatherTable(idx.numpy(), 48).to(dev)
        fused_mp.reset_counts()
        out = typed_mp_conv(ts[0], table, ts[1], ts[2], 8, aggregator=agg)
        out.sin().sum().backward()
        kind = "plain_calls" if dev == "cpu" else "kernel_launches"
        assert fused_mp.COUNTS[kind] == 1 and fused_mp.BWD_COUNTS[kind] == 1
        grads.append([t.grad.cpu() for t in ts])
    for got, ref in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the DIFF/NEIGHBOR mode: h (B, 2 N, T, C), Nd == N


# (B, N, K, T, C): the hop model's pw and hop tables at C=64 and C=2, the
# fixed model's chain table, a ragged shape on the scalar path
EXT_SHAPES = [(8, 60, 2, 16, 64), (8, 60, 9, 16, 64), (8, 60, 9, 16, 2),
              (8, 30, 8, 16, 64), (3, 13, 3, 5, 6)]


def _ext_inputs(shape, dev, agg, seed=0):
    """The extension backward's inputs: h with 2 rows per node, a table
    over the N nodes, the forward's saved tensors and a cotangent."""
    B, N, K, T, C = shape
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, 2 * N, T, C, generator=g).to(dev)
    idx = torch.randint(0, N, (N, K), generator=g, dtype=torch.int32)
    et = torch.randn(B, N, K, T, generator=g).to(dev)
    table = GatherTable(idx.numpy(), N).to(dev)
    res = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        agg == "max", ext=True)
    out, am = res if agg == "max" else (res, None)
    gout = torch.randn(out.shape, generator=g).to(dev)
    return gout, h, table, et, am, out


def _fwd_counts(route):
    return fused_mp.KEPT_EXT_COUNTS if route == "kept" else \
        fused_mp.EXT_COUNTS


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_ext_kernel_matches_plain(cuda, shape, agg, route):
    _, h, table, et, _, _ = _ext_inputs(shape, cuda, "sum")
    want = agg == "max"
    counts = _fwd_counts(route)
    before = counts["kernel_launches"], dict(fused_mp.COUNTS)
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0, want,
                                        ext=True, slab=ROUTES[route])
    assert counts["kernel_launches"] == before[0] + 1
    assert fused_mp.COUNTS == before[1]
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              want, ext=True)
    torch.cuda.synchronize()
    out, ref_out = (got[0], ref[0]) if want else (got, ref)
    scale = ref_out.abs().max().item()
    assert (out - ref_out).abs().max().item() <= 1e-5 * scale
    if want:
        hg = h[:, 0::2, None] + h[:, 1::2][:, table.idx.long()]
        msgs = (hg * et[..., None]).sum(dim=3)
        top2 = msgs.topk(2, dim=2).values
        clear = (top2[:, :, 0] - top2[:, :, 1]) > 1e-5 * top2[:, :, 0].abs()
        assert (got[1] == ref[1])[clear].all()


@pytest.mark.parametrize("want", [True, False])
@pytest.mark.parametrize("shape", EXT_SHAPES)
def test_ext_staged_max_is_bit_equal_to_the_kept_kernel(cuda, shape, want):
    """Both routes form each message in the same order and keep the first
    maximal k, so max's out and argmax agree to the bit."""
    _, h, table, et, _, _ = _ext_inputs(shape, cuda, "sum", seed=4)
    got, kept = (fused_mp.typed_gather_mix_agg(
        h, table.idx, et, "max", 3.0, want, ext=True, slab=slab)
        for slab in (None, 0))
    torch.cuda.synchronize()
    for a, b in zip(got if want else (got,), kept if want else (kept,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_ext_staged_kernel_is_deterministic(cuda, shape, agg):
    _, h, table, et, _, _ = _ext_inputs(shape, cuda, "sum", seed=5)
    want = agg == "max"
    runs = [fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0, want,
                                          ext=True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*(r if want else (r,) for r in runs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("slab", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("agg", ["max", "sum", "softmax"])
def test_ext_staged_kernel_every_slab_matches_plain(cuda, agg, slab):
    """The fixed chain (30, 8) at C=64: one to sixteen slabs a sample; 64
    channels do not fit a block and are refused."""
    _, h, table, et, _, _ = _ext_inputs(EXT_SHAPES[3], cuda, "sum", seed=6)
    if slab not in fused_mp.fwd_slabs(60, 30, 8, 16, 64):
        with pytest.raises(ValueError, match="no forward slab"):
            fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, ext=True,
                                          slab=slab)
        return
    before = fused_mp.EXT_COUNTS["kernel_launches"]
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        ext=True, slab=slab)
    assert fused_mp.EXT_COUNTS["kernel_launches"] == before + 1
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              ext=True)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_ext_staged_all_ties_argmax_is_the_first_edge(cuda):
    # every edge of a row reads the same two rows, so all K messages tie;
    # K=9 puts two edges on one lane and eight lanes on a row
    B, N, K, T, C = 8, 16, 9, 2, 16
    h = torch.randn(1, 1, T, C).expand(B, 2 * N, T, C).contiguous().to(cuda)
    idx = torch.zeros(N, K, dtype=torch.int32, device=cuda)
    et = torch.ones(B, N, K, T, device=cuda)
    _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max",
                                          want_argmax=True, ext=True)
    assert am.max().item() == 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_ext_bwd_kernel_matches_plain(cuda, shape, agg, route):
    g, h, table, et, am, out = _ext_inputs(shape, cuda, agg)
    counts = _bwd_counts(route, ext=True)
    runs = []
    for _ in range(2):
        before = counts["kernel_launches"]
        runs.append(fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
            argmax=am, out=out, ext=True, slab=ROUTES[route]))
        assert counts["kernel_launches"] == before + 1
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out, ext=True)
    torch.cuda.synchronize()
    for got, again, want in zip(runs[0], runs[1], ref):
        assert torch.equal(got, again)  # no atomics: the same bits
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()


@pytest.mark.parametrize("slab", [8, 16])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_ext_bwd_kernel_every_slab_matches_plain(cuda, agg, slab):
    g, h, table, et, am, out = _ext_inputs(EXT_SHAPES[1], cuda, agg)
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
        argmax=am, out=out, ext=True, slab=slab)
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out, ext=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("case", ["nd_ne_n", "rows", "edge_len"])
def test_ext_kernels_refuse_what_they_do_not_take(cuda, case):
    g, h, table, et, am, out = _ext_inputs(EXT_SHAPES[0], cuda, "max")
    idx, ptr, edge = table.idx, table.ext_ptr, table.ext_edge
    if case == "nd_ne_n":  # Nd != N_src
        idx, et = idx[:-1].contiguous(), et[:, :-1].contiguous()
        g, am = g[:, :-1].contiguous(), am[:, :-1].contiguous()
    elif case == "rows":  # h without its second row per node
        h = h[:, :h.shape[1] // 2].contiguous()
    elif case == "edge_len":  # the NO_EXTENSION table
        ptr, edge = table.src_ptr, table.src_edge
    with pytest.raises(ValueError):
        if case != "edge_len":
            fused_mp.typed_gather_mix_agg(h, idx, et, "max", ext=True)
        fused_mp.typed_gather_mix_agg_bwd(g, h, idx, ptr, edge, et, "max",
                                          argmax=am, ext=True)


@pytest.mark.parametrize("ext", ["ORIG_WITH_DIFF", "ORIG_WITH_NEIGHBOR"])
@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_ext_conv_backward_on_cuda_launches_the_kernels(cuda, ext, agg):
    from fgnn_tpu_torch.ops.typed_mp import Extension

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 30, 16, generator=gen)
    idx = torch.randint(0, 30, (30, 8), generator=gen)
    et = torch.randn(4, 30, 8, 16, generator=gen)
    w = torch.randn(32, 8 * 16, generator=gen) * 0.1
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, et, w)]
        table = GatherTable(idx.numpy(), 30).to(dev)
        fused_mp.reset_counts()
        out = typed_mp_conv(ts[0], table, ts[1], ts[2], 8,
                            extension=Extension[ext], aggregator=agg)
        out.sin().sum().backward()
        kind = "plain_calls" if dev == "cpu" else "kernel_launches"
        assert fused_mp.EXT_COUNTS[kind] == 1
        assert fused_mp.EXT_BWD_COUNTS[kind] == 1
        assert fused_mp.COUNTS["kernel_launches"] == 0
        assert fused_mp.KEPT_EXT_COUNTS["kernel_launches"] == 0
        grads.append([t.grad.cpu() for t in ts])
    # d_filters = x^T dh sums B * N rows of dh, each a sum over K * T
    # terms: cuBLAS and the CPU add them in other orders, so each gradient
    # is held to 1e-4 of its largest element (rtol 1e-4 besides)
    for got, ref in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())


# --------------------------------------------------------------------------
# the bf16 mode: bf16 h, out, g and dh, f32 etype and d_etype.  The kernel
# and its plain version round at the same places and sum in f32 in other
# orders, so out lies within one bf16 ulp of the plain value, element by
# element, plus the f32 tolerance (1e-5 of the largest value: a message
# that cancels to near zero has an ulp finer than the f32 sums' rounding),
# and out, dh and d_etype within BF16_KERNEL_REL_L2 (relative L2): the
# limit of chip_smoke.py, above the sound kernels' readings and below those
# of kernels without the bf16 mode's roundings of etype, of each backward
# product and of g/K.  A bf16 conv against the CPU's (matmuls in other
# orders, h rounded to bf16) is held to BF16_REL_L2, the tolerance of the
# plain version against the TPU kernel's bf16 mode
# (tests/test_torch_bf16.py).

BF16_KERNEL_REL_L2 = 5e-4
BF16_REL_L2 = 4e-3
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _ulp_bf16(v):
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -120)))
    return torch.exp2(e - 7)


def _close(got, ref, dtype):
    """got against the plain version's ref: 1e-5 of the largest value for
    f32; for bf16 BF16_KERNEL_REL_L2, and for out one ulp per element plus
    that f32 tolerance."""
    assert torch.isfinite(got.float()).all()
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
        return
    if got.shape == ref.shape and got.dim() == 3:
        assert ((got - ref).abs() <= _ulp_bf16(ref)
                + 1e-5 * ref.abs().max()).all()
    assert ((got - ref).norm() / ref.norm()).item() <= BF16_KERNEL_REL_L2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_typed_kernel_matches_plain(cuda, shape, agg, dtype):
    """The NO_EXTENSION forward in each mode (h in the dtype, etype f32),
    with the f32 log-sum-exp that softmax saves for the backward."""
    dt = DTYPES[dtype]
    h, idx, et = _inputs(shape, cuda)
    h = h.to(dt)
    # the bf16 launches of either route: at these batches the plan sends
    # bf16 to the kept kernel (fwd_sample)
    def bf16_launches():
        return (fused_mp.COUNTS["bf16_launches"]
                + fused_mp.KEPT_BF16_COUNTS["bf16_launches"])

    before = bf16_launches()
    lse = agg == "softmax"
    got = fused_mp.typed_gather_mix_agg(h, idx, et, agg, 3.0, agg == "max",
                                        want_lse=lse)
    assert bf16_launches() == before + (dtype == "bf16")
    ref = fused_mp.typed_gather_mix_agg_plain(h, idx, et, agg, 3.0,
                                              agg == "max", want_lse=lse)
    torch.cuda.synchronize()
    out, ref_out = (got[0], ref[0]) if agg in ("max", "softmax") else (got,
                                                                       ref)
    assert out.dtype == dt
    _close(out, ref_out, dt)
    if lse:
        assert got[1].dtype == torch.float32
        assert (got[1] - ref[1]).abs().max().item() <= \
            1e-5 * ref[1].abs().max().item()
    if agg == "max":
        hx = h.float()
        msgs = (hx[:, idx.long()] * et.to(dt).float()[..., None]).sum(dim=3)
        top2 = msgs.topk(2, dim=2).values
        clear = (top2[:, :, 0] - top2[:, :, 1]) > 2.0 ** -8 * \
            top2[:, :, 0].abs()
        assert (got[1] == ref[1])[clear].all()


def _typed_bwd_inputs(shape, dev, agg, dt, seed=0, ext=False):
    """The backward's inputs in mode dt: the forward's saved tensors
    (argmax for max, the f32 log-sum-exp for softmax), a cotangent g in
    h's dtype and the transposed table."""
    if ext:
        gout, h, table, et, _, _ = _ext_inputs(shape, dev, "sum", seed)
    else:
        h, idx, et = _inputs(shape, dev, seed)
        table = GatherTable(idx.cpu().numpy(), shape[1]).to(dev)
    h = h.to(dt)
    res = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        agg == "max", ext=ext,
                                        want_lse=agg == "softmax")
    out, saved = res if agg in ("max", "softmax") else (res, None)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(out.shape, generator=gen).to(dev).to(dt)
    am = saved if agg == "max" else None
    lse = saved if agg == "softmax" else None
    return g, h, table, et, am, lse


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_typed_bwd_kernel_matches_plain(cuda, shape, agg, dtype):
    """The staged backward (NO_EXTENSION) in each mode, two launches bit
    equal."""
    dt = DTYPES[dtype]
    g, h, table, et, am, lse = _typed_bwd_inputs(shape, cuda, agg, dt)

    # the bf16 launches of either set of products: softmax and C=30 run
    # the scalar ones, counted as the kept bf16 route
    def bf16_launches():
        return (fused_mp.BWD_COUNTS["bf16_launches"]
                + fused_mp.KEPT_BF16_BWD_COUNTS["bf16_launches"])

    before = bf16_launches()
    runs = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=lse) for _ in range(2)]
    assert bf16_launches() == before + 2 * (dtype == "bf16")
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse)
    torch.cuda.synchronize()
    assert runs[0][0].dtype == dt and runs[0][1].dtype == torch.float32
    for got, again, want in zip(runs[0], runs[1], ref):
        assert torch.equal(got, again)
        _close(got, want, dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_typed_ext_kernel_matches_plain(cuda, shape, agg, route, dtype):
    """Both routes of the DIFF/NEIGHBOR forward in each mode; max bit-equal
    between the routes, two launches bit-equal."""
    dt = DTYPES[dtype]
    _, h, table, et, _, _ = _ext_inputs(shape, cuda, "sum")
    h = h.to(dt)
    want = agg == "max"
    runs = [fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0, want,
                                          ext=True, slab=ROUTES[route])
            for _ in range(2)]
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              want, ext=True)
    torch.cuda.synchronize()
    got, again = ((r if want else (r,)) for r in runs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close(got[0], (ref[0] if want else ref), dt)
    if want:
        kept = fused_mp.typed_gather_mix_agg(h, table.idx, et, "max", 3.0,
                                             True, ext=True, slab=0)
        assert all(torch.equal(a, b) for a, b in zip(got, kept))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_typed_ext_bwd_kernel_matches_plain(cuda, shape, agg, dtype):
    dt = DTYPES[dtype]
    g, h, table, et, am, lse = _typed_bwd_inputs(shape, cuda, agg, dt,
                                                 ext=True)
    runs = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
        argmax=am, out=lse, ext=True) for _ in range(2)]
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse, ext=True)
    torch.cuda.synchronize()
    for got, again, want in zip(runs[0], runs[1], ref):
        assert torch.equal(got, again)
        _close(got, want, dt)


@pytest.mark.parametrize("slab", [4, 8, 16, 32])
@pytest.mark.parametrize("agg", ["max", "sum", "softmax"])
def test_bf16_every_slab_matches_plain(cuda, agg, slab):
    """Every slab of both staged kernels in the bf16 mode: the extension
    forward at the fixed chain (30, 8), the backward at LDPC f2v."""
    _, h, table, et, _, _ = _ext_inputs(EXT_SHAPES[3], cuda, "sum", seed=6)
    h = h.to(torch.bfloat16)
    assert slab in fused_mp.fwd_slabs(60, 30, 8, 16, 64, 2)
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        ext=True, slab=slab)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              ext=True)
    _close(got, ref, torch.bfloat16)
    g, h, table, et, am, lse = _typed_bwd_inputs(SHAPES[0], cuda, agg,
                                                 torch.bfloat16)
    if 64 // slab > fused_mp.MAX_SLABS:
        return
    got = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=lse, slab=slab)
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _close(a, b, torch.bfloat16)


@pytest.mark.parametrize("ext", [False, True])
def test_bf16_all_ties_argmax_is_zero(cuda, ext):
    B, N, K, T, C = 8, 16, 9, 2, 16
    h = torch.randn(1, 1, T, C).to(torch.bfloat16).expand(
        B, 2 * N if ext else N, T, C).contiguous().to(cuda)
    idx = torch.zeros(N, K, dtype=torch.int32, device=cuda)
    et = torch.ones(B, N, K, T, device=cuda)
    _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max",
                                          want_argmax=True, ext=ext)
    assert am.max().item() == 0


def test_bf16_kept_backward_refuses(cuda):
    g, h, table, et, am, _ = _typed_bwd_inputs(SHAPES[0], cuda, "max",
                                               torch.bfloat16)
    with pytest.raises(TypeError, match="kept backward"):
        fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.src_ptr, table.src_edge, et, "max",
            argmax=am, slab=0)


@pytest.mark.parametrize("ext", [False, True])
def test_bf16_conv_backward_on_cuda(cuda, ext):
    """A bf16 x takes the kernels' bf16 mode on the card as on the CPU:
    out bf16, the same launches, gradients close to the CPU's."""
    from fgnn_tpu_torch.ops.typed_mp import Extension

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 30, 16, generator=gen).to(torch.bfloat16)
    idx = torch.randint(0, 30, (30, 8), generator=gen)
    et = torch.randn(4, 30, 8, 16, generator=gen)
    w = torch.randn(32 if ext else 16, 8 * 16, generator=gen) * 0.1
    kind = Extension.ORIG_WITH_DIFF if ext else Extension.NO_EXTENSION
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, et, w)]
        table = GatherTable(idx.numpy(), 30).to(dev)
        fused_mp.reset_counts()
        out = typed_mp_conv(ts[0], table, ts[1], ts[2], 8, extension=kind,
                            aggregator="max")
        assert out.dtype == torch.bfloat16
        out.float().sin().sum().backward()
        if dev != "cpu":
            # either route's bf16 launches: at B=4 the plan sends the
            # NO_EXTENSION forward to the kept kernel
            fwd, bwd = ((fused_mp.EXT_COUNTS, fused_mp.EXT_BWD_COUNTS)
                        if ext else (fused_mp.COUNTS, fused_mp.BWD_COUNTS))
            kept = fused_mp.KEPT_BF16_COUNTS["bf16_launches"]
            assert fwd["bf16_launches"] + kept == 1
            assert bwd["bf16_launches"] == 1
        grads.append([t.grad.float().cpu() for t in ts])
    for got, ref in zip(grads[1], grads[0]):
        assert ((got - ref).norm() / ref.norm()).item() <= BF16_REL_L2


# --------------------------------------------------------------------------
# the bf16 mode's new routes: the NO_EXTENSION forward's sample route (the
# kept kernel with slab=0) and the staged backward's packed products (the
# scalar ones with packed=False), held to their plain versions and, bit for
# bit, to the kept routes


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


# the LDPC f2v / v2f shapes at the smallest batch of the sample route (one
# sample for every second SM), and the ragged ones, which the plan sends to
# the kept forward (and C=30 to the scalar products)
BF16_SHAPES = [(66, 48, 96, 3, 4, 64), (66, 96, 48, 6, 4, 128)] + SHAPES[2:]


@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_bf16_new_routes_match_plain_and_kept(cuda, shape, agg):
    B, N, Nd, K, T, C = shape
    sample = fused_mp.fwd_sample(B, N, Nd, K, T, C, 2)
    packed = fused_mp.bwd_packed(
        C, fused_mp.bwd_slab(B, N, Nd, K, T, C, agg, 2), agg, 2)
    assert sample == (B == 66)  # the ragged shapes: a few samples
    assert packed == (agg != "softmax" and C % 4 == 0)
    g, h, table, et, am, lse = _typed_bwd_inputs(shape, cuda, agg,
                                                 torch.bfloat16, seed=4)
    kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
    two = agg in ("max", "softmax")
    fused_mp.reset_counts()
    runs = [fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                          slab=slab, **kw)
            for slab in (None, None, 0)]
    # each launch counted under the route that ran
    assert fused_mp.COUNTS["bf16_launches"] == (2 if sample else 0)
    assert fused_mp.KEPT_BF16_COUNTS["kernel_launches"] == \
        (1 if sample else 3)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              **kw)
    new, again, kept = ((r if two else (r,)) for r in runs)
    torch.cuda.synchronize()
    assert _same_bits(new, again) and _same_bits(new, kept)
    _close(new[0], ref[0] if two else ref, torch.bfloat16)
    bwd = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=lse, packed=packed) for packed in (None, None, False)]
    assert fused_mp.BWD_COUNTS["bf16_launches"] == (2 if packed else 0)
    assert fused_mp.KEPT_BF16_BWD_COUNTS["kernel_launches"] == \
        (1 if packed else 3)
    bref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse)
    torch.cuda.synchronize()
    assert _same_bits(bwd[0], bwd[1]) and _same_bits(bwd[0], bwd[2])
    for got, want in zip(bwd[0], bref):
        _close(got, want, torch.bfloat16)


def _edge_values(shape, gen):
    """Normal values spread over 2^-140 .. 2^20, so that many products
    fall below f32's normal range (2^-126), with +-0 and the largest finite
    bf16 planted at the front."""
    x = torch.randn(shape, generator=gen) * torch.exp2(
        torch.randint(-140, 20, shape, generator=gen).float())
    planted = torch.tensor([0.0, -0.0, 3.3895e38, -3.3895e38, 2.0 ** -126,
                            2.0 ** -133, -2.0 ** -130, 2.0 ** -70])
    x.view(-1)[:planted.numel()] = planted
    return x


@pytest.mark.parametrize("agg", ["max", "sum", "mean"])
def test_bf16_packed_products_give_the_scalar_bits(cuda, agg):
    """The packed bf16 products against the kept scalar ones on g, h and
    etype whose products include values below f32's normal range, zeros of
    both signs and the largest finite: dh and d_etype bit for bit."""
    B, N, Nd, K, T, C = 4, 16, 16, 3, 4, 64
    gen = torch.Generator().manual_seed(5)
    h = _edge_values((B, N, T, C), gen).to(torch.bfloat16).to(cuda)
    g = _edge_values((B, Nd, C), gen).to(torch.bfloat16).to(cuda)
    et = _edge_values((B, Nd, K, T), gen).to(cuda)
    idx = torch.randint(0, N, (Nd, K), generator=gen, dtype=torch.int32)
    table = GatherTable(idx.numpy(), N).to(cuda)
    am = (fused_mp.typed_gather_mix_agg(h, table.idx, et, "max", 3.0, True)[1]
          if agg == "max" else None)
    # dm etype, the products of the dh phase (in f64: exact)
    products = (g.double()[:, :, None, None, :]
                * et.to(torch.bfloat16).double()[..., None])
    assert ((products.abs() < 2.0 ** -126) & (products != 0)).any()
    new, kept = (fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, packed=packed) for packed in (None, False))
    torch.cuda.synchronize()
    assert _same_bits(new, kept)


def test_bf16_packed_route_refuses_f32(cuda):
    g, h, table, et, am, _ = _typed_bwd_inputs(SHAPES[0], cuda, "max",
                                               torch.float32)
    with pytest.raises(ValueError, match="bf16 mode only"):
        fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.src_ptr, table.src_edge, et, "max",
            argmax=am, packed=True)


# --------------------------------------------------------------------------
# the DIFF/NEIGHBOR mode's bf16 designs: the staged forward's bf16 design
# (the kept staged route with kept=True, the first kernel with slab=0) and
# the backward's (ext_bwd_kernel, or the staged kernel in tiles of rows;
# the kept staged route with kept=True, its scalar products with
# packed=False), at the shapes of chip_smoke.py's EXT_SHAPES

# (B, N, K, T, C): the hop step's pw and hop tables at C=64 and C=2, the
# fixed chain, a ragged shape on the scalar path
BF16_EXT_SHAPES = [(32, 60, 2, 16, 64), (32, 60, 9, 16, 64),
                   (32, 60, 2, 16, 2), (32, 60, 9, 16, 2),
                   (32, 30, 8, 16, 64), (3, 13, 3, 5, 6)]
FWD_ROUTES = {"new": {}, "kept": dict(kept=True), "first": dict(slab=0)}
BWD_ROUTES = {"new": {}, "kept": dict(kept=True),
              "scalar": dict(packed=False)}


def _bf16_ext_bwd_design(shape, agg):
    """Whether the backward's bf16 design runs apart from the kept route at
    this shape: ext_bwd_kernel, or the staged kernel in more than one
    tile."""
    B, N, K, T, C = shape
    slab = fused_mp.bwd_slab(B, 2 * N, N, K, T, C, agg, 2)
    return (fused_mp.bwd_ext_plan(B, 2 * N, N, K, T, C, agg)[0] > 0
            or fused_mp.bwd_ext_tiles(B, N, C, slab) > 1)


@pytest.mark.parametrize("shape", BF16_EXT_SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_bf16_ext_designs_match_plain_and_kept(cuda, shape, agg):
    """Each route against the plain version, two launches bit-equal and
    counted under the route that ran; the forward's max (out and argmax)
    bit-equal across the design, the kept staged route and the first
    kernel; the backward's dh bit-equal across its routes for max, sum and
    mean."""
    g, h, table, et, _, _ = _typed_bwd_inputs(shape, cuda, agg,
                                              torch.bfloat16, seed=7,
                                              ext=True)
    kw = dict(want_argmax=agg == "max", want_lse=agg == "softmax")
    two = agg in ("max", "softmax")
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              ext=True, **kw)
    fwd = {}
    for route, extra in FWD_ROUTES.items():
        fused_mp.reset_counts()
        runs = [fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                              ext=True, **kw, **extra)
                for _ in range(2)]
        counts = {"new": fused_mp.EXT_COUNTS,
                  "kept": fused_mp.KEPT_BF16_EXT_COUNTS,
                  "first": fused_mp.KEPT_EXT_COUNTS}[route]
        assert counts["bf16_launches"] == 2
        torch.cuda.synchronize()
        first, again = ((r if two else (r,)) for r in runs)
        assert _same_bits(first, again)
        _close(first[0], ref[0] if two else ref, torch.bfloat16)
        fwd[route] = first
    if agg == "max":
        assert _same_bits(fwd["new"], fwd["kept"])
        assert _same_bits(fwd["new"], fwd["first"])
    am = fwd["new"][1] if agg == "max" else None
    lse = fwd["new"][1] if agg == "softmax" else None
    bref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse, ext=True)
    bwd = {}
    for route, extra in BWD_ROUTES.items():
        fused_mp.reset_counts()
        runs = [fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
            argmax=am, out=lse, ext=True, **extra) for _ in range(2)]
        design = route == "new" and _bf16_ext_bwd_design(shape, agg)
        counts = (fused_mp.EXT_BWD_COUNTS if design
                  else fused_mp.KEPT_BF16_EXT_BWD_COUNTS)
        assert counts["bf16_launches"] == 2
        torch.cuda.synchronize()
        assert _same_bits(runs[0], runs[1])
        for got, want in zip(runs[0], bref):
            _close(got, want, torch.bfloat16)
        bwd[route] = runs[0]
    if agg != "softmax":
        assert _same_bits(bwd["new"][:1], bwd["kept"][:1])
        assert _same_bits(bwd["new"][:1], bwd["scalar"][:1])


def test_bf16_ext_design_all_ties_argmax_is_zero(cuda):
    B, N, K, T, C = 8, 16, 9, 2, 16
    h = torch.randn(1, 1, T, C).to(torch.bfloat16).expand(
        B, 2 * N, T, C).contiguous().to(cuda)
    idx = torch.zeros(N, K, dtype=torch.int32, device=cuda)
    et = torch.ones(B, N, K, T, device=cuda)
    for extra in FWD_ROUTES.values():
        _, am = fused_mp.typed_gather_mix_agg(h, idx, et, "max",
                                              want_argmax=True, ext=True,
                                              **extra)
        assert am.max().item() == 0


@pytest.mark.parametrize("agg", ["max", "sum", "softmax"])
def test_bf16_ext_design_every_slab_matches_plain(cuda, agg):
    """Every slab of both designs at the hop table, each with its tiles."""
    shape = BF16_EXT_SHAPES[1]
    B, N, K, T, C = shape
    g, h, table, et, am, lse = _typed_bwd_inputs(shape, cuda, agg,
                                                 torch.bfloat16, seed=8,
                                                 ext=True)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              ext=True)
    for slab in fused_mp.fwd_bf16_slabs(2 * N, N, K, T, C):
        got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                            ext=True, slab=slab)
        _close(got, ref, torch.bfloat16)
    bref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse, ext=True)
    slabs = (fused_mp.bwd_ext_slabs(B, 2 * N, N, K, T, C, agg)
             or fused_mp.staged_slabs(2 * N, N, K, T, C, agg, 2))
    for slab in slabs:
        got = fused_mp.typed_gather_mix_agg_bwd(
            g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
            argmax=am, out=lse, ext=True, slab=slab)
        torch.cuda.synchronize()
        for a, b in zip(got, bref):
            _close(a, b, torch.bfloat16)


def test_bf16_ext_design_refuses_what_it_does_not_take(cuda):
    """The C entries of both designs refuse arguments they do not take
    rather than launch: the forward's design in f32 or with no tiles, the
    backward's with a slab not of whole 16-byte vectors or softmax."""
    g, h, table, et, am, _ = _typed_bwd_inputs(BF16_EXT_SHAPES[1], cuda,
                                               "max", torch.bfloat16,
                                               ext=True)
    B, N, K, T, C = BF16_EXT_SHAPES[1]
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=cuda)
    for bf16, tiles in ((0, 1), (1, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mp._launch(
                "typed_mp_fwd", "typed_mp_fwd_staged", cuda,
                (B, N, N, K, T, C), h.data_ptr(), table.idx.data_ptr(),
                et.data_ptr(), out.data_ptr(), None, None, B, N, N, K, T, C,
                0, 3.0, 1, bf16, 16, 1, tiles)
    dh, de = torch.empty_like(h), torch.empty_like(et)
    part = et.new_empty((B, 8) + et.shape[1:])
    for cs, agg in ((12, 0), (16, 3)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mp._launch(
                "typed_mp_bwd", "typed_mp_bwd_ext", cuda, (B, N, N, K, T, C),
                g.data_ptr(), am.data_ptr(), h.data_ptr(),
                table.idx.data_ptr(), table.ext_ptr.data_ptr(),
                table.ext_edge.data_ptr(), et.data_ptr(), dh.data_ptr(),
                de.data_ptr(), B, N, K, T, C, agg, part.data_ptr(), cs, 1)


# --------------------------------------------------------------------------
# the COO IR (ops/segment.py): PyTorch ops, deterministic by construction


def _coo_case(dev, extension, masked, seed=0):
    """A ragged graph over 40 nodes (in-degrees 0 to 9, node 3 receives
    none; with ``masked`` node 7 only masked edges) and its inputs."""
    from fgnn_tpu_torch.ops.segment import CooGraph

    g = torch.Generator().manual_seed(seed)
    n, e, t, cin, nout = 40, 200, 16, 24, 32
    dst = torch.randint(0, n, (e,), generator=g)
    dst[dst == 3] = 4
    src = torch.randint(0, n, (e,), generator=g)
    mask = torch.rand(e, generator=g) > 0.2
    if masked:
        mask[dst == 7] = False
    graph = CooGraph(src, dst, mask if masked else None, num_nodes=n)
    cin_eff = cin if extension == "none" else 2 * cin
    inputs = [torch.randn(n, cin, generator=g),
              torch.randn(e, t, generator=g),
              torch.randn(cin_eff, nout * t, generator=g) * 0.2,
              torch.randn(nout, generator=g)]
    return graph.to(dev), [a.to(dev).requires_grad_() for a in inputs], nout


def _coo_run(graph, inputs, nout, extension, agg):
    from fgnn_tpu_torch.ops.segment import typed_mp_conv_coo

    x, et, w, b = inputs
    out = typed_mp_conv_coo(x, graph, et, w, nout, aggregator=agg, bias=b,
                            extension=extension)
    g = torch.Generator().manual_seed(9)
    cot = torch.randn(out.shape, generator=g).to(out.device)
    # the all-masked softmax rows sit at -1e30: their cotangent is 0
    grads = torch.autograd.grad(out, inputs, cot)
    return [out.detach()] + [gr.detach() for gr in grads]


@pytest.mark.parametrize("extension", ["none", "diff", "neighbor"])
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_coo_conv_on_the_card_matches_the_cpu(cuda, extension, agg):
    """Forward and gradients of the COO conv on the card against the same
    op on the CPU: 1e-5 of the largest reference value; no typed-mp
    kernel runs."""
    cpu = _coo_case("cpu", extension, True)
    card = _coo_case(cuda, extension, True)
    fused_mp.reset_counts()
    got = _coo_run(*card, extension, agg)
    ref = _coo_run(*cpu, extension, agg)
    assert all(c["kernel_launches"] == c["plain_calls"] == 0 for c in (
        fused_mp.COUNTS, fused_mp.EXT_COUNTS, fused_mp.BWD_COUNTS,
        fused_mp.EXT_BWD_COUNTS))
    for name, a, r in zip(("out", "dx", "d_etype", "d_filters", "d_bias"),
                          got, ref):
        a = a.cpu()
        if name == "out" and agg == "softmax":
            keep = r > -1e29
            a, r = a[keep], r[keep]
        scale = r.abs().max().item()
        assert (a - r).abs().max().item() <= 1e-5 * scale, name


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_coo_conv_launches_give_the_same_bits(cuda, masked, agg):
    """Two runs of the COO conv (DIFF) and of the per-sample InstanceNorm
    on the card give the same bits, forward and backward."""
    from fgnn_tpu_torch.models.norm import instance_norm
    from fgnn_tpu_torch.ops.segment import segment_bins

    graph, inputs, nout = _coo_case(cuda, "diff", masked, seed=4)
    first = _coo_run(graph, inputs, nout, "diff", agg)
    second = _coo_run(graph, inputs, nout, "diff", agg)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    seg = segment_bins(torch.arange(40) % 5 - 1, 4).to(cuda)
    x = torch.randn(40, 64, device=cuda, requires_grad=True)
    runs = []
    for _ in range(2):
        y = instance_norm(x, seg=seg)
        runs.append((y, torch.autograd.grad(y, x, torch.ones_like(y))[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# the joint LDPC graph of FactorMPNN over [96 variables ; 48 checks]
# (N = Nd = 144, K = 6, T = 2): each variable row names itself in its 3
# padded slots, whose edge types are 0, so their messages are exactly 0
# and tie; the widths of the joint model's convs, C = 64 (max) and C = 2
# (softmax), each with both aggregators
JOINT_CASES = [(64, "max"), (64, "softmax"), (2, "max"), (2, "softmax")]


def _joint_inputs(B, C, dev, seed=0):
    from fgnn_tpu_torch.data.ldpc_graph import default_structure

    st = default_structure()
    g = torch.Generator().manual_seed(seed)
    table = GatherTable(st.joint_nn_idx, 144).to(dev)
    flags = torch.from_numpy(st.joint_etype)
    et = (flags * 2 * torch.rand(B, 144, 6, 2, generator=g)).to(dev)
    h = torch.randn(B, 288, 2, C, generator=g).to(dev)
    return h, table, et


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,agg", JOINT_CASES)
def test_joint_kernels_match_plain(cuda, C, agg, dtype):
    """Both DIFF/NEIGHBOR kernels on the joint table against their plain
    versions in each mode: out (and max's first-win argmax where the top
    two messages differ), then dh and d_etype from the kernel's saved
    argmax or log-sum-exp; the backward walks every repeated self index
    of the transposed table."""
    dt = DTYPES[dtype]
    h, table, et = _joint_inputs(32, C, cuda)
    h = h.to(dt)
    saves = agg in ("max", "softmax")
    kw = dict(ext=True, want_lse=agg == "softmax")
    got = fused_mp.typed_gather_mix_agg(h, table.idx, et, agg, 3.0,
                                        agg == "max", **kw)
    ref = fused_mp.typed_gather_mix_agg_plain(h, table.idx, et, agg, 3.0,
                                              agg == "max", **kw)
    torch.cuda.synchronize()
    (out, saved), (ref_out, ref_saved) = (got, ref) if saves else (
        (got, None), (ref, None))
    assert out.dtype == dt
    _close(out, ref_out, dt)
    if agg == "max":
        hx = h.float()
        hg = hx[:, 0::2, None] + hx[:, 1::2][:, table.idx.long()]
        msgs = (hg * et.to(dt).float()[..., None]).sum(dim=3)
        top2 = msgs.topk(2, dim=2).values
        clear = (top2[:, :, 0] - top2[:, :, 1]) > 2.0 ** -8 * \
            top2[:, :, 0].abs()
        assert clear.float().mean() > 0.5
        assert (saved == ref_saved)[clear].all()
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(out.shape, generator=gen).to(cuda).to(dt)
    am = saved if agg == "max" else None
    lse = saved if agg == "softmax" else None
    runs = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.ext_ptr, table.ext_edge, et, agg, 3.0,
        argmax=am, out=lse, ext=True) for _ in range(2)]
    ref = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=lse, ext=True)
    torch.cuda.synchronize()
    for got, again, want in zip(runs[0], runs[1], ref):
        assert torch.equal(got, again)
        _close(got, want, dt)


# ------------------------------------------ norms with their activation
NORM_ACTIVATIONS = [None, "relu", "leaky_relu"]


def _norm_input(shape, dev, seed, offset=0.0):
    """Values around ``offset`` with a few NaN and infinities."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g) * 2 + offset
    flat = x.view(-1)
    if flat.numel() > 8:
        flat[3], flat[5], flat[7] = float("nan"), float("inf"), -float("inf")
    return x.to(dev)


def _same_bits_nan(a, b):
    """Equal bit for bit where not NaN; NaN at the same places."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def _off_init_bn(C, dev, seed):
    from fgnn_tpu_torch.models.norm import BatchNorm

    bn = BatchNorm(C)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.1, 0.1, generator=g)
        bn.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    return bn.to(dev).eval()


@pytest.mark.parametrize("activation", NORM_ACTIVATIONS)
@pytest.mark.parametrize("C", [64, 128, 256, 30])
@pytest.mark.parametrize("N", [1, 48, 96])
def test_bn_act_bit_equal_to_plain(cuda, N, C, activation):
    """The eval BatchNorm kernel against the module's plain path on the
    card (taken where a graph is recorded for the parameters); C = 30 takes
    the scalar path."""
    x = _norm_input((64, N, C), cuda, N * 1000 + C)
    bn = _off_init_bn(C, cuda, C)
    fused_mp.reset_counts()
    with torch.no_grad():
        got = bn(x, activation=activation)
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 1,
                                        "plain_calls": 0}
    want = bn(x, activation=activation).detach()
    assert fused_mp.NORM_ACT_COUNTS["plain_calls"] == 1
    torch.cuda.synchronize()
    assert _same_bits_nan(got, want)


@pytest.mark.parametrize("activation", NORM_ACTIVATIONS)
def test_bn_act_scalar_path_on_an_unaligned_input(cuda, activation):
    """C % 4 == 0 but x 4 bytes off a 16-byte boundary: scalar loads, the
    same bits; and a 2-D input (the sigma_b regressor's)."""
    C = 128
    bn = _off_init_bn(C, cuda, 7)
    base = _norm_input((1 + 256 * C,), cuda, 8)
    for x in (base[1:].view(256, C), base[:-1].view(2, 128, C)):
        with torch.no_grad():
            got = bn(x, activation=activation)
        want = bn(x, activation=activation).detach()
        torch.cuda.synchronize()
        assert _same_bits_nan(got, want)


@pytest.mark.parametrize("activation", NORM_ACTIVATIONS)
@pytest.mark.parametrize("C", [64, 256, 30])
@pytest.mark.parametrize("N", [1, 48, 96, 200])
def test_in_act_against_f64(cuda, N, C, activation):
    """The instance-norm kernel is no further from an f64 evaluation than
    the plain f32 path on the card, within a factor of 2; N = 200 reads the
    rows beyond the registers again; N = 1 gives zeros; two launches give
    the same bits."""
    from fgnn_tpu_torch.models.norm import instance_norm

    g = torch.Generator().manual_seed(N + C)
    x = (torch.randn(32, N, C, generator=g) * 3
         + torch.randn(1, 1, C, generator=g) * 5).to(cuda)
    fused_mp.reset_counts()
    with torch.no_grad():
        got = instance_norm(x, activation=activation)
        again = instance_norm(x, activation=activation)
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 2,
                                        "plain_calls": 0}
    plain = instance_norm(x.clone().requires_grad_(),
                          activation=activation).detach()
    ref = instance_norm(x.double(), activation=activation)
    assert fused_mp.NORM_ACT_COUNTS["plain_calls"] == 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if N == 1:
        assert not got.any() and not plain.any()
        return
    err = (got.double() - ref).abs().max().item()
    err_plain = (plain.double() - ref).abs().max().item()
    assert err <= 2 * err_plain, (err, err_plain)


def test_ldpc_decode_takes_the_norm_kernels(cuda):
    """An eval LDPCModel at the reference width, B=256: the same decisions
    as the plain path on the card (its forward under autograd), logits
    within 1e-5 of the largest; 108 norm launches a forward, no plain
    norm."""
    from fgnn_tpu_torch.data import ContinuousCodesSP
    from fgnn_tpu_torch.models import LDPCModel, init_weights
    from fgnn_tpu_torch.models.norm import BatchNorm
    from fgnn_tpu_torch.train.ldpc import decode_logits, model_inputs

    model = init_weights(LDPCModel(), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                C = m.weight.numel()
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    model = model.to(cuda).eval()
    batch = next(ContinuousCodesSP(length=256, seed=5).batches(256))
    fused_mp.reset_counts()
    got = decode_logits(model, batch, cuda)
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 108,
                                        "plain_calls": 0}
    want, _ = model(**model_inputs(model, batch, cuda))
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 108,
                                        "plain_calls": 108}
    want = want.detach()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert torch.equal(got >= 0, want >= 0)


def _model_qkv(cuda, B, seed, dtype=torch.float32):
    """q, k, v (B, 8, 144, 16) as the model's views of three (B, 144, 128)
    maps, each map a leaf that requires its gradient."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    maps = [torch.randn(B, 144, 128, device=cuda, generator=g).to(dtype)
            .requires_grad_(True) for _ in range(3)]
    return maps, [m.view(B, 144, 8, 16).transpose(1, 2) for m in maps]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("B", [4, 512])
def test_code_attention_kernels(cuda, B):
    """ECCT's masked attention on the card: the hand-written forward and
    backward over the code's tables, the forward and the gradients of q, k,
    v within 2e-6 (relative L2, the f32 round-off of two summation orders)
    of the plain route on the card; one forward and one backward launch,
    no plain call; q, k, v read as the model's strided views, and out, dq,
    dk, dv written in q's memory order."""
    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops.code_attention import (CodeTables,
                                                   code_attention,
                                                   plain_attention)

    mask = torch.as_tensor(code_mask(parity_check()), device=cuda)
    tables = CodeTables(mask).to(cuda)
    _, (q, k, v) = _model_qkv(cuda, B, B)
    go = torch.randn(B, 144, 128, device=cuda).view(B, 144, 8, 16) \
        .transpose(1, 2)
    fused_mp.reset_counts()
    got = code_attention(q, k, v, mask, tables)
    assert got.stride() == q.stride() == (144 * 128, 16, 128, 1)
    grads = torch.autograd.grad(got, (q, k, v), go)
    assert fused_mp.CODE_ATTENTION_COUNTS == {"kernel_launches": 1,
                                             "bwd_launches": 1,
                                             "plain_calls": 0}
    assert all(t.stride() == q.stride() for t in grads)
    want = plain_attention(q, k, v, mask)
    for a, b in zip([got] + list(grads),
                    [want] + list(torch.autograd.grad(want, (q, k, v), go))):
        assert _rel(a, b) < 2e-6


def test_code_attention_other_layouts(cuda):
    """q contiguous, k the model's strided view, v at an offset the
    kernels do not read in place: k and v are copied into q's layout, out
    and the gradients come back in q's, within 2e-6 of the plain route."""
    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops.code_attention import (CodeTables,
                                                   code_attention,
                                                   plain_attention)

    mask = torch.as_tensor(code_mask(parity_check()), device=cuda)
    tables = CodeTables(mask).to(cuda)
    B, n = 32, 32 * 8 * 144 * 16
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(B, 8, 144, 16, device=cuda, generator=g)
    k = torch.randn(B, 144, 128, device=cuda, generator=g) \
        .view(B, 144, 8, 16).transpose(1, 2)
    v = torch.randn(n + 1, device=cuda, generator=g)[1:].view(B, 8, 144, 16)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    go = torch.randn(B, 8, 144, 16, device=cuda, generator=g)
    got = code_attention(*ins, mask, tables)
    assert got.is_contiguous()
    got = [got] + list(torch.autograd.grad(got, ins, go))
    want = plain_attention(*ins, mask)
    want = [want] + list(torch.autograd.grad(want, ins, go))
    for a, b in zip(got, want):
        assert _rel(a, b) < 2e-6


def test_code_attention_roofline_reads_the_kernel(cuda):
    """One traced call at the cell's batch inside a ``step``: the
    benchmark's yardstick reads its shape from the ``attention`` span, and
    its roofline share from the forward kernel's device time, at most
    100%."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops.code_attention import CodeTables, code_attention
    from fgnn_tpu_torch.utils.profiling import annotate
    from portbench import ecct_yardstick, harness, program_spans, trace

    B = 4096
    mask = torch.as_tensor(code_mask(parity_check()), device=cuda)
    tables = CodeTables(mask).to(cuda)
    with torch.no_grad():
        _, (q, k, v) = _model_qkv(cuda, B, 3)
        code_attention(q, k, v, mask, tables)  # builds the library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            with record_function(trace.WINDOW):
                with annotate("step"):
                    code_attention(q, k, v, mask, tables)
                torch.cuda.synchronize()
    ops = trace.Trace(harness._events(prof))
    assert ecct_yardstick.attention_calls(ops) == [(B, 8, 144, 16, 4)]
    assert program_spans.device_ms(ops, "attention") > 0
    share = ecct_yardstick.attention_roofline(ops)
    assert share is not None and 0 < share <= 100


@pytest.mark.parametrize("dh", [4, 8, 16, 32])
@pytest.mark.parametrize("symmetric", [True, False])
def test_code_attention_head_widths_and_masks(cuda, dh, symmetric):
    """Every head width the kernels take (d = 128 in 128 / dh heads), on
    the code's mask and on a non-symmetric one with a key no query
    attends to: forward and gradients within 2e-6 of the plain route."""
    import numpy as np

    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops.code_attention import (CodeTables,
                                                   code_attention,
                                                   plain_attention)

    if symmetric:
        mask = code_mask(parity_check())
    else:
        rng = np.random.RandomState(dh)
        mask = rng.rand(144, 144) < 0.12
        mask[np.arange(144), (np.arange(144) + 1) % 144] = True
        mask[:, 17] = False  # a key no query attends to
        mask[16, 16] = True  # row 16's shifted key was 17
    mask = torch.as_tensor(mask, device=cuda)
    tables = CodeTables(mask).to(cuda)
    B, H = 64, 128 // dh
    g = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v, go = (torch.randn(B, 144, 128, device=cuda, generator=g)
                   .view(B, 144, H, dh).transpose(1, 2) for _ in range(4))
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = code_attention(*ins, mask, tables)
    got = [got] + list(torch.autograd.grad(got, ins, go))
    want = plain_attention(*ins, mask)
    want = [want] + list(torch.autograd.grad(want, ins, go))
    for a, b in zip(got, want):
        assert _rel(a, b) < 2e-6


def test_code_attention_bf16(cuda):
    """The bf16 instantiation (the compute-dtype policy's q, k, v): an f32
    softmax and f32 sums over the bf16 values, out and the gradients
    rounded once to bf16, so within 4e-3 (relative L2; bf16 keeps 8 bits)
    of the plain route in f32 on the same bf16 values; a forward and a
    backward launch."""
    from fgnn_tpu_torch.data import code_mask, parity_check
    from fgnn_tpu_torch.ops.code_attention import (CodeTables,
                                                   code_attention,
                                                   plain_attention)

    mask = torch.as_tensor(code_mask(parity_check()), device=cuda)
    tables = CodeTables(mask).to(cuda)
    _, qkv = _model_qkv(cuda, 256, 9, torch.bfloat16)
    go = torch.randn(256, 144, 128, device=cuda).to(torch.bfloat16) \
        .view(256, 144, 8, 16).transpose(1, 2)
    fused_mp.reset_counts()
    out = code_attention(*qkv, mask, tables)
    assert out.dtype == torch.bfloat16
    got = [out] + list(torch.autograd.grad(out, qkv, go))
    assert fused_mp.CODE_ATTENTION_COUNTS == {"kernel_launches": 1,
                                             "bwd_launches": 1,
                                             "plain_calls": 0}
    assert all(t.dtype == torch.bfloat16 for t in got)
    ins = [t.detach().float().requires_grad_(True) for t in qkv]
    want = plain_attention(*ins, mask)
    want = [want] + list(torch.autograd.grad(want, ins, go.float()))
    for a, b in zip(got, want):
        assert _rel(a, b) < 4e-3


@pytest.mark.parametrize("dims, layers", [(32, 2), (128, 6)])
def test_ecct_step_on_the_card(cuda, dims, layers):
    """One ECCT train step on the card against the port's CPU path from
    the same weights and batch: one forward and one backward launch per
    layer, no plain call; the loss within 1e-5 and each gradient within
    1e-4 relative L2 (of the larger of its norm and a thousandth of the
    largest: the key maps' biases have a gradient of round-off alone)."""
    import numpy as np

    from fgnn_tpu_torch.models import init_weights
    from fgnn_tpu_torch.train import ecct as T
    from fgnn_tpu_torch.train.common import make_optimizer

    models = [init_weights(T.new_model(dims, layers, 8), 7)
              for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    models[1].to(cuda)
    batch = T.words(np.random.RandomState(6), 128, T.TRAIN_SNRS)
    losses, grads = [], []
    for model, dev in zip(models, ("cpu", cuda)):
        opt = make_optimizer(model.parameters(), T.BASE_LR, weight_decay=0.0)
        fused_mp.reset_counts()
        losses.append(float(T.train_step(model, opt, batch, dev)["loss"]))
        grads.append({n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})
    assert fused_mp.CODE_ATTENTION_COUNTS == {"kernel_launches": layers,
                                             "bwd_launches": layers,
                                             "plain_calls": 0}
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    floor = 1e-3 * max(float(g.norm()) for g in grads[0].values())
    for n, g in grads[0].items():
        assert float((grads[1][n] - g).norm()) <= 1e-4 * max(
            float(g.norm()), floor), n
