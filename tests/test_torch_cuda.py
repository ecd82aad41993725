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
    assert fused_mp.COUNTS == {"kernel_launches": 1, "plain_calls": 0}
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", ["max", "sum", "mean", "softmax"])
def test_bwd_kernel_matches_plain(cuda, shape, agg):
    g, h, table, et, am, out = _bwd_inputs(shape, cuda, agg)
    before = fused_mp.BWD_COUNTS["kernel_launches"]
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=out)
    assert fused_mp.BWD_COUNTS["kernel_launches"] == before + 1
    ref_dh, ref_det = fused_mp.typed_gather_mix_agg_bwd_plain(
        g, h, table.idx, et, agg, 3.0, argmax=am, out=out)
    torch.cuda.synchronize()
    for got, ref in ((dh, ref_dh), (det, ref_det)):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_bwd_kernel_is_deterministic(cuda, agg):
    g, h, table, et, am, out = _bwd_inputs(SHAPES[1], cuda, agg)
    runs = [fused_mp.typed_gather_mix_agg_bwd(
        g, h, table.idx, table.src_ptr, table.src_edge, et, agg, 3.0,
        argmax=am, out=out) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


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
