"""The port's typed-mp conv and its kernel wrapper against the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against ``fgnn_tpu.ops.typed_mp.typed_mp_conv`` (the XLA path) and against
the Pallas forward ``_fused_fwd_impl`` in interpret mode (out and the
first-win argmax).  The kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.ops import fused_mp as j_fused
from fgnn_tpu.ops.typed_mp import Extension as JExtension
from fgnn_tpu.ops.typed_mp import typed_mp_conv as j_conv
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.typed_mp import (
    Extension,
    GatherTable,
    tmajor_filters,
    typed_mp_conv,
)

AGGS = ["max", "sum", "mean", "softmax"]

# (B, N_src, Cin, Nd, K, T, C): the shapes of tests/test_fused_mp.py
SHAPES = [
    (6, 48, 16, 96, 3, 4, 32),   # LDPC f2v-like (checks -> vars)
    (4, 96, 16, 48, 6, 4, 24),   # LDPC v2f-like (vars -> checks)
    (2, 8, 8, 16, 2, 1, 8),      # tiny, T=1
    (3, 136, 8, 8, 5, 3, 8),     # N_src > 128
]


def _mk(rng, B, N, Cin, Nd, K, T, C):
    x = rng.randn(B, N, Cin).astype(np.float32)
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    w = (rng.randn(Cin, C * T) * 0.1).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    return x, nn, et, w, b


def _port_conv(x, nn, et, w, C, agg, b=None):
    out = typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                        torch.from_numpy(w), C, aggregator=agg,
                        bias=None if b is None else torch.from_numpy(b))
    return out.numpy()


def _jax_conv(x, nn, et, w, C, agg, b=None):
    return np.asarray(j_conv(
        jnp.asarray(x), jnp.asarray(nn), jnp.asarray(et), jnp.asarray(w), C,
        extension=JExtension.NO_EXTENSION, aggregator=agg,
        bias=None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", AGGS)
def test_conv_matches_jax(rng, shape, agg):
    x, nn, et, w, b = _mk(rng, *shape)
    C = shape[-1]
    np.testing.assert_allclose(_port_conv(x, nn, et, w, C, agg, b),
                               _jax_conv(x, nn, et, w, C, agg, b),
                               rtol=2e-5, atol=2e-5)


# the LDPC global-factor convs: f2v is a broadcast from one source row,
# v2f an identity cover (Nd=1, K=96), both exact shortcuts in both packages
TRIVIAL = [
    ("broadcast", (4, 1, 16, 96, 1, 1, 24)),
    ("broadcast", (3, 1, 8, 10, 2, 3, 8)),
    ("identity", (4, 96, 16, 1, 96, 1, 24)),
    ("identity", (3, 12, 8, 4, 3, 2, 8)),
]


@pytest.mark.parametrize("kind,shape", TRIVIAL)
@pytest.mark.parametrize("agg", AGGS)
def test_trivial_gathers_match_jax(rng, kind, shape, agg):
    x, _, et, w, b = _mk(rng, *shape)
    B, N, Cin, Nd, K, T, C = shape
    nn = (np.zeros((Nd, K), np.int32) if kind == "broadcast"
          else np.arange(N, dtype=np.int32).reshape(Nd, K))
    assert GatherTable(nn, N).kind == kind
    before = dict(fused_mp.COUNTS)
    got = _port_conv(x, nn, et, w, C, agg, b)
    assert fused_mp.COUNTS == before  # no kernel and no plain twin
    np.testing.assert_allclose(got, _jax_conv(x, nn, et, w, C, agg, b),
                               rtol=1e-6, atol=1e-6)


def _pallas_fwd(h, nn, et, agg):
    """fgnn_tpu's Pallas forward (interpret mode, f32) on the port's
    layouts: h (B, N, T, C), nn (Nd, K), et (B, Nd, K, T)."""
    B, N, T, C = h.shape
    Nd, K = nn.shape
    h5 = jnp.asarray(np.transpose(h, (2, 1, 0, 3)).reshape(T, N, B * C))
    et3 = jnp.asarray(np.transpose(et, (3, 0, 2, 1)).reshape(T, B, K * Nd))
    oh = np.zeros((K * Nd, N), np.float32)
    oh[np.arange(K * Nd), nn.T.reshape(-1)] = 1.0
    out, amax = j_fused._fused_fwd_impl(
        h5, et3, jnp.asarray(oh), jnp.asarray(oh.T.copy()), C, agg, 3.0,
        "float32", Nd, K, B, B, "float32")

    def back(a):
        return np.transpose(np.asarray(a, np.float32).reshape(Nd, B, C),
                            (1, 0, 2))

    return back(out), back(amax)


def _plain(h, nn, et, agg, want_argmax=False):
    return fused_mp.typed_gather_mix_agg(
        torch.from_numpy(h), torch.from_numpy(nn), torch.from_numpy(et), agg,
        3.0, want_argmax=want_argmax)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_first_win_argmax_matches_pallas(rng, shape):
    B, N, Cin, Nd, K, T, C = shape
    h = rng.randn(B, N, T, C).astype(np.float32)
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    out, am = _plain(h, nn, et, "max", want_argmax=True)
    ref_out, ref_am = _pallas_fwd(h, nn, et, "max")
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    # compare the argmax where the top two messages are apart
    msgs = np.einsum("bdktc,bdkt->bdkc", h[:, nn], et)
    top2 = np.sort(msgs, axis=2)[:, :, -2:]
    clear = (top2[:, :, 1] - top2[:, :, 0]) > 1e-5 * np.abs(top2[:, :, 1])
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(am.numpy()[clear], ref_am[clear])


def test_all_ties_argmax_is_zero():
    # identical source rows and etype: every k slot ties exactly
    B, N, Nd, K, T, C = 8, 16, 16, 3, 2, 16
    h = np.broadcast_to(np.random.RandomState(0).randn(1, 1, T, C),
                        (B, N, T, C)).astype(np.float32)
    nn = np.zeros((Nd, K), np.int32)
    et = np.ones((B, Nd, K, T), np.float32)
    out, am = _plain(h, nn, et, "max", want_argmax=True)
    ref_out, ref_am = _pallas_fwd(h, nn, et, "max")
    assert am.dtype == torch.uint8
    assert not am.any() and not ref_am.any()
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["sum", "mean", "softmax"])
def test_plain_matches_pallas_other_aggregators(rng, agg):
    B, N, Cin, Nd, K, T, C = SHAPES[1]
    h = rng.randn(B, N, T, C).astype(np.float32)
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    ref_out, _ = _pallas_fwd(h, nn, et, agg)
    np.testing.assert_allclose(_plain(h, nn, et, agg).numpy(), ref_out,
                               rtol=2e-5, atol=2e-5)


def test_tmajor_filters_layout(rng):
    Cin, C, T = 3, 5, 4
    w = rng.randn(Cin, C * T).astype(np.float32)
    wt = tmajor_filters(torch.from_numpy(w), C, T).numpy()
    for c in range(C):
        for t in range(T):
            np.testing.assert_array_equal(wt[:, t * C + c], w[:, c * T + t])


def test_cpu_tensors_take_the_plain_version(rng):
    x, nn, et, w, b = _mk(rng, *SHAPES[0])
    fused_mp.reset_counts()
    _port_conv(x, nn, et, w, SHAPES[0][-1], "max", b)
    assert fused_mp.COUNTS == {"kernel_launches": 0, "plain_calls": 1}
    fused_mp.reset_counts()


def test_non_cpu_non_cuda_tensor_raises():
    h = torch.empty((2, 4, 1, 8), device="meta")
    nn = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    et = torch.empty((2, 3, 2, 1), device="meta")
    with pytest.raises(ValueError, match="no typed-mp forward"):
        fused_mp.typed_gather_mix_agg(h, nn, et, "max")


@pytest.mark.parametrize("case", ["agg", "argmax_sum", "dtype", "table",
                                  "etype_shape", "k_limit", "contiguous"])
def test_kernel_predicate_raises(case):
    B, N, Nd, K, T, C = 2, 5, 3, 2, 4, 8
    h = torch.zeros(B, N, T, C)
    nn = torch.zeros(Nd, K, dtype=torch.int32)
    et = torch.zeros(B, Nd, K, T)
    agg, want = "max", False
    if case == "agg":
        agg = "median"
    elif case == "argmax_sum":
        agg, want = "sum", True
    elif case == "dtype":
        h = h.double()
    elif case == "table":
        nn = torch.zeros(B, Nd, K, dtype=torch.int32)  # per-sample table
    elif case == "etype_shape":
        et = torch.zeros(B, Nd, K, T + 1)
    elif case == "k_limit":
        nn = torch.zeros(Nd, 256, dtype=torch.int32)
        et = torch.zeros(B, Nd, 256, T)
    elif case == "contiguous":
        h = torch.zeros(B, N, C, T).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        fused_mp.check_kernel_args(h, nn, et, agg, want)


def test_backward_is_not_ported_yet(rng):
    h = torch.randn(2, 5, 3, 4, requires_grad=True)
    nn = torch.zeros(3, 2, dtype=torch.int32)
    et = torch.randn(2, 3, 2, 3)
    out = fused_mp.typed_mp_fwd(h, nn, et, "max")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


def test_extensions_and_bad_tables_raise(rng):
    x, nn, et, w, b = _mk(rng, 2, 8, 4, 8, 2, 1, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                      torch.from_numpy(np.concatenate([w, w])), 4,
                      extension=Extension.ORIG_WITH_DIFF)
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        GatherTable(np.full((8, 2), 8), 8)
    with pytest.raises(TypeError):
        typed_mp_conv(torch.from_numpy(x), torch.from_numpy(nn),
                      torch.from_numpy(et), torch.from_numpy(w), 4)
