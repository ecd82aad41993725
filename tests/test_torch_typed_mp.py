"""The port's typed-mp conv and its kernel wrapper against the JAX package.

On the CPU the wrappers run the kernels' plain PyTorch versions; they are
held against ``fgnn_tpu.ops.typed_mp.typed_mp_conv`` (the XLA path) and
against the Pallas kernels in interpret mode: the forward
``_fused_fwd_impl`` (out and the first-win argmax), the backward
``_fused_bwd_impl``, and ``jax.grad`` through ``fused_typed_mp``.  The
kernels themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
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


# --------------------------------------------------------------------------
# the backward


def _pred_args(B=2, N=5, Nd=3, K=2, T=4, C=8):
    h = torch.zeros(B, N, T, C)
    nn = torch.zeros(Nd, K, dtype=torch.int32)
    table = GatherTable(nn.numpy(), N)
    return dict(g=torch.zeros(B, Nd, C), h=h, nn_idx=nn,
                src_ptr=table.src_ptr, src_edge=table.src_edge,
                etype=torch.zeros(B, Nd, K, T),
                argmax=torch.zeros(B, Nd, C, dtype=torch.uint8),
                out=torch.zeros(B, Nd, C))


@pytest.mark.parametrize("agg", AGGS)
def test_kernel_predicates_take_what_the_kernels_take(agg):
    a = _pred_args()
    fused_mp.check_kernel_args(a["h"], a["nn_idx"], a["etype"], agg,
                               agg == "max")
    fused_mp.check_bwd_args(aggregator=agg, **a)
    # max needs only the argmax, softmax only out
    fused_mp.check_bwd_args(aggregator=agg, **{
        **a, "argmax": a["argmax"] if agg == "max" else None,
        "out": a["out"] if agg == "softmax" else None})


@pytest.mark.parametrize("case,match", [
    ("no_argmax", "needs argmax"), ("no_out", "needs out"),
    ("argmax_dtype", "needs argmax"), ("g_shape", "g must be"),
    ("g_dtype", "g must be"), ("ptr_dtype", "transposed table"),
    ("edge_len", "transposed table"), ("t_limit", "T <= 16"),
    ("contiguous", "contiguous")])
def test_bwd_predicate_raises(case, match):
    agg = "softmax" if case == "no_out" else "max"
    if case == "t_limit":
        a = _pred_args(T=17)
    else:
        a = _pred_args()
    B, N, T, C = a["h"].shape
    if case == "no_argmax":
        a["argmax"] = None
    elif case == "no_out":
        a["out"] = None
    elif case == "argmax_dtype":
        a["argmax"] = a["argmax"].long()
    elif case == "g_shape":
        a["g"] = a["g"][:, :-1]
    elif case == "g_dtype":
        a["g"] = a["g"].double()
    elif case == "ptr_dtype":
        a["src_ptr"] = a["src_ptr"].long()
    elif case == "edge_len":
        a["src_edge"] = a["src_edge"][:-1]
    elif case == "contiguous":
        a["g"] = torch.zeros(B, C, a["g"].shape[1]).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        fused_mp.check_bwd_args(aggregator=agg, **a)


def _port_grads(x, nn, et, w, b, C, agg):
    """dx, d_etype, d_filters, d_bias of sum(sin(conv)) through the port."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, et, w, b)]
    out = typed_mp_conv(ts[0], nn, ts[1], ts[2], C, aggregator=agg,
                        bias=ts[3])
    out.sin().sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(conv, x, nn, et, w, b):
    def loss(x, et, w, b):
        return jnp.sum(jnp.sin(conv(x, jnp.asarray(nn), et, w, b)))

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, et, w, b)))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("agg", AGGS)
def test_conv_grads_match_pallas_and_xla(rng, shape, agg):
    """Against jax.grad through the Pallas kernels in interpret mode (f32)
    and through the XLA conv; rtol/atol 5e-5, as tests/test_fused_mp.py
    holds the two JAX paths to each other."""
    x, nn, et, w, b = _mk(rng, *shape)
    C = shape[-1]
    fused_mp.reset_counts()
    got = _port_grads(x, nn, et, w, b, C, agg)
    assert fused_mp.BWD_COUNTS == {"kernel_launches": 0, "plain_calls": 1}
    pallas = _jax_grads(lambda x, nn, et, w, b: j_fused.fused_typed_mp(
        x, nn, et, w, C, aggregator=agg, bias=b, precision="float32"),
        x, nn, et, w, b)
    xla = _jax_grads(lambda x, nn, et, w, b: j_conv(
        x, nn, et, w, C, extension=JExtension.NO_EXTENSION, aggregator=agg,
        bias=b), x, nn, et, w, b)
    for name, g, p, q in zip(["dx", "d_etype", "d_filters", "d_bias"], got,
                             pallas, xla):
        np.testing.assert_allclose(g, p, rtol=5e-5, atol=5e-5,
                                   err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(g, q, rtol=5e-5, atol=5e-5,
                                   err_msg=f"{name} vs XLA")


def test_max_ties_send_the_cotangent_to_the_first_slot(rng):
    """Every k slot ties exactly (tests/test_fused_mp.py:167-192): the port
    routes the whole cotangent to k=0, as the Pallas backward does, where
    the XLA path splits it."""
    B, N, Cin, Nd, K, T, C = 8, 16, 4, 16, 3, 2, 16
    x = np.ones((B, N, Cin), np.float32)
    nn = np.zeros((Nd, K), np.int32)
    et = np.ones((B, Nd, K, T), np.float32)
    w = (rng.randn(Cin, C * T) * 0.1).astype(np.float32)
    b = np.zeros(C, np.float32)
    got = _port_grads(x, nn, et, w, b, C, "max")[1]
    pallas = _jax_grads(lambda x, nn, et, w, b: j_fused.fused_typed_mp(
        x, nn, et, w, C, aggregator="max", precision="float32"),
        x, nn, et, w, b)[1]
    assert not got[:, :, 1:].any()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:])
@pytest.mark.parametrize("agg", AGGS)
def test_plain_backward_matches_pallas_bwd(rng, shape, agg):
    """The plain backward against ``_fused_bwd_impl`` (interpret mode, f32)
    called directly with the same argmax and cotangent."""
    B, N, Cin, Nd, K, T, C = shape
    h = rng.randn(B, N, T, C).astype(np.float32)
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    g = rng.randn(B, Nd, C).astype(np.float32)
    res = _plain(h, nn, et, agg, want_argmax=agg == "max")
    out, am = res if agg == "max" else (res, None)
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(nn),
        None, None, torch.from_numpy(et), agg, 3.0, argmax=am, out=out)

    def rows(a, dtype=jnp.float32):  # (B, Nd, C) -> (Nd, B * C)
        return jnp.asarray(np.transpose(a, (1, 0, 2)).reshape(Nd, B * C),
                           dtype)

    h5 = jnp.asarray(np.transpose(h, (2, 1, 0, 3)).reshape(T, N, B * C))
    et3 = jnp.asarray(np.transpose(et, (3, 0, 2, 1)).reshape(T, B, K * Nd))
    oh = np.zeros((K * Nd, N), np.float32)
    oh[np.arange(K * Nd), nn.T.reshape(-1)] = 1.0
    amax = rows(am.numpy() if am is not None else np.zeros_like(g),
                jnp.bfloat16)
    dh5, det3 = j_fused._fused_bwd_impl(
        h5, et3, jnp.asarray(oh), jnp.asarray(oh.T.copy()), amax, C, agg,
        3.0, "float32", Nd, K, B, B, rows(g))
    ref_dh = np.transpose(np.asarray(dh5).reshape(T, N, B, C), (2, 1, 0, 3))
    ref_det = np.transpose(np.asarray(det3).reshape(T, B, K, Nd),
                           (1, 3, 2, 0))
    np.testing.assert_allclose(dh.numpy(), ref_dh, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(det.numpy(), ref_det, rtol=5e-5, atol=5e-5)


def test_transposed_table_lists_in_edges_in_order(rng):
    nn = rng.randint(0, 7, (9, 4))
    table = GatherTable(nn, 7)
    ptr, edge = table.src_ptr.numpy(), table.src_edge.numpy()
    assert ptr[0] == 0 and ptr[-1] == nn.size
    for j in range(7):
        es = edge[ptr[j]:ptr[j + 1]]
        np.testing.assert_array_equal(es, np.flatnonzero(nn.ravel() == j))
    assert "src_ptr" not in table.state_dict()


def test_argmax_only_when_a_gradient_can_be_asked_for(rng):
    x, nn, et, w, b = _mk(rng, *SHAPES[0])
    C = SHAPES[0][-1]
    wt = torch.from_numpy(w).requires_grad_()
    calls = []
    real = fused_mp.typed_gather_mix_agg

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    fused_mp.typed_gather_mix_agg = spy
    try:
        with torch.inference_mode():
            typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et), wt,
                          C, aggregator="max")
        out = typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                            wt, C, aggregator="max")
    finally:
        fused_mp.typed_gather_mix_agg = real
    assert calls == [False, True]  # want_argmax
    assert out.grad_fn is not None


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
