"""The port's typed-mp conv and its kernel wrapper against the JAX package.

On the CPU the wrappers run the kernels' plain PyTorch versions; they are
held against ``fgnn_tpu.ops.typed_mp.typed_mp_conv`` (the XLA path) and
against the Pallas kernels in interpret mode: the forward
``_fused_fwd_impl`` (out and the first-win argmax), the backward
``_fused_bwd_impl``, and ``jax.grad`` through ``fused_typed_mp``, in the
NO_EXTENSION mode and in the DIFF/NEIGHBOR mode (the stacked operand).  The
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
    assert fused_mp.COUNTS == {"kernel_launches": 0, "bf16_launches": 0,
                               "plain_calls": 1}
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
    assert fused_mp.BWD_COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 1}
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
    # an extension indexes x by destination: Nd != N_src raises, as do
    # filters without the 2 C_in rows
    x, nn, et, w, b = _mk(rng, 2, 8, 4, 6, 2, 1, 4)
    with pytest.raises(ValueError, match="N_dst == N_src"):
        typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                      torch.from_numpy(np.concatenate([w, w])), 4,
                      extension=Extension.ORIG_WITH_DIFF)
    x, nn, et, w, b = _mk(rng, 2, 8, 4, 8, 2, 1, 4)
    with pytest.raises(ValueError, match="2 C_in"):
        typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                      torch.from_numpy(w), 4,
                      extension=Extension.ORIG_WITH_NEIGHBOR)
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        GatherTable(np.full((8, 2), 8), 8)
    with pytest.raises(TypeError):
        typed_mp_conv(torch.from_numpy(x), torch.from_numpy(nn),
                      torch.from_numpy(et), torch.from_numpy(w), 4)


# --------------------------------------------------------------------------
# the DIFF/NEIGHBOR mode (joint graphs: Nd == N_src)

EXTS = {"diff": (Extension.ORIG_WITH_DIFF, JExtension.ORIG_WITH_DIFF),
        "neighbor": (Extension.ORIG_WITH_NEIGHBOR,
                     JExtension.ORIG_WITH_NEIGHBOR)}
# (B, N = Nd, Cin, K, T, C): the pw table's K=2, the hop table's K=9 at
# T=16, and the last layer's C=2
EXT_SHAPES = [(3, 12, 6, 2, 4, 8), (2, 10, 4, 9, 16, 8), (3, 12, 6, 3, 5, 2)]


def _mk_ext(rng, B, N, Cin, K, T, C):
    x, nn, et, w, b = _mk(rng, B, N, Cin, N, K, T, C)
    w2 = (rng.randn(2 * Cin, C * T) * 0.1).astype(np.float32)
    return x, nn, et, w2, b


# every aggregator at the hop-like shape; the synthetic models'
# aggregators (max, softmax) at the other two
EXT_CASES = ([(EXT_SHAPES[1], agg) for agg in AGGS]
             + [(shape, agg) for shape in (EXT_SHAPES[0], EXT_SHAPES[2])
                for agg in ("max", "softmax")])


@pytest.mark.parametrize("shape,agg", EXT_CASES)
@pytest.mark.parametrize("ext", sorted(EXTS))
def test_ext_conv_and_grads_match_xla_and_pallas(rng, shape, ext, agg):
    """Forward to 2e-5 and dx, d_etype, d_filters, d_bias to 5e-5 against
    the XLA extension conv, and at the hop-like shape (all four
    aggregators) against ``fused_typed_mp(extension=...)`` too (Pallas in
    interpret mode, f32, about 2 s a case on the CPU), as
    tests/test_fused_mp.py holds those two to each other.  The plain kernel
    functions meet Pallas at that shape below."""
    x, nn, et, w, b = _mk_ext(rng, *shape)
    C = shape[-1]
    t_ext, j_ext = EXTS[ext]
    xla = np.asarray(j_conv(*map(jnp.asarray, (x, nn, et, w)), C,
                            extension=j_ext, aggregator=agg,
                            bias=jnp.asarray(b)))
    fused_mp.reset_counts()
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, et, w, b)]
    out = typed_mp_conv(ts[0], nn, ts[1], ts[2], C, extension=t_ext,
                        aggregator=agg, bias=ts[3])
    out.sin().sum().backward()
    assert fused_mp.EXT_COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 1}
    assert fused_mp.EXT_BWD_COUNTS == {"kernel_launches": 0,
                                       "bf16_launches": 0,
                                       "plain_calls": 1}
    assert fused_mp.COUNTS == {"kernel_launches": 0, "bf16_launches": 0,
                               "plain_calls": 0}
    np.testing.assert_allclose(out.detach().numpy(), xla, rtol=2e-5,
                               atol=2e-5)
    got = [t.grad.numpy() for t in ts]
    refs = {"XLA": _jax_grads(lambda x, nn, et, w, b: j_conv(
        x, nn, et, w, C, extension=j_ext, aggregator=agg, bias=b),
        x, nn, et, w, b)}
    if shape == EXT_SHAPES[1]:
        refs["Pallas"] = _jax_grads(
            lambda x, nn, et, w, b: j_fused.fused_typed_mp(
                x, nn, et, w, C, extension=ext, aggregator=agg, bias=b,
                precision="float32"), x, nn, et, w, b)
    for src, ref in refs.items():
        for name, g, q in zip(["dx", "d_etype", "d_filters", "d_bias"], got,
                              ref):
            np.testing.assert_allclose(g, q, rtol=5e-5, atol=5e-5,
                                       err_msg=f"{name} vs {src}")


def _stacked(h):
    """The port's interleaved (B, 2N, T, C) rows as the Pallas kernel's
    stacked [self rows ; neighbour rows]."""
    return np.concatenate([h[:, 0::2], h[:, 1::2]], axis=1)


def _interleaved(h):
    B, N2, T, C = h.shape
    return np.stack([h[:, :N2 // 2], h[:, N2 // 2:]], axis=2).reshape(
        B, N2, T, C)


def _ext_onehot(nn):
    """[onehot(dst) | onehot(src)] over k-major edge rows (fused_mp.py)."""
    Nd, K = nn.shape
    oh = np.zeros((K * Nd, 2 * Nd), np.float32)
    oh[np.arange(K * Nd), np.tile(np.arange(Nd), K)] = 1.0
    oh[np.arange(K * Nd), Nd + nn.T.reshape(-1)] += 1.0
    return oh


def _ext_plain_inputs(rng, B, N, K, T, C):
    h = rng.randn(B, 2 * N, T, C).astype(np.float32)
    nn = rng.randint(0, N, (N, K)).astype(np.int32)
    et = rng.randn(B, N, K, T).astype(np.float32)
    return h, nn, et


def _pallas_ext_fwd(h, nn, et, agg):
    B, N2, T, C = h.shape
    Nd, K = nn.shape
    h5 = jnp.asarray(np.transpose(_stacked(h), (2, 1, 0, 3)).reshape(
        T, N2, B * C))
    et3 = jnp.asarray(np.transpose(et, (3, 0, 2, 1)).reshape(T, B, K * Nd))
    oh = _ext_onehot(nn)
    out, amax = j_fused._fused_fwd_impl(
        h5, et3, jnp.asarray(oh), jnp.asarray(oh.T.copy()), C, agg, 3.0,
        "float32", Nd, K, B, B, "float32")

    def back(a):
        return np.transpose(np.asarray(a, np.float32).reshape(Nd, B, C),
                            (1, 0, 2))

    return back(out), back(amax)


@pytest.mark.parametrize("agg", AGGS)
def test_ext_plain_forward_matches_pallas(rng, agg):
    B, N, K, T, C = 3, 10, 9, 16, 8
    h, nn, et = _ext_plain_inputs(rng, B, N, K, T, C)
    res = fused_mp.typed_gather_mix_agg(
        torch.from_numpy(h), torch.from_numpy(nn), torch.from_numpy(et), agg,
        3.0, want_argmax=agg == "max", ext=True)
    out, am = res if agg == "max" else (res, None)
    ref_out, ref_am = _pallas_ext_fwd(h, nn, et, agg)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    if agg == "max":
        hg = h[:, 0::2, None] + h[:, 1::2][:, nn]
        msgs = np.einsum("bdktc,bdkt->bdkc", hg, et)
        top2 = np.sort(msgs, axis=2)[:, :, -2:]
        clear = (top2[:, :, 1] - top2[:, :, 0]) > 1e-5 * np.abs(top2[:, :, 1])
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(am.numpy()[clear], ref_am[clear])


@pytest.mark.parametrize("agg", AGGS)
def test_ext_plain_backward_matches_pallas_bwd(rng, agg):
    """The plain backward against ``_fused_bwd_impl`` in extension mode
    (the stacked 2N rows, interpret mode, f32), fed the same argmax and
    cotangent."""
    B, N, K, T, C = 3, 10, 9, 16, 8
    h, nn, et = _ext_plain_inputs(rng, B, N, K, T, C)
    g = rng.randn(B, N, C).astype(np.float32)
    res = fused_mp.typed_gather_mix_agg(
        torch.from_numpy(h), torch.from_numpy(nn), torch.from_numpy(et), agg,
        3.0, want_argmax=agg == "max", ext=True)
    out, am = res if agg == "max" else (res, None)
    table = GatherTable(nn, N)
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(nn),
        table.ext_ptr, table.ext_edge, torch.from_numpy(et), agg, 3.0,
        argmax=am, out=out, ext=True)

    def rows(a, dtype=jnp.float32):  # (B, Nd, C) -> (Nd, B * C)
        return jnp.asarray(np.transpose(a, (1, 0, 2)).reshape(N, B * C),
                           dtype)

    h5 = jnp.asarray(np.transpose(_stacked(h), (2, 1, 0, 3)).reshape(
        T, 2 * N, B * C))
    et3 = jnp.asarray(np.transpose(et, (3, 0, 2, 1)).reshape(T, B, K * N))
    oh = _ext_onehot(nn)
    amax = rows(am.numpy() if am is not None else np.zeros_like(g),
                jnp.bfloat16)
    dh5, det3 = j_fused._fused_bwd_impl(
        h5, et3, jnp.asarray(oh), jnp.asarray(oh.T.copy()), amax, C, agg,
        3.0, "float32", N, K, B, B, rows(g))
    ref_dh = _interleaved(np.transpose(
        np.asarray(dh5).reshape(T, 2 * N, B, C), (2, 1, 0, 3)))
    ref_det = np.transpose(np.asarray(det3).reshape(T, B, K, N),
                           (1, 3, 2, 0))
    np.testing.assert_allclose(dh.numpy(), ref_dh, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(det.numpy(), ref_det, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("ext", sorted(EXTS))
def test_ext_max_ties_send_the_cotangent_to_the_first_slot(rng, ext):
    """Every k slot ties exactly: the whole cotangent goes to k=0, as the
    Pallas backward sends it."""
    B, N, Cin, K, T, C = 4, 8, 4, 3, 2, 8
    x = np.ones((B, N, Cin), np.float32)
    nn = np.zeros((N, K), np.int32)
    et = np.ones((B, N, K, T), np.float32)
    w = (rng.randn(2 * Cin, C * T) * 0.1).astype(np.float32)
    b = np.zeros(C, np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, et, w)]
    typed_mp_conv(ts[0], nn, ts[1], ts[2], C, extension=EXTS[ext][0],
                  aggregator="max").sin().sum().backward()
    pallas = _jax_grads(lambda x, nn, et, w, b: j_fused.fused_typed_mp(
        x, nn, et, w, C, extension=ext, aggregator="max",
        precision="float32"), x, nn, et, w, b)
    got = ts[1].grad.numpy()
    assert not got[:, :, 1:].any() and got[:, :, 0].any()
    np.testing.assert_allclose(got, pallas[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["broadcast", "identity"])
def test_ext_conv_never_takes_a_table_shortcut(rng, kind):
    """A table that NO_EXTENSION would take a shortcut for (one source
    row; nn_idx.ravel() == arange(N)) still runs the extension mode, self
    term included, and matches the XLA extension conv."""
    N, K = (1, 2) if kind == "broadcast" else (4, 1)
    x, _, et, w, b = _mk_ext(rng, 3, N, 5, K, 3, 6)
    nn = (np.zeros((N, K), np.int32) if kind == "broadcast"
          else np.arange(N, dtype=np.int32).reshape(N, K))
    assert GatherTable(nn, N).kind == kind
    fused_mp.reset_counts()
    got = typed_mp_conv(torch.from_numpy(x), nn, torch.from_numpy(et),
                        torch.from_numpy(w), 6,
                        extension=Extension.ORIG_WITH_DIFF,
                        aggregator="max", bias=torch.from_numpy(b))
    assert fused_mp.EXT_COUNTS["plain_calls"] == 1
    ref = j_conv(*map(jnp.asarray, (x, nn, et, w)), 6,
                 extension=JExtension.ORIG_WITH_DIFF, aggregator="max",
                 bias=jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_ext_transposed_table_lists_the_rows_edges(rng):
    nn = rng.randint(0, 7, (7, 3))
    table = GatherTable(nn, 7)
    ptr, edge = table.ext_ptr.numpy(), table.ext_edge.numpy()
    assert ptr[0] == 0 and ptr[-1] == 2 * nn.size
    for d in range(7):  # self row 2 d: d's own edges
        np.testing.assert_array_equal(edge[ptr[2 * d]:ptr[2 * d + 1]],
                                      np.arange(3 * d, 3 * d + 3))
    for j in range(7):  # neighbour row 2 j + 1: j's in-edges, in order
        np.testing.assert_array_equal(
            edge[ptr[2 * j + 1]:ptr[2 * j + 2]],
            np.flatnonzero(nn.ravel() == j))
    assert "ext_ptr" not in table.state_dict()
    assert GatherTable(rng.randint(0, 7, (5, 3)), 7).ext_ptr is None


@pytest.mark.parametrize("agg", AGGS)
def test_ext_kernel_predicates_take_what_the_kernels_take(agg):
    """The extension mode's argument checks accept what the kernels take
    (h with 2 rows per node, the 2N-row table)."""
    B, N, K, T, C = 2, 5, 3, 4, 8
    nn = torch.zeros(N, K, dtype=torch.int32)
    table = GatherTable(nn.numpy(), N)
    h = torch.zeros(B, 2 * N, T, C)
    et = torch.zeros(B, N, K, T)
    fused_mp.check_kernel_args(h, nn, et, agg, agg == "max", ext=True)
    fused_mp.check_bwd_args(
        torch.zeros(B, N, C), h, nn, table.ext_ptr, table.ext_edge, et, agg,
        argmax=torch.zeros(B, N, C, dtype=torch.uint8) if agg == "max"
        else None, out=torch.zeros(B, N, C) if agg == "softmax" else None,
        ext=True)


@pytest.mark.parametrize("case", ["nd_ne_n", "rows", "table"])
def test_ext_kernel_predicates_raise(case):
    B, N, K, T, C = 2, 5, 3, 4, 8
    nn = torch.zeros(N, K, dtype=torch.int32)
    table = GatherTable(nn.numpy(), N)
    h, et, g = torch.zeros(B, 2 * N, T, C), torch.zeros(B, N, K, T), \
        torch.zeros(B, N, C)
    ptr, edge = table.ext_ptr, table.ext_edge
    if case == "nd_ne_n":
        nn, et, g = nn[:-1], et[:, :-1], g[:, :-1]
    elif case == "rows":
        h = torch.zeros(B, N, T, C)
    else:
        ptr, edge = table.src_ptr, table.src_edge
    with pytest.raises(ValueError):
        fused_mp.check_bwd_args(g, h, nn, ptr, edge, et, "sum", ext=True)
