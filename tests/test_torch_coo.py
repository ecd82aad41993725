"""The port's COO IR against the JAX package's, on the CPU: the segment
ops and ``typed_mp_conv_coo`` (``ops/segment.py``), ``FactorGraph`` and
``build_joint_coo`` (``graph.py``), and the per-sample form of
``instance_norm``.

The same numpy inputs go through both packages.  Tolerances are the
convs' (tests/test_torch_typed_mp.py): forward 2e-5, gradients 5e-5, each
of the largest reference magnitude; the InstanceNorm 1e-5.  Gradients are
``jax.vjp`` and ``torch.autograd.grad`` against the same random cotangent.
Integer arrays (tables, offsets, edge lists) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu import graph as j_graph
from fgnn_tpu.data.tables import high_factor_table, pw_factor_table
from fgnn_tpu.models.norm import InstanceNorm
from fgnn_tpu.ops import segment as j_seg
from fgnn_tpu_torch import graph as t_graph
from fgnn_tpu_torch.models.norm import instance_norm
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops import segment as t_seg

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
NORM_TOL = 1e-5
EXTENSIONS = ("none", "diff", "neighbor")
AGGS = ("max", "softmax", "mean", "sum")


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


def _vjp_both(j_fn, t_fn, inputs, rng):
    """(JAX output, JAX grads, port output, port grads) of the functions
    of ``inputs`` (numpy arrays) against one random cotangent."""
    j_out, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in inputs])
    cot = rng.randn(*j_out.shape).astype(np.float32)
    j_grads = vjp(jnp.asarray(cot))
    t_in = [torch.tensor(a, requires_grad=True) for a in inputs]
    t_out = t_fn(*t_in)
    t_grads = torch.autograd.grad(t_out, t_in, torch.from_numpy(cot))
    return j_out, j_grads, t_out, t_grads


# --------------------------------------------------------------------------
# segment ops


SEG_OPS = {
    "sum": (j_seg.segment_sum, t_seg.segment_sum),
    "max": (j_seg.segment_max, t_seg.segment_max),
    "mean": (j_seg.segment_mean, t_seg.segment_mean),
    "logsumexp": (lambda d, s, n: j_seg.segment_logsumexp(d, s, n, 3.0),
                  lambda d, s: t_seg.segment_logsumexp(d, s, 3.0)),
}


@pytest.mark.parametrize("op", list(SEG_OPS))
def test_segment_ops_match_jax(rng, op):
    """Unsorted ids, segments of 0 to 5 edges (segment 3 empty)."""
    n = 6
    ids = np.array([0, 2, 1, 0, 4, 2, 5, 0, 2, 4, 0, 1, 0], np.int32)
    data = rng.randn(ids.size, 5).astype(np.float32)
    j_fn, t_fn = SEG_OPS[op]
    seg = t_seg.Segments(ids, n)
    assert seg.width == 5 and seg.padded
    j_out, (j_g,), t_out, (t_g,) = _vjp_both(
        lambda d: j_fn(d, jnp.asarray(ids), n), lambda d: t_fn(d, seg),
        [data], rng)
    if op == "max":  # -inf at the empty segment, in both
        assert np.isneginf(np.asarray(j_out)[3]).all()
        assert torch.isneginf(t_out[3]).all()
        j_out = np.where(np.isinf(j_out), 0.0, j_out)
        t_out = torch.where(torch.isinf(t_out), 0.0, t_out)
    _close(t_out, j_out, FWD_TOL, op)
    _close(t_g, j_g, GRAD_TOL, f"{op} grad")


def test_segment_max_splits_the_gradient_among_ties():
    data = np.array([1.0, 1.0, 0.5, 2.0], np.float32)
    ids = np.array([0, 0, 0, 1])
    _, (j_g,), _, (t_g,) = _vjp_both(
        lambda d: j_seg.segment_max(d, jnp.asarray(ids), 2),
        lambda d: t_seg.segment_max(d, t_seg.Segments(ids, 2)),
        [data], np.random.RandomState(0))
    # the cotangent is random: each tie takes half of its segment's
    np.testing.assert_array_equal(t_g.numpy() != 0, [True, True, False,
                                                     True])
    assert t_g[0] == t_g[1]
    _close(t_g, j_g, GRAD_TOL, "tie grad")


def test_segments_table_and_positions():
    ids = np.array([2, 0, 2, 2, 1, 0])
    seg = t_seg.Segments(ids, 4)
    np.testing.assert_array_equal(seg.table.numpy(),
                                  [[1, 5, 6], [4, 6, 6], [0, 2, 3],
                                   [6, 6, 6]])
    np.testing.assert_array_equal(seg.table.numpy().reshape(-1)[
        seg.pos.numpy()], np.arange(6))
    np.testing.assert_array_equal(seg.count.numpy(), [2, 1, 3, 0])
    with pytest.raises(ValueError, match="must lie in"):
        t_seg.Segments(ids, 2)


# --------------------------------------------------------------------------
# typed_mp_conv_coo


N, E, T, CIN, NOUT = 7, 20, 3, 4, 5
EMPTY, ALL_MASKED = 5, 6


def _conv_case(rng, masked):
    """Edges over 7 nodes: node 5 receives none; with ``masked`` node 6
    receives only masked edges and three more edges are masked."""
    src = rng.randint(0, N, E)
    dst = rng.choice([0, 1, 2, 3, 4, 6], E)
    dst[:6] = [0, 1, 2, 3, 4, 6]
    mask = np.ones(E, bool)
    if masked:
        mask[dst == ALL_MASKED] = False
        mask[[7, 11, 15]] = False
    return src, dst, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("aggregator", AGGS)
@pytest.mark.parametrize("extension", EXTENSIONS)
def test_typed_mp_conv_coo_matches_jax(rng, extension, aggregator, masked):
    src, dst, mask = _conv_case(rng, masked)
    cin = CIN if extension == "none" else 2 * CIN
    x = rng.randn(N, CIN).astype(np.float32)
    etype = rng.randn(E, T).astype(np.float32)
    filters = (rng.randn(cin, NOUT * T) * 0.5).astype(np.float32)
    bias = rng.randn(NOUT).astype(np.float32)
    graph = t_seg.CooGraph(src, dst, mask if masked else None, num_nodes=N)
    assert graph.masked == masked
    kw = dict(aggregator=aggregator, gamma=3.0, extension=extension)

    def j_fn(x, et, w, b):
        return j_seg.typed_mp_conv_coo(
            x, jnp.asarray(src), jnp.asarray(dst), et, w, NOUT, N, bias=b,
            edge_mask=jnp.asarray(mask) if masked else None, **kw)

    def t_fn(x, et, w, b):
        return t_seg.typed_mp_conv_coo(x, graph, et, w, NOUT, bias=b, **kw)

    fused_mp.reset_counts()
    j_out, j_grads, t_out, t_grads = _vjp_both(
        j_fn, t_fn, [x, etype, filters, bias], rng)
    assert all(c["plain_calls"] == c["kernel_launches"] == 0 for c in (
        fused_mp.COUNTS, fused_mp.EXT_COUNTS, fused_mp.BWD_COUNTS,
        fused_mp.EXT_BWD_COUNTS)), "a COO conv runs no typed-mp kernel"
    out = t_out.detach().numpy()
    if aggregator == "softmax":
        # empty: log(1e-30) / 3; all masked: -1e30 + log(count) / 3
        np.testing.assert_allclose(out[EMPTY] - bias, np.log(1e-30) / 3.0,
                                   rtol=1e-6)
        if masked:
            assert (out[ALL_MASKED] <= -1e29).all()
            j_out = np.asarray(j_out)[:ALL_MASKED]
            t_out = t_out[:ALL_MASKED]
    else:  # 0 where no valid edge arrives, then the bias
        np.testing.assert_allclose(out[EMPTY], bias, rtol=1e-6)
        if masked:
            np.testing.assert_allclose(out[ALL_MASKED], bias, rtol=1e-6)
    _close(t_out, j_out, FWD_TOL, "out")
    for name, tg, jg in zip(("x", "etype", "filters", "bias"), t_grads,
                            j_grads):
        _close(tg, jg, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("extension", EXTENSIONS)
def test_conv_max_ties_split_the_gradient(extension):
    """Two edges from one source with one etype into one destination give
    equal messages: each takes half of the cotangent, as in JAX."""
    rng = np.random.RandomState(3)
    src = np.array([1, 1, 2, 0, 2])
    dst = np.array([0, 0, 0, 1, 2])
    etype = np.ones((5, 2), np.float32)
    x = rng.randn(3, 3).astype(np.float32)
    cin = 3 if extension == "none" else 6
    filters = rng.randn(cin, 4 * 2).astype(np.float32)
    graph = t_seg.CooGraph(src, dst, num_nodes=3)

    def j_fn(et):
        return j_seg.typed_mp_conv_coo(
            jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), et,
            jnp.asarray(filters), 4, 3, aggregator="max",
            extension=extension)

    def t_fn(et):
        return t_seg.typed_mp_conv_coo(
            torch.from_numpy(x), graph, et, torch.from_numpy(filters), 4,
            aggregator="max", extension=extension)

    _, (j_g,), _, (t_g,) = _vjp_both(j_fn, t_fn, [etype], rng)
    _close(t_g, j_g, GRAD_TOL, "d_etype")
    np.testing.assert_array_equal(t_g[0].numpy(), t_g[1].numpy())


def test_extensions_need_one_node_set():
    graph = t_seg.CooGraph([0, 1], [0, 0], num_nodes=1, num_src=2)
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="num_src == num_nodes"):
        t_seg.typed_mp_conv_coo(x, graph, torch.ones(2, 1),
                                torch.ones(6, 4), 4, extension="diff")
    with pytest.raises(ValueError, match="rows"):
        t_seg.typed_mp_conv_coo(torch.ones(3, 3), graph, torch.ones(2, 1),
                                torch.ones(3, 4), 4)


# --------------------------------------------------------------------------
# FactorGraph and build_joint_coo


def _fg_arrays(g):
    return [np.asarray(a) for a in (g.var_idx, g.fac_idx, g.slot,
                                    g.edge_mask)] + [g.n_vars, g.n_factors]


def _assert_same_graph(t, j):
    for a, b in zip(_fg_arrays(t), _fg_arrays(j)):
        np.testing.assert_array_equal(a, b)


def test_factor_graph_tables_round_trip(rng):
    factors = rng.randint(0, 10, (6, 3))
    valid = rng.rand(6, 3) > 0.2
    for kw in ({}, {"valid": valid}):
        t = t_graph.FactorGraph.from_factor_table(factors, 10, **kw)
        j = j_graph.FactorGraph.from_factor_table(factors, 10, **kw)
        _assert_same_graph(t, j)
        np.testing.assert_array_equal(t.to_v2f_table(), j.to_v2f_table())
        np.testing.assert_array_equal(t.to_f2v_table(), j.to_f2v_table())
    t = t_graph.FactorGraph.from_factor_table(factors, 10)
    np.testing.assert_array_equal(t.to_v2f_table(), factors)


def test_factor_graph_from_edges_running_slots():
    var = [3, 1, 4, 1, 5, 0]
    fac = [2, 0, 2, 1, 0, 2]
    t = t_graph.FactorGraph.from_edges(var, fac)
    _assert_same_graph(t, j_graph.FactorGraph.from_edges(var, fac))
    np.testing.assert_array_equal(t.slot, [0, 0, 1, 0, 1, 2])


def test_disjoint_union_and_pad_to(rng):
    parts = [(rng.randint(0, n, (f, k)), n)
             for n, f, k in ((5, 3, 2), (7, 4, 3), (4, 2, 2))]
    tg = [t_graph.FactorGraph.from_factor_table(*p) for p in parts]
    jg = [j_graph.FactorGraph.from_factor_table(*p) for p in parts]
    tu = t_graph.FactorGraph.disjoint_union(tg)
    ju = j_graph.FactorGraph.disjoint_union(jg)
    _assert_same_graph(tu, ju)
    assert (tu.n_vars, tu.n_factors, tu.n_edges) == (16, 9, 22)
    _assert_same_graph(tu.pad_to(30), ju.pad_to(30))
    assert tu.pad_to(30).n_edges == 30 and not tu.pad_to(30).edge_mask[
        22:].any()
    with pytest.raises(ValueError, match="cannot pad"):
        tu.pad_to(10)
    tc, jc = tu.to_coo(), ju.to_coo()
    np.testing.assert_array_equal(tc.src.numpy(), np.asarray(jc.src))
    np.testing.assert_array_equal(tc.dst.numpy(), np.asarray(jc.dst))
    assert tc.num_nodes == jc.num_nodes == 25


@pytest.mark.parametrize("kind", ["pw", "high"])
def test_build_joint_coo_matches_jax(kind):
    lengths = [8, 5, 11, 5]
    tabs = [pw_factor_table(L) if kind == "pw" else high_factor_table(L, 5)
            for L in lengths]
    args = ([t for t, _ in tabs], [e for _, e in tabs], lengths)
    t_coo, t_ef, t_meta = t_graph.build_joint_coo(*args)
    j_coo, j_ef, j_meta = j_graph.build_joint_coo(*args)
    for name in ("src", "dst", "seg", "edge_mask"):
        np.testing.assert_array_equal(getattr(t_coo, name).numpy(),
                                      np.asarray(getattr(j_coo, name)),
                                      err_msg=name)
    assert (t_coo.num_nodes, t_coo.num_segments) == (j_coo.num_nodes,
                                                     j_coo.num_segments)
    np.testing.assert_array_equal(t_ef.numpy(), np.asarray(j_ef))
    assert t_ef.dtype == torch.float32
    assert sorted(t_meta) == sorted(j_meta)
    for k in t_meta:
        np.testing.assert_array_equal(t_meta[k], j_meta[k], err_msg=k)
    # every node receives its table's K edges; nodes by sample
    K = tabs[0][0].shape[1]
    np.testing.assert_array_equal(t_coo.by_dst.count.numpy(), K)
    assert not t_coo.masked and t_coo.bins.n == len(lengths) + 1


@pytest.mark.parametrize("direction", ["v2f", "f2v"])
@pytest.mark.parametrize("aggregator", AGGS)
def test_factor_graph_messages_match_jax(rng, direction, aggregator):
    """v2f over n_vars sources into n_factors, f2v back, with masked
    slots: 2e-5 forward, 5e-5 gradients."""
    factors = rng.randint(0, 9, (6, 3))
    valid = rng.rand(6, 3) > 0.25
    t = t_graph.FactorGraph.from_factor_table(factors, 9, valid)
    j = j_graph.FactorGraph.from_factor_table(factors, 9, valid)
    n_in = 9 if direction == "v2f" else 6
    feats = rng.randn(n_in, 4).astype(np.float32)
    etype = rng.randn(t.n_edges, 2).astype(np.float32)
    filters = rng.randn(4, 3 * 2).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    kw = dict(aggregator=aggregator, gamma=3.0)
    j_out, j_grads, t_out, t_grads = _vjp_both(
        lambda f, e, w, b: getattr(j, direction)(f, e, w, 3, bias=b, **kw),
        lambda f, e, w, b: getattr(t, direction)(f, e, w, 3, bias=b, **kw),
        [feats, etype, filters, bias], rng)
    _close(t_out, j_out, FWD_TOL, direction)
    for tg, jg in zip(t_grads, j_grads):
        _close(tg, jg, GRAD_TOL, f"{direction} grad")


# --------------------------------------------------------------------------
# InstanceNorm over a disjoint union


def test_instance_norm_per_sample_matches_jax(rng):
    """Three samples of 4, 6 and 1 nodes, interleaved, and two padding
    nodes (seg -1): statistics per (sample, channel)."""
    seg = np.array([0, 1, 1, 2, 0, -1, 1, 0, 1, 1, 0, -1, 1], np.int32)
    x = (rng.randn(seg.size, 5) * 2 + 1).astype(np.float32)
    mod = InstanceNorm()
    j_out, j_grads, t_out, t_grads = _vjp_both(
        lambda a: mod.apply({}, a, seg=jnp.asarray(seg), num_segments=3),
        lambda a: instance_norm(a, seg=t_seg.segment_bins(seg, 3)),
        [x], rng)
    _close(t_out, j_out, NORM_TOL, "instance_norm")
    _close(t_grads[0], j_grads[0], NORM_TOL, "instance_norm grad")
    # the one-node sample normalises to 0, as the dense form does
    np.testing.assert_array_equal(t_out.detach().numpy()[3], 0.0)


def test_instance_norm_keeps_the_dtype():
    seg = t_seg.segment_bins(np.array([0, 0, 1, 1, 1]), 2)
    x = torch.randn(5, 3).to(torch.bfloat16)
    out = instance_norm(x, seg=seg)
    assert out.dtype == torch.bfloat16
    ref = instance_norm(x.float(), seg=seg)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
