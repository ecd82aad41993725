"""The remainder of the port against the JAX package, on the CPU:
``gather_nodes``, the KNN helpers, ``MaxPoolNodes``/``Flatten``/
``Identity``, the ``InstanceNorm`` module, ``MPConv``'s options
(``use_bias``, ``use_bn``, ``activation``, ``gamma``) on its dense and COO
branches, ``GConvResidual``, and ``MPSequential``'s dispatch of a
``takes_graph`` child.  Parameters go from the flax init into the port
through ``load_flax_variables`` (strict), filters and kernels refilled at
a trained model's scale, running statistics moved off their init.

The halo branch of an ``MPConv`` without BatchNorm runs in
``tests/test_torch_entry.py`` (the dry run's halo conv, against
``typed_mp_conv_coo`` on one rank)."""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from fgnn_tpu.models import base as jbase
from fgnn_tpu.models import containers as jc
from fgnn_tpu.models import knn as jknn
from fgnn_tpu.models.mp_conv import GConvResidual as JGConvResidual
from fgnn_tpu.models.mp_conv import MPConv as JMPConv
from fgnn_tpu.models.norm import InstanceNorm as JInstanceNorm
from fgnn_tpu.ops import Extension as JExtension
from fgnn_tpu.ops import gather_nodes as j_gather_nodes
from fgnn_tpu.ops.segment import CooGraph as JCooGraph
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.ops import Extension, fused_mp, gather_nodes
from fgnn_tpu_torch.ops.segment import CooGraph, segment_bins

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, K, T, CIN = 3, 10, 3, 2, 5


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _trained_scale(var, seed):
    """Filters and kernels U(+-1/sqrt(fan_in)) and biases U(+-0.1);
    running statistics moved off their init."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        key = path[-1].key
        if path[0].key == "batch_stats":
            if key == "mean":
                return (rng.randn(*a.shape) * 0.3).astype(np.float32)
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim >= 2:
            bound = 1.0 / np.sqrt(a.shape[0])
        elif key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            bound = 0.1
        return rng.uniform(-bound, bound, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, _np_tree(var))


def _inputs(seed, n=N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n, CIN).astype(np.float32)
    nn_idx = rng.randint(0, n, (n, K)).astype(np.int32)
    et = rng.randn(B, n, K, T).astype(np.float32)
    return x, nn_idx, et


def _compare(fmod, port, args_j, args_t, seed, tol=TOL):
    """The flax module and the port module on the same (refilled)
    variables, in train and eval mode."""
    var = _trained_scale(fmod.init(jax.random.PRNGKey(seed), *args_j,
                                   train=False), seed + 1)
    for train in (True, False):
        tm.load_flax_variables(port, var)
        port.train(train)
        got = port(*args_t)
        if train and "batch_stats" in var:
            want, _ = fmod.apply(var, *args_j, train=True,
                                 mutable=["batch_stats"])
        else:
            want = fmod.apply(var, *args_j, train=train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol, err_msg=f"train={train}")
    return var


# ---------------------------------------------------------------- gather


@pytest.mark.parametrize("per_sample", [False, True])
def test_gather_nodes_matches_jax(per_sample):
    rng = np.random.RandomState(1)
    x = rng.randn(B, 7, 4).astype(np.float32)
    shape = (B, 5, 3) if per_sample else (5, 3)
    idx = rng.randint(0, 7, shape).astype(np.int32)
    want = np.asarray(j_gather_nodes(jnp.asarray(x), jnp.asarray(idx)))
    for table in (idx, torch.from_numpy(idx)):
        got = gather_nodes(torch.from_numpy(x), table)
        assert got.shape == (B, 5, 3, 4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_nodes_refuses_bad_tables():
    x = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="rank 2 or 3"):
        gather_nodes(x, np.zeros(5, np.int32))
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        gather_nodes(x, np.array([[0, 4]]))
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        gather_nodes(x, np.array([[[0, -1]]] * 2))


# ------------------------------------------------------------------- knn


def test_pairwise_distance_and_knn_match_jax():
    x = np.random.RandomState(2).randn(2, 9, 3).astype(np.float32)
    got = tm.pairwise_distance(torch.from_numpy(x)).numpy()
    want = np.asarray(jknn.pairwise_distance(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in (1, 4, 9):
        g = tm.knn_graph(torch.from_numpy(x), k)
        assert g.dtype == torch.int32 and g.shape == (2, 9, k)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jknn.knn_graph(jnp.asarray(x), k)))


def test_knn_ties_take_the_lower_index_first():
    """Integer points with duplicates: the distances are exact, so ties
    are exact, and both packages order them by index."""
    rng = np.random.RandomState(3)
    pts = rng.randint(-2, 3, (2, 6, 2)).astype(np.float32)
    x = np.concatenate([pts, pts[:, :4], pts[:, 1:3]], axis=1)  # 12 points
    d = np.asarray(jknn.pairwise_distance(jnp.asarray(x)))
    assert (np.sort(d, axis=-1)[..., 1:] == np.sort(d, axis=-1)[..., :-1]
            ).any(), "the case must hold ties"
    for k in (2, 5, 12):
        got = tm.knn_graph(torch.from_numpy(x), k).numpy()
        want = np.asarray(jknn.knn_graph(jnp.asarray(x), k))
        np.testing.assert_array_equal(got, want)
    full = tm.knn_graph(torch.from_numpy(x), 12).numpy()
    for b in range(2):
        for i in range(12):
            row = d[b, i, full[b, i]]
            same = row[1:] == row[:-1]
            assert (full[b, i, 1:][same] > full[b, i, :-1][same]).all()


def test_edge_features_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 3).astype(np.float32)
    idx = np.array(jknn.knn_graph(jnp.asarray(x), 3))
    for jf, tf in ((jknn.get_nn_node_feature, tm.get_nn_node_feature),
                   (jknn.get_edge_feature, tm.get_edge_feature)):
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(idx)))
        got = tf(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- small modules


@pytest.mark.parametrize("axis", [-2, 1, -1])
def test_small_modules_are_exact(axis):
    x = np.random.RandomState(5).randn(3, 4, 5).astype(np.float32)
    xt = torch.from_numpy(x)
    for jm, tmod in ((jbase.MaxPoolNodes(axis=axis), tm.MaxPoolNodes(axis)),
                     (jbase.Flatten(), tm.Flatten()),
                     (jbase.Identity(), tm.Identity())):
        want = np.asarray(jm.apply({}, jnp.asarray(x)))
        got = tmod(xt).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tm.MessagePassing().is_mp()


def test_instance_norm_module_matches_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 7, 4) * 2 + 1).astype(np.float32)
    mod = tm.InstanceNorm()
    assert not list(mod.parameters())
    np.testing.assert_allclose(
        mod(torch.from_numpy(x)).numpy(),
        np.asarray(JInstanceNorm().apply({}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    seg = np.array([0, 1, 1, 2, 0, -1, 1, 0, 1, 1, 0, -1, 1], np.int32)
    xf = (rng.randn(seg.size, 5) * 2 + 1).astype(np.float32)
    want = JInstanceNorm().apply({}, jnp.asarray(xf), seg=jnp.asarray(seg),
                                 num_segments=3)
    got = mod(torch.from_numpy(xf), segment_bins(seg, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------- MPConv options

OPTIONS = [dict(use_bias=False, use_bn=False, activation=None),
           dict(use_bias=True, use_bn=False, activation="relu"),
           dict(use_bias=False, use_bn=True, activation=None)]


@pytest.mark.parametrize("opts", OPTIONS, ids=["bare", "no_bn", "no_bias"])
@pytest.mark.parametrize("ext", ["NO_EXTENSION", "ORIG_WITH_DIFF"])
def test_mpconv_options_dense_match_flax(opts, ext):
    x, nn_idx, et = _inputs(7)
    fmod = JMPConv(4, T, extension=JExtension[ext], aggregator="softmax",
                   gamma=1.5, **opts)
    port = tm.MPConv(CIN, 4, T, extension=Extension[ext],
                     aggregator="softmax", gamma=1.5, **opts)
    assert (port.bias is None) != opts["use_bias"]
    assert (port.bn is None) != opts["use_bn"]
    fused_mp.reset_counts()
    var = _compare(fmod, port, (x, jnp.asarray(nn_idx), et),
                   (torch.from_numpy(x), nn_idx, torch.from_numpy(et)), 8)
    assert ("bias" in var["params"]) == opts["use_bias"]
    counts = fused_mp.EXT_COUNTS if ext != "NO_EXTENSION" else \
        fused_mp.COUNTS
    assert counts["plain_calls"] == 2


@pytest.mark.parametrize("opts", OPTIONS, ids=["bare", "no_bn", "no_bias"])
def test_mpconv_options_coo_match_flax(opts):
    rng = np.random.RandomState(9)
    n, e = 12, 30
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    x = rng.randn(n, CIN).astype(np.float32)
    et = rng.randn(e, T).astype(np.float32)
    jg = JCooGraph(src=jnp.asarray(src), dst=jnp.asarray(dst), num_nodes=n)
    fmod = JMPConv(4, T, extension=JExtension.NO_EXTENSION,
                   aggregator="softmax", gamma=1.5, **opts)
    port = tm.MPConv(CIN, 4, T, aggregator="softmax", gamma=1.5, **opts)
    _compare(fmod, port, (x, jg, et),
             (torch.from_numpy(x), CooGraph(src, dst, num_nodes=n),
              torch.from_numpy(et)), 10)


def test_mpconv_refuses_an_unknown_activation():
    with pytest.raises(ValueError, match="activation"):
        tm.MPConv(3, 4, 2, activation="gelu")


def test_gconv_residual_matches_flax():
    x, nn_idx, et = _inputs(11)
    fmod = JGConvResidual(6, T)
    port = tm.GConvResidual(CIN, 6, T)
    assert port.mp_conv.extension == Extension.ORIG_WITH_DIFF
    assert port.mp_conv.aggregator == "softmax"
    fused_mp.reset_counts()
    _compare(fmod, port, (x, jnp.asarray(nn_idx), et),
             (torch.from_numpy(x), nn_idx, torch.from_numpy(et)), 12)
    assert fused_mp.EXT_COUNTS["plain_calls"] == 2
    bare = tm.GConvResidual(CIN, 6, T, with_residual=False)
    bare.load_state_dict(port.state_dict())
    bare.eval()
    port.eval()
    args = (torch.from_numpy(x), nn_idx, torch.from_numpy(et))
    torch.testing.assert_close(port(*args) - bare(*args), args[0])


# ----------------------------------------------- MPSequential's dispatch


class _JTakesGraph(nn.Module):
    """Adds each node's etype-weighted mean of its neighbours."""

    takes_graph = True

    @nn.compact
    def __call__(self, x, nn_idx, etype, train: bool = True):
        w = etype.sum(-1)[..., None]
        return x + (j_gather_nodes(x, nn_idx) * w).mean(axis=2)


class _TTakesGraph(torch.nn.Module):
    takes_graph = True

    def forward(self, x, table, etype):
        w = etype.sum(-1)[..., None]
        return x + (gather_nodes(x, table) * w).mean(dim=2)


def test_mpsequential_gives_a_takes_graph_child_the_graph():
    x, nn_idx, et = _inputs(13)
    fmod = jc.MPSequential(layers=[_JTakesGraph(), jbase.Identity(),
                                   _JTakesGraph(), jbase.MaxPoolNodes()])
    want = fmod.apply({}, x, jnp.asarray(nn_idx), et)
    port = tm.MPSequential([_TTakesGraph(), tm.Identity(), _TTakesGraph(),
                            tm.MaxPoolNodes()])
    got = port(torch.from_numpy(x), nn_idx, torch.from_numpy(et))
    assert got.shape == (B, 1, CIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _JPair(nn.Module):
    @nn.compact
    def __call__(self, x):
        return 2.0 * x, x.sum(axis=-1)


class _TPair(torch.nn.Module):
    def forward(self, x):
        return 2.0 * x, x.sum(dim=-1)


def test_mpsequential_collects_tuple_outputs_as_jax():
    x, nn_idx, et = _inputs(14)
    want_x, want_extra = jc.MPSequential(
        layers=[_JPair(), _JTakesGraph(), _JPair()]).apply(
            {}, x, jnp.asarray(nn_idx), et)
    got_x, got_extra = tm.MPSequential(
        [_TPair(), _TTakesGraph(), _TPair()])(
            torch.from_numpy(x), nn_idx, torch.from_numpy(et))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    assert len(got_extra) == len(want_extra) == 2
    for g, w in zip(got_extra, want_extra):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_gconv_residual_takes_x_alone_in_both_containers():
    """The JAX ``_is_mp`` does not list GConvResidual; neither does the
    port's, so a container calls it with x alone there as here."""
    from fgnn_tpu.models.containers import _is_mp as j_is_mp
    from fgnn_tpu_torch.models.containers import _is_mp as t_is_mp

    assert not j_is_mp(JGConvResidual(4, T))
    assert not t_is_mp(tm.GConvResidual(CIN, 4, T))
    assert t_is_mp(tm.MPConv(CIN, 4, T)) and t_is_mp(_TTakesGraph())
    assert t_is_mp(tm.MessagePassing())


# ------------------------------------------- the syn_* CLIs' main(argv)


@pytest.mark.parametrize("module,workload", [
    ("syn_hop_factor", "hop"), ("syn_pw_factor", "pw"),
    ("syn_fixed_pw_hop", "fixed")])
def test_syn_cli_modules_export_main(monkeypatch, module, workload):
    """Each CLI module's ``main(argv=None)``, as the JAX module's, returns
    what ``train_and_eval`` returns for its workload."""
    import importlib
    import inspect

    from fgnn_tpu_torch.train import synthetic

    port = importlib.import_module(f"fgnn_tpu_torch.train.{module}")
    jax_mod = importlib.import_module(f"fgnn_tpu.train.{module}")
    assert str(inspect.signature(port.main)) == str(
        inspect.signature(jax_mod.main)) == "(argv=None)"
    seen = []

    def fake(wl, args, **kw):
        seen.append((wl, args))
        return 0.5, 0.25

    monkeypatch.setattr(synthetic, "train_and_eval", fake)
    assert port.main(["--batch-size", "3"]) == (0.5, 0.25)
    assert seen[0][0] == workload and seen[0][1].batch_size == 3
