"""The port's halo-exchange conv (``fgnn_tpu_torch.parallel.halo``) and
``MPConv``'s halo branch against the JAX package's ``halo_typed_mp_coo``
and ``MPConv`` on a ``HaloGraph``, on the virtual CPU devices of
tests/conftest.py.

The port's ranks are 4 gloo processes on the CPU, spawned once for the
file (``parallel.launch.run_ranks``; the worker, which imports no JAX, is
``torch_mesh_workers.halo_worker``); each returns its own destination rows
(and its part of the filters' gradient), which the tests join.  The JAX
side runs on a mesh of 4 devices, every case in one jitted program.
Tolerances are tests/test_halo.py's and tests/test_halo_model.py's: the
conv 1e-5 (rtol and atol), its gradients rtol 1e-4 and atol 1e-5; the
layer rtol 1e-4 and atol 1e-5, its running statistics rtol 1e-5 and atol
1e-6.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgnn_tpu.models.mp_conv import MPConv as JMPConv
from fgnn_tpu.ops import Extension as JExtension
from fgnn_tpu.ops.segment import CooGraph as JCooGraph
from fgnn_tpu.parallel import HaloGraph as JHaloGraph
from fgnn_tpu.parallel import build_halo_plan as j_build_halo_plan
from fgnn_tpu.parallel import halo_typed_mp_coo as j_halo
from fgnn_tpu.parallel import make_mesh as j_make_mesh
from fgnn_tpu_torch.models import MPConv
from fgnn_tpu_torch.ops import Extension
from fgnn_tpu_torch.parallel import HaloGraph, build_halo_plan, run_ranks

import torch
import torch_mesh_workers

RANKS = 4
AGGS = ("max", "softmax", "mean", "sum")
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


def _random_graph(rng, n_src=50, n_dst=30, e=400, t=3, cin=8, cout=5):
    src = rng.randint(0, n_src, e).astype(np.int32)
    dst = rng.randint(0, n_dst, e).astype(np.int32)
    dst[:n_dst] = np.arange(n_dst)
    et = rng.randn(e, t).astype(np.float32)
    x = rng.randn(n_src, cin).astype(np.float32)
    w = (0.1 * rng.randn(cin, cout * t)).astype(np.float32)
    return dict(x=x, src=src, dst=dst, et=et, w=w, cout=cout, n_dst=n_dst)


def _chain_graph(rng, n=256, k=3, t=4, cin=8):
    src = np.repeat(np.arange(n), k).astype(np.int32)
    dst = np.clip(src + rng.randint(-4, 5, n * k), 0, n - 1).astype(np.int32)
    et = rng.randn(n * k, t).astype(np.float32)
    x = rng.randn(n, cin).astype(np.float32)
    return dict(x=x, src=src, dst=dst, et=et, n_dst=n)


def _cases():
    rng = np.random.RandomState(0)
    cases = {f"conv_{a}": dict(_random_graph(rng), aggregator=a)
             for a in AGGS}
    g = _random_graph(rng, e=200, cout=4)
    g["dst"] = np.clip(g["dst"], 0, 27).astype(np.int32)  # 28, 29 empty
    cases["bias_empty"] = dict(g, aggregator="max",
                               bias=rng.rand(4).astype(np.float32))
    cases["grad_softmax"] = dict(_random_graph(rng), aggregator="softmax",
                                 grad=True)
    for agg in ("max", "softmax"):
        cases[f"mpconv_{agg}"] = dict(_chain_graph(rng), aggregator=agg,
                                      nout=16)
    return cases


def _jax_conv(c):
    return JMPConv(nout=c["nout"], nedge_types=4, aggregator=c["aggregator"],
                   extension=JExtension.NO_EXTENSION)


def _flax_init(c):
    """The flax init of the layer of an MPConv case (on its COO graph)."""
    coo = JCooGraph(src=jnp.asarray(c["src"]), dst=jnp.asarray(c["dst"]),
                    num_nodes=c["n_dst"])
    return jax.tree.map(np.asarray, _jax_conv(c).init(
        jax.random.PRNGKey(0), jnp.asarray(c["x"]), coo,
        jnp.asarray(c["et"]), train=False))


def _jax_side(cases, plans):
    mesh = j_make_mesh((RANKS, 1), devices=jax.devices()[:RANKS])
    convs = {n: c for n, c in cases.items() if not n.startswith("mpconv")}

    def halo(c, plan, x, w):
        loc, rem = plan.shard_edge_data(c["et"])
        bias = None if c.get("bias") is None else jnp.asarray(c["bias"])
        out = j_halo(plan.pad_src(x), jnp.asarray(loc), jnp.asarray(rem), w,
                     c["cout"], plan, mesh, aggregator=c["aggregator"],
                     bias=bias)
        return out[:c["n_dst"]]

    def all_convs(a):
        return {n: halo(convs[n], plans[n], *a[n]) for n in convs}

    args = {n: (jnp.asarray(c["x"]), jnp.asarray(c["w"]))
            for n, c in convs.items()}
    want = {n: {"out": np.asarray(o)}
            for n, o in jax.jit(all_convs)(args).items()}
    c = cases["grad_softmax"]
    gx, gw = jax.jit(jax.grad(
        lambda x, w: jnp.sum(halo(c, plans["grad_softmax"], x, w) ** 2),
        argnums=(0, 1)))(*args["grad_softmax"])
    want["grad_softmax"].update(gx=np.asarray(gx), gw=np.asarray(gw))

    for name in ("mpconv_max", "mpconv_softmax"):
        c = cases[name]
        graph = JHaloGraph(plan=plans[name], mesh=mesh)
        conv = _jax_conv(c)
        x, et = jnp.asarray(c["x"]), jnp.asarray(c["et"])
        variables = c["variables"]

        @jax.jit
        def apply(v, x, et, conv=conv, graph=graph):
            out, stats = conv.apply(v, x, graph, et, train=True,
                                    mutable=["batch_stats"])
            return out, stats, conv.apply(v, x, graph, et, train=False)

        out, stats, out_eval = apply(variables, x, et)
        want[name] = {True: {"out": np.asarray(out),
                             "mean": np.asarray(stats["batch_stats"]["bn"]
                                                ["mean"]),
                             "var": np.asarray(stats["batch_stats"]["bn"]
                                               ["var"])},
                      False: {"out": np.asarray(out_eval)}}
    return want


@pytest.fixture(scope="module")
def runs():
    """Every case's JAX result and the port's, from one spawn of ranks."""
    cases = _cases()
    plans = {n: build_halo_plan(c["src"], c["dst"], c["x"].shape[0],
                                c["n_dst"], RANKS) for n, c in cases.items()}
    j_plans = {n: j_build_halo_plan(c["src"], c["dst"], c["x"].shape[0],
                                    c["n_dst"], RANKS)
               for n, c in cases.items()}
    for name in ("mpconv_max", "mpconv_softmax"):
        cases[name]["variables"] = _flax_init(cases[name])
    # the ranks run while the JAX side compiles
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, torch_mesh_workers.halo_worker,
                            RANKS, "gloo", "cpu", cases, plans)
        want = _jax_side(cases, j_plans)
        got = ranks.result()
    return cases, plans, want, got


def _rows(got, name, key="out", mode=None):
    parts = [g[name] if mode is None else g[name][mode] for g in got]
    return np.concatenate([p[key] for p in parts])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_matches_jax_field_for_field(n_shards):
    rng = np.random.RandomState(3)
    for g in (_random_graph(rng), _chain_graph(rng, n=64)):
        n_src = g["x"].shape[0]
        got = build_halo_plan(g["src"], g["dst"], n_src, g["n_dst"],
                              n_shards)
        want = j_build_halo_plan(g["src"], g["dst"], n_src, g["n_dst"],
                                 n_shards)
        for field in want.__dataclass_fields__:
            a, b = getattr(got, field), getattr(want, field)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert got.comm_rows_per_device == want.comm_rows_per_device
        x = g["x"]
        np.testing.assert_array_equal(got.pad_src(x),
                                      np.asarray(want.pad_src(x)))
        for a, b in zip(got.shard_edge_data(g["et"]),
                        want.shard_edge_data(g["et"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [f"conv_{a}" for a in AGGS]
                         + ["bias_empty"])
def test_conv_matches_jax(runs, name):
    cases, _, want, got = runs
    out = _rows(got, name)[:cases[name]["n_dst"]]
    np.testing.assert_allclose(out, want[name]["out"], **CONV_TOL)
    if name == "bias_empty":  # empty max segments: 0, then the bias
        np.testing.assert_allclose(out[28:], np.broadcast_to(
            cases[name]["bias"], (2, 4)), **CONV_TOL)


def test_softmax_gradients_match_jax(runs):
    cases, _, want, got = runs
    c = cases["grad_softmax"]
    gx = _rows(got, "grad_softmax", "gx")[:c["x"].shape[0]]
    gw = sum(g["grad_softmax"]["gw"] for g in got)
    np.testing.assert_allclose(gx, want["grad_softmax"]["gx"], **GRAD_TOL)
    np.testing.assert_allclose(gw, want["grad_softmax"]["gw"], **GRAD_TOL)


@pytest.mark.parametrize("agg", ["max", "softmax"])
@pytest.mark.parametrize("train", [False, True])
def test_mpconv_halo_branch_matches_jax(runs, agg, train):
    cases, _, want, got = runs
    name = f"mpconv_{agg}"
    n = cases[name]["n_dst"]
    np.testing.assert_allclose(_rows(got, name, "out", train)[:n],
                               want[name][train]["out"][:n], **LAYER_TOL)
    if train:
        for k in ("mean", "var"):
            for g in got:  # the statistics of every rank's rows
                np.testing.assert_allclose(g[name][True][k],
                                           want[name][True][k], **STATS_TOL)


def test_mpconv_halo_branch_refuses_the_extensions():
    rng = np.random.RandomState(4)
    g = _chain_graph(rng, n=16)
    plan = build_halo_plan(g["src"], g["dst"], 16, 16, 1)
    mesh = SimpleNamespace(dp=1, data_rank=0, data_group=None)
    conv = MPConv(8, 4, 4, extension=Extension.ORIG_WITH_DIFF)
    with pytest.raises(NotImplementedError, match="NO_EXTENSION"):
        conv(torch.from_numpy(g["x"]), HaloGraph(plan, mesh),
             torch.from_numpy(g["et"]))
