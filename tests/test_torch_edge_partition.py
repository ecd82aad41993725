"""The port's edge-partitioned conv (``fgnn_tpu_torch.parallel.
edge_partition``) against the JAX package's ``partitioned_typed_mp_coo``
on the virtual CPU devices of tests/conftest.py.

The port's ranks are 2 gloo processes on the CPU, spawned once for the
file (``parallel.launch.run_ranks``; the worker, which imports no JAX, is
``torch_mesh_workers.edge_worker``); the JAX side runs on a mesh of 2
devices, the same padded edge list in the same 2 blocks.  Tolerances are
tests/test_edge_partition.py's: forward rtol and atol 1e-4 (cross-shard
logsumexp); gradients, which the JAX package has for sum and mean only,
rtol 1e-4 and atol 1e-5 as its other gradient parity tests.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fgnn_tpu.parallel import make_mesh as j_make_mesh
from fgnn_tpu.parallel import pad_edges as j_pad_edges
from fgnn_tpu.parallel import partitioned_typed_mp_coo as j_partitioned
from fgnn_tpu_torch.parallel import pad_edges, run_ranks

import torch_mesh_workers

RANKS = 2
AGGS = ("max", "sum", "mean", "softmax")
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _graph(rng, Ns=20, Nd=9, E=53, Cin=6, Cout=5, T=3, dst=None):
    x = rng.randn(Ns, Cin).astype(np.float32)
    src = rng.randint(0, Ns, E).astype(np.int32)
    d = (rng.randint(0, Nd, E) if dst is None else dst).astype(np.int32)
    etype = rng.randn(E, T).astype(np.float32)
    w = rng.randn(Cin, Cout * T).astype(np.float32)
    srcp, dstp, etp, mask = j_pad_edges(src, d, etype, RANKS)
    return dict(x=x, src=srcp, dst=dstp, etype=etp, mask=mask, w=w,
                cout=Cout, nd=Nd)


@pytest.fixture(scope="module")
def runs():
    """Every case's JAX result and the port's, from one spawn of ranks."""
    rng = np.random.RandomState(0)
    cases = {}
    for agg in AGGS:
        cases[agg] = dict(_graph(rng), aggregator=agg, grad=True)
    # every edge into segment 2: the others are empty (max gives 0)
    cases["empty"] = dict(_graph(rng, Ns=10, Nd=8, E=16, Cin=4, Cout=3,
                                 T=2, dst=np.full(16, 2)), aggregator="max")
    # the ranks run while the JAX side compiles (one program for every
    # forward, one for the gradients)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, torch_mesh_workers.edge_worker, RANKS,
                            "gloo", "cpu", cases)
        mesh = j_make_mesh((RANKS, 1), devices=jax.devices()[:RANKS])

        def conv(c, x, w, et):
            return j_partitioned(
                x, jnp.asarray(c["src"]), jnp.asarray(c["dst"]), et,
                jnp.asarray(c["mask"]), w, c["cout"], c["nd"], mesh,
                aggregator=c["aggregator"])

        args = {n: (c["x"], c["w"], c["etype"]) for n, c in cases.items()}
        outs = jax.jit(lambda a: {n: conv(cases[n], *v)
                                  for n, v in a.items()})(args)
        want = {n: {"out": np.asarray(o)} for n, o in outs.items()}
        diff = ("sum", "mean")
        grads = jax.jit(lambda a: {n: jax.grad(
            lambda x, w, et, n=n: jnp.sum(conv(cases[n], x, w, et) ** 2),
            argnums=(0, 1, 2))(*a[n]) for n in diff})(args)
        for n in diff:
            want[n]["grads"] = [np.asarray(g) for g in grads[n]]
        got = ranks.result()
    return cases, want, got


def test_pad_edges_matches_jax():
    rng = np.random.RandomState(1)
    src, dst = rng.randint(0, 9, 13), rng.randint(0, 5, 13)
    et = rng.randn(13, 3).astype(np.float32)
    for n in (1, 2, 4, 8):
        for a, b in zip(pad_edges(src, dst, et, n),
                        j_pad_edges(src, dst, et, n)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", AGGS + ("empty",))
def test_forward_matches_jax(runs, name):
    cases, want, got = runs
    for rank in range(RANKS):  # the output is replicated
        np.testing.assert_allclose(got[rank][name]["out"], want[name]["out"],
                                   **FWD_TOL)
    if name == "empty":
        out = got[0][name]["out"]
        assert (np.delete(out, 2, axis=0) == 0).all()


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_gradients_match_jax(runs, agg):
    _, want, got = runs
    for rank in range(RANKS):  # every rank holds the full gradients
        for g, w in zip(got[rank][agg]["grads"], want[agg]["grads"]):
            np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("agg", ["max", "softmax"])
def test_max_and_softmax_refuse_the_backward(runs, agg):
    """As JAX: no differentiation rule for pmax."""
    _, _, got = runs
    for rank in range(RANKS):
        assert "grads" not in got[rank][agg]
        assert "no backward" in got[rank][agg]["raised"]
