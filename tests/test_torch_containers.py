"""The port's ParallelNet, MPEnsemble and GlobalPooling against the JAX
package's containers, on the CPU: parameters from a flax init (running
statistics moved off their init) carried across by ``load_flax_variables``
under the flax attribute names, outputs to 1e-5, in train and eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.models import containers as jc
from fgnn_tpu.models.mp_conv import MPConv as JMPConv
from fgnn_tpu.models.norm import Dense as JDense
from fgnn_tpu.ops.typed_mp import Extension as JExtension
from fgnn_tpu_torch import models as tm

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, K, T, CIN = 3, 10, 3, 2, 5


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, CIN).astype(np.float32)
    nn = rng.randint(0, N, (N, K)).astype(np.int32)
    et = rng.randn(B, N, K, T).astype(np.float32)
    return x, nn, et


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _moved_stats(stats, seed):
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return (rng.randn(*a.shape) * 0.3).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def _jax_conv(nout):
    return JMPConv(nout, T, extension=JExtension.NO_EXTENSION,
                   aggregator="max")


def _port_conv(nin, nout):
    return tm.MPConv(nin, nout, T, aggregator="max")


def _compare(fmod, port, seed=0):
    x, nn, et = _inputs(seed)
    var = _np_tree(fmod.init(jax.random.PRNGKey(seed), x, jnp.asarray(nn),
                             et))
    if "batch_stats" in var:
        var["batch_stats"] = _moved_stats(var["batch_stats"], seed + 1)
    for train in (True, False):
        # a train-mode forward moves the port's running statistics
        tm.load_flax_variables(port, var)
        port.train(train)
        got = port(torch.from_numpy(x), nn, torch.from_numpy(et))
        if train:
            want, _ = fmod.apply(var, x, jnp.asarray(nn), et, train=True,
                                 mutable=["batch_stats"])
        else:
            want = fmod.apply(var, x, jnp.asarray(nn), et, train=False)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL, err_msg=f"train={train}")


@pytest.mark.parametrize("custom", [False, True])
def test_parallel_net_matches_jax(custom):
    agg = (lambda a, b, c: a * b - c) if custom else None
    fmod = jc.ParallelNet(branches=[_jax_conv(4), JDense(4),
                                    jc.IIDBlock(4)], aggregator=agg)
    port = tm.ParallelNet([_port_conv(CIN, 4), tm.Dense(CIN, 4),
                           tm.IIDBlock(CIN, 4)], aggregator=agg)
    _compare(fmod, port)


def test_mp_ensemble_matches_jax():
    fmod = jc.MPEnsemble(model1=_jax_conv(4), model2=JDense(3),
                         model3=JDense(2))
    port = tm.MPEnsemble(_port_conv(CIN, 4), tm.Dense(CIN, 3),
                         tm.Dense(7, 2))
    _compare(fmod, port, seed=2)


@pytest.mark.parametrize("mappers", [True, False])
def test_global_pooling_matches_jax(mappers):
    if mappers:
        fmod = jc.GlobalPooling(orig_mapper=_jax_conv(4),
                                gfeature_mapper=JDense(3))
        port = tm.GlobalPooling(_port_conv(CIN, 4), tm.Dense(CIN, 3))
    else:
        fmod, port = jc.GlobalPooling(), tm.GlobalPooling()
    x, nn, et = _inputs(4)
    if not mappers:  # no parameters: the pooled max concatenated
        got = port(torch.from_numpy(x))
        want = fmod.apply({}, x, jnp.asarray(nn), et)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (B, N, 2 * CIN)
        return
    _compare(fmod, port, seed=4)
