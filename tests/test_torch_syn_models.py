"""The port's synthetic MAP models against the JAX package's, on the CPU.

A flax variable tree goes through ``load_flax_variables`` into the port;
both models take the same numpy batch through their trainers' workloads
(``SynWorkload``: the same tables and edge features), and the logits are
compared with ``model.apply`` in training mode (batch statistics, and the
running statistics they leave) and in eval mode (running statistics moved
away from the init's zeros and ones).  Tolerance 1e-4 (rtol and atol): f32
on both sides, sums in other orders through up to 15 layers of BatchNorm.

The tree is the flax init's (``jax.eval_shape`` of ``model.init``, which
compiles nothing), filled with seeded values at the scale of a trained
model: kernels and filters U(+-1/sqrt(fan_in)), BatchNorm scales
U(0.5, 1.5), biases U(+-0.1).  At the flax init itself (filters U(+-0.01))
the pre-BatchNorm activations are nearly constant over the batch, and the
cancellation in x - mean lets f32 rounding alone move the fixed models'
logits by up to 3e-3 from an f64 run; at these weights both f32 paths stay
within 1e-4 of it.  In training mode the port's f64 run is the pivot: the
JAX model's f32 logits and the port's f32 logits are each held to 1e-4 of
it, so each gap is one side's f32 rounding plus any fault of the port.
``test_fixed_model_tree_is_flat_and_strict`` loads the flax init itself.
The small dims (8, 8, 72, 8, 2) reach all three FactorMPNN branches: a
residual conv (8 -> 8), the pointwise branch (8 -> 72, 72 -> 8) and a
softmax conv (8 -> 2).
"""

import copy
from argparse import Namespace
from functools import lru_cache, partial

import jax
import numpy as np
import pytest
import torch

from fgnn_tpu.data import batches as j_batches
from fgnn_tpu.train import synthetic as j_syn
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models.factor_mpnn import _FinalMerge, _PointwiseFallback
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.train import synthetic as t_syn

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_DIMS = (8, 8, 72, 8, 2)
B = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _perturb_stats(stats, seed):
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return (rng.randn(*a.shape) * 0.3).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def _args(model_name, dims, L=12, hop_order=5):
    return Namespace(chain_length=L, hop_cap=3, hop_order=hop_order, seed=1,
                     model_name=model_name, neighbour=8, dims=dims,
                     batch_size=B)


def _seeded_variables(jwl, inputs, seed):
    """The flax init's tree, filled with seeded values (module docstring);
    running statistics at their init, mean 0 and variance 1."""
    shapes = jax.eval_shape(partial(jwl.model.init, train=True),
                            jax.random.PRNGKey(0), **inputs)
    rng = np.random.RandomState(seed)

    def f(path, a):
        key = path[-1].key
        if path[0].key == "batch_stats":
            return (np.zeros if key == "mean" else np.ones)(a.shape,
                                                            np.float32)
        if len(a.shape) >= 2:
            bound = 1.0 / np.sqrt(a.shape[0])
        elif key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            bound = 0.1
        return rng.uniform(-bound, bound, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, dict(shapes))


@lru_cache(maxsize=None)
def _cached_setup(workload, model_name, dims, L=12, hop_order=5, batch=B):
    args = _args(model_name, dims, L, hop_order)
    args.batch_size = batch
    jwl = j_syn.SynWorkload(workload, args)
    data = next(j_batches(jwl.dataset, batch, 1))
    inputs = jwl.model_inputs(data)
    return args, jwl, data, inputs, _seeded_variables(jwl, inputs, 0)


def _setup(workload, model_name, dims, **kw):
    """(args, JAX workload, port workload, numpy batch, JAX inputs, a fresh
    copy of the variables); the JAX side is built once per case."""
    args, jwl, data, inputs, variables = _cached_setup(
        workload, model_name, dims, **kw)
    return (args, jwl, t_syn.SynWorkload(workload, args), data, inputs,
            copy.deepcopy(variables))


CASES = [("hop", "mp_nn_factor", SMALL_DIMS), ("pw", "mp_nn_factor",
                                               SMALL_DIMS),
         ("fixed", "mp_nn", None), ("fixed", "mp_nn_comp", None),
         ("fixed", "simple_gnn", None), ("fixed", "iid", None)]


def _apply(jwl, variables, inputs, train):
    """``model.apply``, jitted: one compile costs less than the op-by-op
    dispatch of an eager apply."""
    if train:
        return jax.jit(partial(jwl.model.apply, train=True,
                               mutable=["batch_stats"]))(variables, **inputs)
    return jax.jit(partial(jwl.model.apply, train=False))(variables,
                                                          **inputs)


def _f64_logits(workload, args, variables, data, train):
    wl = t_syn.SynWorkload(workload, args)
    tm.load_flax_variables(wl.model, variables)
    wl.model.double().train(train)
    wl.static = {k: v.double() for k, v in wl.static.items()}
    staged = {k: v.double() if v.is_floating_point() else v
              for k, v in wl.stage(data, "cpu").items()}
    return wl.logits(staged).detach().numpy()


@pytest.mark.parametrize("workload,model_name,dims", CASES)
@pytest.mark.parametrize("train", [True, False])
def test_model_matches_flax(workload, model_name, dims, train):
    args, jwl, twl, batch, inputs, variables = _setup(workload, model_name,
                                                      dims)
    if not train and "batch_stats" in variables:
        variables["batch_stats"] = _perturb_stats(variables["batch_stats"],
                                                  3)
    tm.load_flax_variables(twl.model, variables)
    twl.model.train(train)
    fused_mp.reset_counts()
    got = twl.logits(twl.stage(batch, "cpu")).detach().numpy()
    assert got.shape == (B, 12, 2)
    if model_name != "iid":  # every conv runs the extension mode
        assert fused_mp.EXT_COUNTS["plain_calls"] > 0
        assert fused_mp.COUNTS["plain_calls"] == 0
    if train:
        ref, upd = _apply(jwl, variables, inputs, True)
        want_sd = tm.load_flax_variables(
            t_syn.SynWorkload(workload, args).model,
            {"params": variables["params"],
             "batch_stats": _np_tree(upd.get("batch_stats", {}))}
        ).state_dict()
        n = 0
        for k, v in twl.model.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           **TOL, err_msg=k)
                n += 1
        assert n > 5 or model_name == "iid"
        # the port's f64 run as the pivot (module docstring)
        pivot = _f64_logits(workload, args, variables, batch, True)
        np.testing.assert_allclose(np.asarray(ref), pivot, **TOL,
                                   err_msg="JAX f32 vs the port's f64")
        np.testing.assert_allclose(got, pivot, **TOL,
                                   err_msg="port f32 vs the port's f64")
    else:
        ref = _apply(jwl, variables, inputs, False)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_hop_model_at_the_reference_dims():
    """The reference SynHopFactorModel (FMPNN_DIMS, hop_order 9, chain 30),
    one eval forward, B=2."""
    _, jwl, twl, batch, inputs, variables = _setup(
        "hop", "mp_nn_factor", None, L=30, hop_order=9, batch=2)
    variables["batch_stats"] = _perturb_stats(variables["batch_stats"], 4)
    tm.load_flax_variables(twl.model, variables)
    assert sum(p.numel() for p in twl.model.parameters()) == 2148654
    kinds = [type(getattr(twl.model.fmpnn, f"mp_nn_{i}_0")).__name__
             for i in range(10)]
    assert kinds == ["MPConvResidual", "_PointwiseFallback"] * 4 + [
        "MPConvResidual", "MPConv"]
    assert isinstance(twl.model.fmpnn.merge_9, _FinalMerge)
    twl.model.eval()
    with torch.inference_mode():
        got = twl.logits(twl.stage(batch, "cpu"))
    ref = _apply(jwl, variables, inputs, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_small_dims_reach_every_branch():
    model = tm.SynHopFactorModel(hop_order=5, dims=SMALL_DIMS)
    kinds = [type(getattr(model.fmpnn, f"mp_nn_{i}_1")) for i in range(4)]
    assert kinds == [tm.MPConvResidual, _PointwiseFallback,
                     _PointwiseFallback, tm.MPConv]
    assert model.fmpnn.mp_nn_0_1.mp_conv.filters.shape == (128, 1024)
    assert model.fmpnn.mp_nn_3_1.filters.shape == (16, 32)


def test_fixed_model_tree_is_flat_and_strict():
    """The flax init itself goes through the carry-across: SynFixedModel's
    layers sit beside ``emodel`` (the flax names), the eval logits match,
    and the carry-across refuses a tree that lacks a layer."""
    args, jwl, twl, batch, inputs, _ = _setup("fixed", "mp_nn", None)
    variables = _np_tree(jax.jit(partial(jwl.model.init, train=True))(
        jax.random.PRNGKey(0), **inputs))
    assert sorted(variables["params"]) == sorted(
        {k.split(".")[0] for k in twl.model.state_dict()})
    tm.load_flax_variables(twl.model, variables)
    twl.model.eval()
    with torch.inference_mode():
        got = twl.logits(twl.stage(batch, "cpu"))
    ref = _apply(jwl, variables, inputs, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    del variables["params"]["IIDBlock_3"]
    with pytest.raises(KeyError, match="unfilled"):
        tm.load_flax_variables(twl.model, variables)


def test_unknown_fixed_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        tm.SynFixedModel("mlp")
