"""The joint-graph LDPC formulation against the JAX package, on the CPU:
``LDPCStructure.joint_features``, ``ContinuousCodesJoint`` and
``sample_to_features`` bit for bit; ``FactorMPNN`` with its options
(``gnn_immediate_dim``, ``max_mpnn_dim``, ``skip_link``) and at its
defaults over the joint [96 variables ; 48 checks] graph of a
``ContinuousCodesJoint`` batch; one joint conv's gradients against the
Pallas kernel in interpret mode.

The joint table (144, 6) names each variable row itself three times
(self padding) with all-zero edge types, so under max the padded slots'
messages are exactly 0 and tie.  The port's argmax is first-win, as the
Pallas kernel's; the XLA path (``jnp.max``, the JAX package's CPU
default) splits a tie's gradient evenly.  Parameter and input gradients
are the same either way (a zero edge type carries no gradient into h or
the filters), so the model is held to XLA through them; d_etype, which
differs at those slots, is held to the Pallas kernel.

The model weights: the flax init's tree (``jax.eval_shape``) filled with
seeded values at a trained model's scale (``test_torch_syn_models.py``).
In training mode the port's f64 run is the pivot: the JAX model's f32
logits and gradients and the port's f32 ones are each held to 1e-4 of it
(relative, and absolute on the scale of each tensor's largest element).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.data import ldpc_datasets as jdata
from fgnn_tpu.data.ldpc_graph import default_structure as j_structure
from fgnn_tpu.models.factor_mpnn import FactorMPNN as JFactorMPNN
from fgnn_tpu.ops import fused_mp as j_fused
from fgnn_tpu_torch.data import ldpc_datasets as tdata
from fgnn_tpu_torch.data.ldpc_graph import default_structure as t_structure
from fgnn_tpu_torch.models import FactorMPNN, load_flax_variables
from fgnn_tpu_torch.models.factor_mpnn import _PointwiseFallback
from fgnn_tpu_torch.models.from_jax import flax_tensors
from fgnn_tpu_torch.models.mp_conv import MPConv, MPConvResidual
from fgnn_tpu_torch.ops import Extension, GatherTable, fused_mp
from fgnn_tpu_torch.ops.typed_mp import typed_mp_conv

TOL = 1e-4
B = 2
DIMS = (8, 8, 16, 16, 8, 2)
CASES = {
    # 8->8 residual (nmed 4), 8->16 pointwise, 16->16 residual, 16->8
    # pointwise, 8->2 softmax conv; skips 16+16 and 8+8
    "options": dict(gnn_immediate_dim=4, max_mpnn_dim=8,
                    skip_link={2: 1, 3: 0}),
    # 8->8 and 16->16 residual (nmed 64), 8->16, 16->8, 8->2 softmax convs
    "defaults": {},
}


def _same(a, b, what):
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_joint_structure_matches_jax():
    j, t = j_structure(), t_structure()
    _same(j.joint_nn_idx, t.joint_nn_idx, "joint_nn_idx")
    _same(j.joint_etype, t.joint_etype, "joint_etype")
    assert t.joint_nn_idx.shape == (144, 6)
    # every variable row names itself in its three padded slots
    np.testing.assert_array_equal(t.joint_nn_idx[:96, 3:],
                                  np.repeat(np.arange(96)[:, None], 3, 1))
    assert not t.joint_etype[:96, 3:].any()
    rng = np.random.RandomState(0)
    for _ in range(3):
        y = rng.randn(96)
        for name, a, b in zip(("nn_idx", "etype", "efeature", "hop"),
                              j.joint_features(y), t.joint_features(y)):
            _same(a, b, name)


def test_continuous_codes_joint_matches_jax():
    jb = list(jdata.ContinuousCodesJoint(length=8, seed=0).batches(4))
    tb = list(tdata.ContinuousCodesJoint(length=8, seed=0).batches(4))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], k)
    assert tb[0]["nn_idx"].shape == (4, 144, 6)


def test_sample_to_features_matches_jax():
    rng = np.random.RandomState(1)
    for snr in (0, 2.0, 4):
        y = rng.randn(96)
        a = jdata.sample_to_features(y, snr)
        b = tdata.sample_to_features(y, snr)
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], k)


def joint_table(batch) -> GatherTable:
    """The shared (144, 6) table of a joint batch, after checking that
    every sample's table is the same (the port takes 2-D tables)."""
    nn_idx = np.asarray(batch["nn_idx"])
    if not (nn_idx == nn_idx[:1]).all():
        raise ValueError("the samples' joint tables differ")
    return GatherTable(nn_idx[0], nn_idx.shape[1])


@lru_cache(maxsize=None)
def _batch():
    return next(tdata.ContinuousCodesJoint(length=B, seed=0).batches(B))


def _seeded(shapes, seed):
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


def _jax_inputs(batch):
    return (jnp.asarray(batch["node_feature"]),
            [jnp.asarray(batch["hop_feature"])],
            [(jnp.asarray(batch["nn_idx"]), jnp.asarray(batch["etype"]))])


@lru_cache(maxsize=None)
def _jax_case(case):
    """The JAX model, its seeded variables, and its value and gradients of
    sum(x * g1) + sum(f * g2) in training mode."""
    opts = CASES[case]
    batch = _batch()
    jm = JFactorMPNN([6], DIMS, [2], **opts)
    node, facs, graphs = _jax_inputs(batch)
    shapes = jax.eval_shape(partial(jm.init, train=True),
                            jax.random.PRNGKey(0), node, facs, graphs)
    var = jax.tree.map(np.asarray, _seeded(shapes, 3))
    rng = np.random.RandomState(4)
    g1 = rng.randn(B, 96, DIMS[-1]).astype(np.float32)
    g2 = rng.randn(B, 48, DIMS[-1]).astype(np.float32)

    def loss(params, node, hop):
        (x, fs), _ = jm.apply({"params": params,
                               "batch_stats": var["batch_stats"]},
                              node, [hop], graphs, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(x * g1) + jnp.sum(fs[0] * g2), (x, fs[0])

    (_, (x, f)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(var["params"], node,
                                                 facs[0])
    return var, g1, g2, np.asarray(x), np.asarray(f), jax.tree.map(
        np.asarray, grads)


def _port_run(case, var, g1, g2, dtype):
    batch = _batch()
    model = FactorMPNN(2, [6], DIMS, [2], **CASES[case])
    load_flax_variables(model, var)
    model.to(dtype).train()
    table = joint_table(batch)
    node = torch.tensor(batch["node_feature"], dtype=dtype,
                        requires_grad=True)
    hop = torch.tensor(batch["hop_feature"], dtype=dtype,
                       requires_grad=True)
    etype = torch.tensor(batch["etype"], dtype=dtype)
    x, fs = model(node, [hop], [table], [etype])
    ((x * torch.from_numpy(g1).to(dtype)).sum()
     + (fs[0] * torch.from_numpy(g2).to(dtype)).sum()).backward()
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    grads["node"], grads["hop"] = node.grad.double().numpy(), \
        hop.grad.double().numpy()
    return model, x.detach().double().numpy(), \
        fs[0].detach().double().numpy(), grads


def _close(got, ref, what):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_mpnn_on_the_joint_graph_matches_flax(case):
    var, g1, g2, jx, jf, jgrads = _jax_case(case)
    fused_mp.reset_counts()
    model, x32, f32, grads32 = _port_run(case, var, g1, g2, torch.float32)
    kinds = [type(getattr(model, f"mp_nn_{i}_0")) for i in range(5)]
    if case == "options":
        assert kinds == [MPConvResidual, _PointwiseFallback, MPConvResidual,
                         _PointwiseFallback, MPConv]
        assert model.mp_nn_0_0.mp_conv.filters.shape == (8, 4 * 2)
    else:
        assert kinds == [MPConvResidual, MPConv, MPConvResidual, MPConv,
                         MPConv]
        assert model.mp_nn_0_0.mp_conv.filters.shape == (128, 64 * 2)
    n_convs = sum(k is not _PointwiseFallback for k in kinds)
    assert fused_mp.EXT_COUNTS["plain_calls"] == n_convs
    assert fused_mp.EXT_BWD_COUNTS["plain_calls"] == n_convs
    assert fused_mp.COUNTS["plain_calls"] == 0
    _, x64, f64, grads64 = _port_run(case, var, g1, g2, torch.float64)
    assert x32.shape == (B, 96, 2) and f32.shape == (B, 48, 2)
    for side, x, f in (("JAX f32", jx, jf), ("port f32", x32, f32)):
        _close(x, x64, f"{side} node logits vs the port's f64")
        _close(f, f64, f"{side} factor features vs the port's f64")
    jgrad = {k: v.numpy() for k, v in flax_tensors(
        model, "params", jgrads[0]).items()}
    jgrad["node"], jgrad["hop"] = jgrads[1], jgrads[2]
    assert jgrad.keys() == grads64.keys()
    for k, ref in grads64.items():
        _close(jgrad[k], ref, f"JAX f32 d{k} vs the port's f64")
        _close(grads32[k], ref, f"port f32 d{k} vs the port's f64")


def test_joint_conv_d_etype_matches_pallas_first_win():
    """One DIFF max conv over the joint table with the batch's side flags
    as edge types: dx, d_etype and d_filters of sum(sin(out)) against
    ``fused_typed_mp`` (Pallas, interpret mode, f32), whose argmax is
    first-win; rtol/atol 5e-5 as ``tests/test_torch_typed_mp.py``."""
    batch = _batch()
    rng = np.random.RandomState(5)
    cin, C = 3, 4
    x = rng.randn(B, 144, cin).astype(np.float32)
    w = (rng.randn(2 * cin, C * 2) * 0.3).astype(np.float32)
    nn_idx = joint_table(batch).idx.numpy()
    et = np.asarray(batch["etype"])
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, et, w)]
    fused_mp.reset_counts()
    out = typed_mp_conv(ts[0], nn_idx, ts[1], ts[2], C,
                        extension=Extension.ORIG_WITH_DIFF,
                        aggregator="max")
    out.sin().sum().backward()
    assert fused_mp.EXT_BWD_COUNTS["plain_calls"] == 1

    def jf(x, et, w):
        return jnp.sum(jnp.sin(j_fused.fused_typed_mp(
            x, jnp.asarray(nn_idx), et, w, C, extension="diff",
            aggregator="max", precision="float32")))

    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (x, et, w)))
    got = [t.grad.numpy() for t in ts]
    for name, g, r in zip(("dx", "d_etype", "d_filters"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=5e-5, atol=5e-5,
                                   err_msg=name)
    # first-win: where the padded slots win, slot 3 takes the cotangent
    assert np.abs(got[1][:, :96, 3]).sum() > 0
    assert not got[1][:, :96, 4:].any()
