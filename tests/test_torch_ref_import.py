"""Reference PyTorch state dicts in the port (``models/torch_import.py``),
on the CPU.

The reference checkout is not needed: the test writes a reference-format
``state_dict`` itself, by inverting the importers' key map on a seeded flax
tree (``_reference_sd``), and first checks that the JAX package's
``import_ldpc_model`` / ``import_factor_nn`` map that dict back to the tree
exactly, which makes it the reference format as the JAX package reads it.
Then the port's ``load_reference_state_dict`` and the JAX model, on that
tree, give the same logits (1e-4), for ``LDPCModel`` (8 layers, as the
reference's; widths cut) and for a bare ``FactorNN``.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.models.torch_import import import_factor_nn as j_import_fnn
from fgnn_tpu.models.torch_import import import_ldpc_model as j_import_ldpc
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.ops.typed_mp import GatherTable
from fgnn_tpu_torch.train import ldpc as t_ldpc

# 8 layers, as import_ldpc_model reads; the widths change (MPConv) and
# stay (MPConvResidual), so both branches of the layer rule are here
DIMS = (8, 16, 16, 8, 8, 16, 16, 8, 8)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and torch's thread pools in each would contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(shapes, seed):
    """A flax tree of ``shapes`` filled from a seed: BatchNorm scales and
    variances in [0.5, 1.5], everything else N(0, 0.3^2)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.3 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---- the inverse of the importers' key map


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["kernel"].T[:, :, None, None]
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(p["kernel"].T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]
    sd[f"{prefix}.running_mean"] = s["mean"]
    sd[f"{prefix}.running_var"] = s["var"]


def _mp(sd, prefix, p, s):
    if "filters" in p:                   # mp_conv_v2
        sd[f"{prefix}.filters"] = p["filters"]
        if "bias" in p:
            sd[f"{prefix}.bias"] = p["bias"]
        if "bn" in p:
            _bn(sd, f"{prefix}.bn", p["bn"], s["bn"])
    elif "mp_conv" in p:                 # mp_conv_residual
        _conv(sd, f"{prefix}.conv1.0", p["conv1"])
        _bn(sd, f"{prefix}.conv1.1", p["bn1"], s["bn1"])
        _mp(sd, f"{prefix}.mp_conv", p["mp_conv"], s.get("mp_conv", {}))
        _conv(sd, f"{prefix}.conv2.0", p["conv2"])
        _bn(sd, f"{prefix}.conv2.1", p["bn2"], s["bn2"])
    else:                                # pointwise
        _conv(sd, f"{prefix}.0", p["conv"])


def _factor_nn_sd(sd, pre, params, stats, n_types, n_layers):
    _conv(sd, f"{pre}node_mapping_module.main.0",
          params["node_mapping"]["conv"])
    for j in range(n_types):
        fm, fs = params[f"factor_mapping_{j}"], stats[f"factor_mapping_{j}"]
        _conv(sd, f"{pre}factor_mapping_modules_{j}.main.0", fm["conv"])
        _bn(sd, f"{pre}factor_mapping_modules_{j}.main.1", fm["bn"],
            fs["bn"])
    for i in range(n_layers):
        _conv(sd, f"{pre}v2v_{i}.main.0", params[f"v2v_{i}"]["conv"])
        for j in range(n_types):
            _conv(sd, f"{pre}f2f_{i}_{j}.main.0",
                  params[f"f2f_{i}_{j}"]["conv"])
            for side in ("f2v", "v2f"):
                name = f"{side}_{i}_{j}"
                _mp(sd, f"{pre}{name}", params[name], stats.get(name, {}))
    _conv(sd, f"{pre}final_classifier.0", params["final_conv1"])
    _conv(sd, f"{pre}final_classifier.3", params["final_conv2"])


def _reference_sd(params, stats, n_types=2, n_layers=8, ldpc=True):
    """A reference ``state_dict`` (numpy) of a flax tree."""
    sd = {}
    if not ldpc:
        _factor_nn_sd(sd, "", params, stats, n_types, n_layers)
        return sd
    _factor_nn_sd(sd, "main.", params["main"], stats["main"], n_types,
                  n_layers)
    for e in ("emodel_f2v", "emodel_v2f"):
        _conv(sd, f"{e}.0", params[e]["dense_0"])
        _conv(sd, f"{e}.2", params[e]["dense_1"])
    reg, reg_s = params["nhop_regressor"], stats["nhop_regressor"]
    _linear(sd, "nhop_regressor.0", reg["fc1"])
    _bn(sd, "nhop_regressor.1", reg["bn"], reg_s["bn"])
    _linear(sd, "nhop_regressor.3", reg["fc2"])
    _linear(sd, "nhop_regressor.5", reg["fc3"])
    return sd


def _same_tree(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- LDPCModel


@pytest.fixture(scope="module")
def ldpc():
    batch = next(ContinuousCodesSP(length=3, seed=5).batches(3))
    model = jm.LDPCModel(dim_mapping_list=DIMS, skip_link={})
    inputs = j_ldpc._model_inputs(batch)
    shapes = jax.eval_shape(partial(model.init, train=True),
                            jax.random.PRNGKey(0), **inputs)
    var = _seeded(shapes, 1)
    logits, _ = jax.jit(lambda v: model.apply(v, **inputs, train=False))(
        var)
    return batch, var, np.asarray(logits)


def test_reference_state_dict_is_the_jax_importers_format(ldpc):
    _, var, _ = ldpc
    sd = _reference_sd(var["params"], var["batch_stats"])
    assert len(sd) > 300
    for importer in (j_import_ldpc, tm.import_ldpc_model):
        params, stats = importer(sd)
        _same_tree(params, var["params"])
        _same_tree(stats, var["batch_stats"])


def test_ldpc_model_logits_match_jax(ldpc):
    batch, var, want = ldpc
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _reference_sd(
        var["params"], var["batch_stats"]).items()}
    port = tm.load_reference_state_dict(
        tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}), sd).eval()
    assert port.main.n_layers == 8
    got = t_ldpc.decode_logits(port, batch, "cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_reference_state_dict_missing_a_tensor_is_refused(ldpc):
    _, var, _ = ldpc
    sd = _reference_sd(var["params"], var["batch_stats"])
    del sd["main.v2f_3_1.conv1.1.running_var"]
    with pytest.raises(KeyError, match="v2f_3_1.conv1.1.running_var"):
        tm.load_reference_state_dict(
            tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}), sd)


# ---- a bare FactorNN


def test_factor_nn_logits_match_jax():
    rng = np.random.RandomState(3)
    B, NV, NF, NG, hop, T = 2, 10, 5, 2, 4, 3
    dims = (8, 16, 8)
    tables_f2v = [rng.randint(0, NF, (NV, 2)).astype(np.int32),
                  rng.randint(0, NG, (NV, 1)).astype(np.int32)]
    tables_v2f = [rng.randint(0, NV, (NF, 3)).astype(np.int32),
                  np.tile(np.arange(NV, dtype=np.int32), (NG, 1))]
    node = rng.randn(B, NV, 2).astype(np.float32)
    facs = [rng.randn(B, NF, hop).astype(np.float32),
            rng.randn(B, NG, NV).astype(np.float32)]
    et_f2v = [rng.randn(B, NV, 2, T).astype(np.float32),
              np.ones((B, NV, 1, 1), np.float32)]
    et_v2f = [rng.randn(B, NF, 3, T).astype(np.float32),
              np.ones((B, NG, NV, 1), np.float32)]
    model = jm.FactorNN(factor_feature_dims=(hop, NV), dim_mapping_list=dims,
                        netype_list=(T, 1), ret_high=True)
    args = (node, facs, tables_f2v, tables_v2f, et_f2v, et_v2f)
    shapes = jax.eval_shape(partial(model.init, train=True),
                            jax.random.PRNGKey(0), *args)
    var = _seeded(shapes, 4)
    want, _ = jax.jit(lambda v: model.apply(v, *args, train=False))(var)

    sd = _reference_sd(var["params"], var["batch_stats"], n_layers=2,
                       ldpc=False)
    params, stats = j_import_fnn(sd, "", 2, 2)
    _same_tree(params, var["params"])
    _same_tree(stats, var["batch_stats"])
    port = tm.load_reference_state_dict(
        tm.FactorNN(2, (hop, NV), dims, (T, 1)), sd).eval()

    def t(a):
        return [torch.from_numpy(x) for x in a]

    with torch.no_grad():
        got, _ = port(torch.from_numpy(node), t(facs),
                      [GatherTable(tables_f2v[0], NF),
                       GatherTable(tables_f2v[1], NG)],
                      [GatherTable(tables_v2f[0], NV),
                       GatherTable(tables_v2f[1], NV)],
                      t(et_f2v), t(et_v2f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
