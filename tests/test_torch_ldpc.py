"""The port's modules, LDPCModel and decoder against the JAX package.

Weights come from a flax init and are carried across with
``load_flax_variables``; inputs are numpy, made from seeds.  Both sides run
in f32 on the CPU (the conftest pins JAX matmuls to full precision).
"""

import ast
import copy
import os
import subprocess
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.ops.typed_mp import Extension as JExtension
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models.norm import instance_norm
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.train import ldpc as t_ldpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(dim_mapping_list=(16, 16, 32, 160, 32), skip_link={3: 1})


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _perturb_stats(stats, seed):
    """Running statistics away from the init's zeros and ones."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return (rng.randn(*a.shape) * 0.3).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# layers


def test_dense(rng):
    x = rng.randn(3, 5, 7).astype(np.float32)
    var = jm.Dense(6).init(jax.random.PRNGKey(0), x)
    port = tm.load_flax_variables(tm.Dense(7, 6), _np_tree(var))
    _close(port(_t(x)), jm.Dense(6).apply(var, x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm(rng, train):
    x = (rng.randn(4, 6, 5) * 2 + 1).astype(np.float32)
    fmod = jm.BatchNorm()
    var = _np_tree(fmod.init(jax.random.PRNGKey(0), x,
                             use_running_average=False))
    var["params"]["scale"] = rng.uniform(0.5, 2, 5).astype(np.float32)
    var["params"]["bias"] = rng.randn(5).astype(np.float32)
    var["batch_stats"] = _perturb_stats(var["batch_stats"], 1)
    port = tm.load_flax_variables(tm.BatchNorm(5), var)
    port.train(train)
    y = port(_t(x))
    if train:
        ref, upd = fmod.apply(var, x, use_running_average=False,
                              mutable=["batch_stats"])
        stats = _np_tree(upd["batch_stats"])
        _close(port.running_mean, stats["mean"], rtol=1e-6, atol=1e-6)
        _close(port.running_var, stats["var"], rtol=1e-6, atol=1e-6)
    else:
        ref = fmod.apply(var, x, use_running_average=True)
    _close(y, ref, rtol=1e-5, atol=1e-5)


def test_instance_norm(rng):
    x = (rng.randn(3, 9, 4) * 3 - 2).astype(np.float32)
    ref = jm.InstanceNorm().apply({}, x)
    _close(instance_norm(_t(x)), ref, rtol=1e-5, atol=1e-5)
    # one node: zeros, as in the JAX package (the global factor)
    assert not instance_norm(_t(x[:, :1])).any()


@pytest.mark.parametrize("name", ["IIDMap", "IIDMapBN", "IIDMapIN", "MLP"])
def test_iid_maps_and_mlp(rng, name):
    x = rng.randn(4, 6, 7).astype(np.float32)
    if name == "MLP":
        fmod, port = jm.MLP([12, 5]), tm.MLP(7, [12, 5])
    else:
        fmod, port = getattr(jm, name)(9), getattr(tm, name)(7, 9)
    kw = {"train": True} if name == "IIDMapBN" else {}
    var = _np_tree(fmod.init(jax.random.PRNGKey(2), x, **kw))
    tm.load_flax_variables(port, var)
    if name == "IIDMapBN":
        ref, _ = fmod.apply(var, x, train=True, mutable=["batch_stats"])
    else:
        ref = fmod.apply(var, x)
    _close(port(_t(x)), ref, rtol=1e-5, atol=1e-5)


def _mp_inputs(rng, B=3, N=12, Nd=10, K=3, T=4, cin=8):
    x = rng.randn(B, N, cin).astype(np.float32)
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    return x, nn, et


@pytest.mark.parametrize("agg", ["max", "softmax"])
@pytest.mark.parametrize("train", [True, False])
def test_mp_conv(rng, agg, train):
    x, nn, et = _mp_inputs(rng)
    fmod = jm.MPConv(6, 4, extension=JExtension.NO_EXTENSION, aggregator=agg)
    var = _np_tree(fmod.init(jax.random.PRNGKey(3), x, jnp.asarray(nn), et))
    var["batch_stats"] = _perturb_stats(var["batch_stats"], 4)
    port = tm.load_flax_variables(tm.MPConv(8, 6, 4, aggregator=agg), var)
    port.train(train)
    y = port(_t(x), nn, _t(et))
    if train:
        ref, upd = fmod.apply(var, x, jnp.asarray(nn), et, train=True,
                              mutable=["batch_stats"])
        stats = _np_tree(upd["batch_stats"])
        _close(port.bn.running_mean, stats["bn"]["mean"])
        _close(port.bn.running_var, stats["bn"]["var"])
    else:
        ref = fmod.apply(var, x, jnp.asarray(nn), et, train=False)
    _close(y, ref)


@pytest.mark.parametrize("nout,with_residual", [(None, True), (11, False)])
def test_mp_conv_residual(rng, nout, with_residual):
    x, nn, et = _mp_inputs(rng, Nd=12)  # the residual add needs Nd == N
    fmod = jm.MPConvResidual(5, 4, extension=JExtension.NO_EXTENSION,
                             with_residual=with_residual, nout=nout)
    var = _np_tree(fmod.init(jax.random.PRNGKey(5), x, jnp.asarray(nn), et))
    port = tm.load_flax_variables(tm.MPConvResidual(
        8, 5, 4, with_residual=with_residual, nout=nout), var)
    y = port(_t(x), nn, _t(et))
    ref, _ = fmod.apply(var, x, jnp.asarray(nn), et, train=True,
                        mutable=["batch_stats"])
    _close(y, ref)


# --------------------------------------------------------------------------
# LDPCModel


def _batch(B, seed=1):
    return next(ContinuousCodesSP(length=B, seed=seed).batches(B))


def _flax_ldpc(kw, batch, seed=0):
    model = jm.LDPCModel(**kw)
    inputs = j_ldpc._model_inputs(batch)
    var = jax.jit(lambda k, i: model.init(k, **i, train=True))(
        jax.random.PRNGKey(seed), inputs)
    return model, inputs, _np_tree(var)


def _port_ldpc(kw, var):
    return tm.load_flax_variables(tm.LDPCModel(**kw), var)


def _port_inputs(port, batch):
    return t_ldpc.model_inputs(port, batch, "cpu")


@pytest.fixture(scope="module")
def small_flax():
    batch = _batch(4)
    return (batch,) + _flax_ldpc(SMALL, batch)


def test_ldpc_model_small_train_and_eval(small_flax):
    batch, model, inputs, var = small_flax
    port = _port_ldpc(SMALL, var)
    # every branch of the layer rule is in the small model
    kinds = {type(getattr(port.main, f"f2v_{i}_0")).__name__
             for i in range(4)}
    assert kinds == {"MPConv", "MPConvResidual"}
    assert port.main.f2v_2_0.mp_conv is not None  # 32 -> 160 bottleneck

    (lg, sb), upd = jax.jit(lambda v, i: model.apply(
        v, **i, train=True, mutable=["batch_stats"]))(var, inputs)
    port.train()
    plg, psb = port(**_port_inputs(port, batch))
    _close(plg, lg)
    _close(psb, sb)
    new_stats = _np_tree(upd["batch_stats"])
    want = copy.deepcopy(port)
    tm.load_flax_variables(want, {"params": var["params"],
                                  "batch_stats": new_stats})
    got_sd, want_sd = port.state_dict(), want.state_dict()
    n_stats = 0
    for k in got_sd:
        if "running_" in k:
            _close(got_sd[k], want_sd[k].numpy(), rtol=1e-5, atol=1e-5)
            n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, tm.BatchNorm)
                              for m in port.modules())

    # eval mode, on the running statistics the train step left behind
    var_eval = {"params": var["params"], "batch_stats": new_stats}
    lg, sb = jax.jit(lambda v, i: model.apply(v, **i, train=False))(
        var_eval, inputs)
    port.eval()
    plg, psb = port(**_port_inputs(port, batch))
    _close(plg, lg)
    _close(psb, sb)


def test_ldpc_model_reference_dims_eval():
    batch = _batch(2, seed=2)
    model, inputs, var = _flax_ldpc({}, batch, seed=1)
    var["batch_stats"] = _perturb_stats(var["batch_stats"], 7)
    port = _port_ldpc({}, var).eval()
    assert port.main.n_layers == 8
    lg, sb = jax.jit(lambda v, i: model.apply(v, **i, train=False))(
        var, inputs)
    fused_mp.reset_counts()
    logits = t_ldpc.decode_logits(port, batch, "cpu")
    assert fused_mp.COUNTS == {"kernel_launches": 0,
                               "bf16_launches": 0, "plain_calls": 16}
    _close(logits, lg)
    with torch.inference_mode():
        _, psb = port(**_port_inputs(port, batch))
    _close(psb, sb)


def test_load_flax_variables_is_strict(small_flax):
    var = small_flax[-1]
    missing = copy.deepcopy(var)
    del missing["params"]["main"]["f2v_0_0"]["mp_conv"]["filters"]
    with pytest.raises(KeyError, match="unfilled"):
        _port_ldpc(SMALL, missing)
    extra = copy.deepcopy(var)
    extra["params"]["main"]["final_conv2"]["scale"] = np.ones(1, np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        _port_ldpc(SMALL, extra)
    wrong = copy.deepcopy(var)
    wrong["batch_stats"]["main"]["v2f_0_0"]["bn1"]["mean"] = np.zeros(
        3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        _port_ldpc(SMALL, wrong)


def test_batch_tables_are_checked():
    batch = _batch(2)
    port = tm.LDPCModel(**SMALL).eval()
    bad = dict(batch)
    bad["nn_idx_v2f"] = batch["nn_idx_v2f"][:, ::-1].copy()
    with pytest.raises(ValueError, match="nn_idx_v2f"):
        t_ldpc.decode_step(port, bad, "cpu")


# --------------------------------------------------------------------------
# the decoder


def test_evaluate_matches_jax(tmp_path):
    path = str(tmp_path / "eval.npz")
    args = Namespace(test_path=path, eval_per_cell=2, batch_size=4,
                     eval_bp_baseline=False, bp_features=False,
                     aggregator="max", model_path="", seed=0)
    model = jm.LDPCModel(**SMALL)
    sample = _batch(4)
    state, _ = j_ldpc.create_state(model, sample, seed=3)
    j_ber, j_err = j_ldpc.evaluate(args, model, state=state)
    port = _port_ldpc(SMALL, {"params": _np_tree(state.params),
                              "batch_stats": _np_tree(state.batch_stats)})
    fused_mp.reset_counts()
    t_ber, t_err = t_ldpc.evaluate(args, port, device="cpu")
    assert fused_mp.COUNTS["plain_calls"] == 8 * 15  # 4 layers x 2, 15 batches
    assert t_ber == j_ber
    assert t_err.shape == (5, 6)
    np.testing.assert_array_equal(t_err, j_err)


def test_decode_cli_writes_and_prints_the_sum_product_baseline(tmp_path,
                                                               capsys):
    """The decoder's default, as the JAX CLI's: a missing grid is written
    with the sum-product matrix (the JAX writer's for the seed and size),
    which the decoder prints after its own; ``--eval-bp-baseline 0``
    writes zeros."""
    ckpt = str(tmp_path / "model.pt")
    torch.save(tm.init_weights(tm.LDPCModel(), 1).state_dict(), ckpt)
    path = str(tmp_path / "grid.npz")
    t_ldpc.main(["--device", "cpu", "--model-path", ckpt, "--test-path",
                 path, "--eval-per-cell", "2", "--batch-size", "60"])
    out = capsys.readouterr().out
    jpath = str(tmp_path / "jax.npz")
    want = j_ldpc.generate_eval_set(jpath, n_per_cell=2)
    with np.load(path) as f:
        np.testing.assert_array_equal(f["bp_err_matrix"], want)
    assert want.any()
    assert out.index("sum-product baseline:") > 0
    assert np.array_str(want, precision=4, suppress_small=True) in out

    zeros = str(tmp_path / "zeros.npz")
    t_ldpc.main(["--device", "cpu", "--model-path", ckpt, "--test-path",
                 zeros, "--eval-per-cell", "1", "--batch-size", "30",
                 "--eval-bp-baseline", "0"])
    assert "sum-product baseline" not in capsys.readouterr().out
    with np.load(zeros) as f:
        assert not f["bp_err_matrix"].any()


def test_evaluate_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    path = str(tmp_path / "never.npz")
    args = Namespace(test_path=path, eval_per_cell=1, batch_size=2,
                     aggregator="max", model_path="", seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ldpc.evaluate(args, tm.LDPCModel(**SMALL))
    assert not os.path.exists(path)  # nothing ran on the CPU instead


def test_port_checkpoint_roundtrip_and_jax_pickle_refused(tmp_path):
    port = tm.init_weights(tm.LDPCModel(**SMALL), 5)
    path = str(tmp_path / "model.pt")
    torch.save(port.state_dict(), path)
    loaded = t_ldpc.load_checkpoint(path, tm.LDPCModel(**SMALL))
    for k, v in port.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k
    import pickle

    # a pickle (JAX checkpoints are pickles) naming a global outside the
    # JAX checkpoint reader's allow-list
    jax_ckpt = str(tmp_path / "jax.ckpt")
    with open(jax_ckpt, "wb") as f:
        pickle.dump({"params": {}, "opt_state": Namespace(a=1)}, f)
    with pytest.raises(ValueError, match="refusing to unpickle the global "
                                         "argparse.Namespace"):
        t_ldpc.load_checkpoint(jax_ckpt, tm.LDPCModel(**SMALL))


def test_seeded_init_distributions():
    a = tm.init_weights(tm.LDPCModel(**SMALL), 0)
    b = tm.init_weights(tm.LDPCModel(**SMALL), 0)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    f = a.main.f2v_1_0.filters
    assert f.abs().max() <= 0.01 and f.std() > 0.003
    bias = a.main.f2v_1_0.bias
    assert bias.min() >= 0 and bias.max() <= 0.05
    w = a.emodel_f2v.dense_0.weight
    assert w.abs().max() <= 1 / np.sqrt(7)


# --------------------------------------------------------------------------
# the port stands alone


def _port_files():
    root = os.path.join(REPO, "fgnn_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or (
        name == "fgnn_tpu" or name.startswith("fgnn_tpu."))


def test_port_sources_import_no_jax():
    n = 0
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_banned(m) for m in names), (path, names)
        n += 1
    assert n > 10


def test_import_leaves_no_jax_module():
    # importing the port, and loading a JAX checkpoint (the committed
    # fixture, a pickle that names optax classes), imports no JAX module
    ckpt = os.path.join(REPO, "fgnn_tpu_torch", "testdata", "ldpc_flat.pkl")
    code = ("import sys, fgnn_tpu_torch.train.ldpc, "
            "fgnn_tpu_torch.train.syn_hop_factor, "
            "fgnn_tpu_torch.data.generate, fgnn_tpu_torch.data.reference_io, "
            "fgnn_tpu_torch.entry, fgnn_tpu_torch.models.knn, "
            "fgnn_tpu_torch.utils.debug, fgnn_tpu_torch.utils.types"
            "\n"
            "from fgnn_tpu_torch.train import common\n"
            f"assert common.read_checkpoint({ckpt!r})['opt_layout'] == "
            "'flat'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax') or m == 'fgnn_tpu' "
            "or m.startswith('fgnn_tpu.')]\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('fgnn_tpu_torch')]), bad)\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('fgnn_tpu_torch.')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    first, loaded = out.stdout.strip().split("\n")
    count, bad = first.split(" ", 1)
    assert int(count) > 5
    assert bad == "[]"
    for mod in ("data.bp_ref", "data.ldpc_cpp", "data.loader",
                "data.generate", "data.reference_io", "ops.bp",
                "models.containers", "train.synthetic",
                "train.jax_checkpoint", "parallel.mesh", "parallel.comm",
                "parallel.sharding", "parallel.edge_partition",
                "parallel.halo", "parallel.launch", "entry", "models.knn",
                "utils.debug", "utils.types"):
        assert f"'fgnn_tpu_torch.{mod}'" in loaded, mod
