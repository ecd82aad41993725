"""The port's ``--mesh DPxTP`` training (``fgnn_tpu_torch.parallel``,
``train.common.prepare_mesh_training``) against the JAX package's, on the
CPU.

The port's ranks are gloo processes on the CPU, spawned once for the file
(``parallel.launch.run_ranks``; the worker, which imports no JAX, is
``torch_mesh_workers.mesh_worker``): 4 ranks run 2x2, then split into two
worlds of 2 that run 2x1 (with the SyncBatchNorm, ``--clean-weight``, hop
trainer and batch-divisibility checks) and 1x2 (with a resume from an
unmeshed checkpoint).  The LDPC model is tests/test_mesh_trainer.py's
(skip_link {}, B=8) with one layer 64 wide, so that a model axis of 2
shards its filter banks (64 * 4 >= 128 * 2 columns), and starts from the
flax init of ``fgnn_tpu.train.ldpc.create_state``.  The JAX reference is
``prepare_mesh_training("2x2")`` on 4 virtual devices: the JAX package's
own tests hold its meshes equal to one another and to one device
(tests/test_mesh_trainer.py), so one mesh that is both data and tensor
parallel is the reference of all three of the port's.

Tolerances: losses rtol 1e-4 over 3 steps (the JAX trajectory test's: the
cross-device reduction order moves bits and Adam amplifies them); the
first step's gradients, parameters and running statistics as
tests/test_torch_train.py and tests/test_torch_syn_train.py hold a step
(gradients per element to the noise floor plus 1e-3 of the largest, 1e-3
relative L2; every parameter within 2 lr, those with a gradient clear of
the floor within 1e-6 plus 1e-2 lr; statistics rtol 1e-4, atol 1e-5).
The port's own unmeshed step is the reference where the JAX package has
no mesh counterpart (SyncBatchNorm alone, ``--clean-weight``, the resume).
"""

import os
import subprocess
import sys
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.parallel import parse_mesh_spec as j_parse_mesh_spec
from fgnn_tpu.parallel import shard_batch as j_shard_batch
from fgnn_tpu.parallel import make_mesh as j_make_mesh
from fgnn_tpu.parallel.mesh import set_spmd_mesh
from fgnn_tpu.parallel.sharding import _param_spec
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu.train.common import prepare_mesh_training as j_prepare
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models.from_jax import flax_leaf, flax_leaves
from fgnn_tpu_torch.models.norm import BatchNorm
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.parallel import (
    param_shard_dim,
    parse_mesh_spec,
    run_ranks,
    shard_batch,
)
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.utils.logging import MetricsWriter

import torch_mesh_workers

DIMS = (16, 16, 64, 16)
B = 8
LR = 1e-2
CLEAN_WEIGHT = 2.0
SPECS = ("2x1", "1x2", "2x2")
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_REL_L2 = 1e-3
NOISE_REL = 1e-5
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _jax_mesh_steps(model, state, tx, batches):
    """JAX's 2x2 mesh steps: metrics per step, the first step's gradients
    (a pass-through transform keeps them as its state) and state."""
    tap = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx_tap = optax.chain(tap, tx)
    st = state.replace(opt_state=tx_tap.init(state.params))
    try:
        _, st, put = j_prepare("2x2", st, B, devices=jax.devices()[:4])
        step = j_ldpc.make_train_step(model, tx_tap)
        out = {"metrics": []}
        for i, b in enumerate(batches):
            st, m = step(st, put(b))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["grads"] = _np_tree(st.opt_state[0])
                out["params"] = _np_tree(st.params)
                out["batch_stats"] = _np_tree(st.batch_stats)
    finally:
        set_spmd_mesh(None)
    return out


def _port_tensors(variables):
    """Flax variables as the port's {name: array}."""
    return {k: v.numpy() for k, v in tm.load_flax_variables(
        tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}),
        variables).state_dict().items()}


def _port_ldpc_run(work, n_epochs, model_path, seed):
    """The port's unmeshed ``train.ldpc.train``: epochs of 2 steps, on one
    thread as the ranks run (the CPU's sums take another order on more)."""
    args = Namespace(samples_per_epoch=16, snr=None, seed=seed,
                     batch_size=B, n_epochs=n_epochs, steps_per_epoch=2,
                     model_path=model_path, clean_weight=0.0, mesh="")
    model = tm.init_weights(tm.LDPCModel(dim_mapping_list=DIMS,
                                         skip_link={}), seed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with MetricsWriter(os.path.join(work, "tf_logs")) as writer:
            return t_ldpc.train(args, model, writer, work, device="cpu")
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference, the port's unmeshed references and the port's
    mesh runs (one spawn of 4 ranks)."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    batches = list(ContinuousCodesSP(length=24, seed=0).batches(B))
    model = jm.LDPCModel(dim_mapping_list=DIMS, skip_link={})
    state, tx = j_ldpc.create_state(model, batches[0], seed=0, base_lr=LR)
    variables = {"params": _np_tree(state.params),
                 "batch_stats": _np_tree(state.batch_stats)}
    rng = np.random.RandomState(5)
    seed = 3
    _port_ldpc_run(os.path.join(tmp, "first"), 1, "", seed)
    case = dict(dims=DIMS, variables=variables, batches=batches, lr=LR,
                clean_weight=CLEAN_WEIGHT, seed=seed,
                bn_x=rng.randn(B, 6, 5).astype(np.float32),
                bn_g=rng.randn(B, 6, 5).astype(np.float32),
                ckpt=os.path.join(tmp, "first", "ldpc_final.ckpt"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, torch_mesh_workers.mesh_worker, 4,
                            "gloo", "cpu", tmp, case)
        want = _jax_mesh_steps(model, state, tx, batches)
        resumed = _port_ldpc_run(os.path.join(tmp, "second"), 2, case["ckpt"],
                                 seed)
        got = ranks.result()
    return dict(case=case, want=want, got=got, tmp=tmp,
                resumed=resumed.state_dict())


def _check_grads(got, ref):
    floor = NOISE_REL * max(np.abs(g).max() for g in ref.values())
    for name, want in ref.items():
        g = got[name]
        if g is None:  # no path to the loss: JAX's gradient is 0
            assert not want.any(), name
            continue
        err = np.abs(g - want).max()
        assert err <= floor + GRAD_RTOL * np.abs(want).max(), (name, err)
        if np.abs(want).max() > 100 * floor:
            rel = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert rel <= GRAD_REL_L2, (name, rel)
    return floor


def _rank_runs(got, spec):
    """The results of the ranks that ran ``spec``."""
    return [g[spec] for g in got if spec in g]


# --------------------------------------------------------------------------
# no ranks


@pytest.mark.parametrize("spec", ["8x1", "4x2", "1x1", "2X2", "auto", "8",
                                  "2x0", "axb", "1x2x3"])
def test_parse_mesh_spec_matches_jax(spec):
    if spec == "auto":  # all ranks of the run, one here; JAX: its devices
        assert parse_mesh_spec(spec) == (1, 1)
        assert j_parse_mesh_spec(spec) == (len(jax.devices()), 1)
        return
    try:
        want = j_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("tp", [2, 4])
def test_param_shard_dim_matches_jax_param_spec(tp):
    """On every parameter of the reference LDPCModel: the port shards the
    parameters that JAX's rule shards, along the dim that is JAX's last."""
    model = jm.LDPCModel()
    b = next(ContinuousCodesSP(length=2, seed=0).batches(2))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), **j_ldpc._model_inputs(b),
        train=False))["params"]
    port = tm.LDPCModel()
    state = port.state_dict()
    n_sharded = 0
    for path, leaf in flax_leaves(shapes):
        key, transposed = flax_leaf(port, "params", path, state)
        spec = _param_spec(leaf, tp)
        dim = param_shard_dim(tuple(state[key].shape), transposed, tp)
        if spec == jax.sharding.PartitionSpec():
            assert dim is None, key
            continue
        n_sharded += 1
        assert spec[-1] == "model", key
        assert dim == (0 if transposed else state[key].ndim - 1), key
        assert state[key].shape[dim] == leaf.shape[-1]
    assert n_sharded > (10 if tp == 2 else 0)


def test_shard_batch_picks_jax_keys():
    """The arrays whose leading dim is the batch size are sharded, the rest
    replicated, as JAX's shard_batch places them."""
    batch = next(ContinuousCodesSP(length=B, seed=1).batches(B))
    batch["table"] = np.zeros((96, 3), np.int32)
    jmesh = j_make_mesh((2, 1), devices=jax.devices()[:2])
    want = j_shard_batch(batch, jmesh, B)
    for rank in range(2):
        mesh = SimpleNamespace(dp=2, data_rank=rank)
        got = shard_batch(batch, mesh, B)
        for k, v in batch.items():
            sharded = want[k].sharding.spec != jax.sharding.PartitionSpec()
            rows = slice(rank * B // 2, (rank + 1) * B // 2)
            np.testing.assert_array_equal(got[k], v[rows] if sharded else v)
    with pytest.raises(ValueError, match="must divide"):
        shard_batch(batch, SimpleNamespace(dp=3, data_rank=0), B)


# --------------------------------------------------------------------------
# the ranks


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_losses_match_jax(runs, spec):
    want = runs["want"]["metrics"]
    for r in _rank_runs(runs["got"], spec):
        assert len(r["metrics"]) == len(want) == 3
        for got, ref in zip(r["metrics"], want):
            np.testing.assert_allclose(got["loss"], ref["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["sigma_b_loss"],
                                       ref["sigma_b_loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_first_step_matches_jax(runs, spec):
    """Gradients, parameters and running statistics after one step."""
    want = runs["want"]
    grads = _port_tensors({"params": want["grads"],
                           "batch_stats": runs["case"]["variables"]
                           ["batch_stats"]})
    after = _port_tensors({"params": want["params"],
                           "batch_stats": want["batch_stats"]})
    runs_ = _rank_runs(runs["got"], spec)
    assert len(runs_) == (4 if spec == "2x2" else 2)
    for r in runs_:
        pgrads = {k: v for k, v in grads.items() if k in r["grads"]}
        floor = _check_grads(r["grads"], pgrads)
        for k, v in after.items():
            got = r["state"][k]
            if "running_" in k:
                np.testing.assert_allclose(got, v, **STATS_TOL, err_msg=k)
                continue
            assert np.abs(got - v).max() <= 2 * LR, k
            clear = np.abs(grads[k]) > 100 * floor
            np.testing.assert_allclose(got[clear], v[clear], rtol=0,
                                       atol=1e-6 + 1e-2 * LR, err_msg=k)


def test_tensor_parallel_shards_and_kernels(runs):
    """Under a model axis of 2 the 64-wide layer's filter banks are shards;
    every rank runs the conv (here its plain version) as often per step as
    the unmeshed step does."""
    model = tm.load_flax_variables(
        tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}),
        runs["case"]["variables"])
    opt = t_common.make_optimizer(model.parameters(), LR)
    fused_mp.reset_counts()
    t_ldpc.train_step(model, opt, runs["case"]["batches"][0], "cpu")
    per_step = (fused_mp.COUNTS["plain_calls"],
                fused_mp.BWD_COUNTS["plain_calls"])
    assert per_step[0] > 0 and per_step[1] > 0
    wide = sorted(
        f"{n}.{p}" for n, m in model.named_modules()
        for p, t in m.named_parameters(recurse=False)
        if param_shard_dim(tuple(t.shape), isinstance(m, tm.Dense)
                           and p == "weight", 2) is not None)
    assert wide and all(k.endswith(".filters") for k in wide)
    for spec in SPECS:
        for r in _rank_runs(runs["got"], spec):
            fwd, bwd = r["counts"]
            assert (fwd["plain_calls"], bwd["plain_calls"]) == tuple(
                3 * n for n in per_step), spec
            assert fwd["kernel_launches"] == bwd["kernel_launches"] == 0
            if spec == "2x1":
                assert r["shards"] == []
            else:
                assert r["shards"] == wide, spec


def test_syncbn_matches_one_rank_on_the_whole_batch(runs):
    case = runs["case"]
    x, g = case["bn_x"], case["bn_g"]
    bn = BatchNorm(x.shape[-1])
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    got = [r["syncbn"] for r in runs["got"] if "syncbn" in r]
    assert len(got) == 2
    np.testing.assert_allclose(np.concatenate([r["out"] for r in got]),
                               y.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["grad"] for r in got]),
                               xt.grad.numpy(), rtol=1e-4, atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r["mean"], bn.running_mean.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["var"], bn.running_var.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_clean_weight_under_2x1_matches_the_unmeshed_step(runs):
    """The weighted BCE divides by the global sum of the weights."""
    case = runs["case"]
    model = tm.load_flax_variables(
        tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}), case["variables"])
    opt = t_common.make_optimizer(model.parameters(), LR)
    m = t_ldpc.train_step(model, opt, case["batches"][0], "cpu",
                          CLEAN_WEIGHT)
    ref = {n: (None if p.grad is None else p.grad.numpy())
           for n, p in model.named_parameters()}
    got = _rank_runs(runs["got"], "clean")
    assert len(got) == 2
    for r in got:
        for k in ("loss", "sigma_b_loss", "acc"):
            np.testing.assert_allclose(r["metrics"][0][k], float(m[k]),
                                       **METRIC_TOL, err_msg=k)
        _check_grads(r["grads"], {k: v for k, v in ref.items()
                                  if v is not None})


def test_hop_trainer_runs_under_2x1(runs):
    got = [r["hop"] for r in runs["got"] if "hop" in r]
    assert len(got) == 2 and got[0] == got[1]
    assert 0.0 <= got[0]["acc"] <= 1.0 and 0.0 <= got[0]["lp_acc"] <= 1.0
    (run,) = os.listdir(os.path.join(runs["tmp"], "hop"))  # rank 0 alone
    files = os.listdir(os.path.join(runs["tmp"], "hop", run))
    assert {"latest.ckpt", "tf_logs", "logs"} <= set(files)


def test_mesh_checkpoint_resumes_unmeshed_and_back(runs):
    """An unmeshed checkpoint resumes under 1x2 (sharded filters and Adam
    state) and the mesh's checkpoint, written unmeshed by rank 0, equals
    the unmeshed resume's and loads into an unmeshed model and Adam."""
    got = [r["resume"] for r in runs["got"] if "resume" in r]
    assert got[0]["files"] == ["ldpc_final.ckpt", "ldpc_latest.ckpt",
                               "tf_logs"]
    for r in got:
        for k, v in runs["resumed"].items():
            np.testing.assert_allclose(r["state"][k], v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    path = os.path.join(runs["tmp"], "resume", "ldpc_final.ckpt")
    model = tm.LDPCModel(dim_mapping_list=DIMS, skip_link={})
    opt = t_common.make_optimizer(model.parameters(), LR)
    assert t_common.load_checkpoint(path, model, opt) == (2, 4)
    ref = t_common.read_checkpoint(os.path.join(
        runs["tmp"], "second", "ldpc_final.ckpt"))["optimizer"]
    mine = opt.state_dict()
    assert mine["state"].keys() == ref["state"].keys()
    for i, st in ref["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(mine["state"][i][k].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6)


def test_clip_norm_counts_each_shard_once(runs):
    """Under 1x2 the global norm that clipping takes is the unmeshed one."""
    case = runs["case"]
    model = tm.load_flax_variables(
        tm.LDPCModel(dim_mapping_list=DIMS, skip_link={}), case["variables"])
    opt = t_common.make_optimizer(model.parameters(), LR)
    t_ldpc.train_step(model, opt, case["batches"][0], "cpu")
    want = float(t_common.clip_grad_norm(model.parameters(), 1e30))
    got = [r["clip"] for r in runs["got"] if "clip" in r]
    assert len(got) == 2
    np.testing.assert_allclose(got, [want, want], rtol=1e-5)


def test_batch_must_divide_the_data_axis(runs):
    msgs = [r["divisibility"] for r in runs["got"] if "divisibility" in r]
    assert len(msgs) == 2
    assert all("batch size 7 must divide the data axis (2)" in m
               for m in msgs)


def test_ldpc_cli_trains_under_torchrun(tmp_path):
    """The CLI as a user starts it: torchrun, 2 gloo ranks on the CPU,
    --mesh 1x2; rank 0 alone makes the run's directory, and its final
    checkpoint resumes an unmeshed model and Adam."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "fgnn_tpu_torch.train.ldpc",
         "--train", "--device", "cpu", "--mesh", "1x2", "--n-epochs", "1",
         "--steps-per-epoch", "2", "--batch-size", "4",
         "--work-dir", str(tmp_path)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, check=True, capture_output=True, timeout=300)
    (run,) = os.listdir(tmp_path)
    model = tm.LDPCModel()
    opt = t_common.make_optimizer(model.parameters(), LR)
    assert t_common.load_checkpoint(str(tmp_path / run / "ldpc_final.ckpt"),
                                    model, opt) == (1, 2)
