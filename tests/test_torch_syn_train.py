"""The port's synthetic MAP trainer against the JAX trainer, on the CPU.

Weights are the flax init's tree filled with seeded values (as in
tests/test_torch_syn_models.py) and are carried across with
``load_flax_variables``; both trainers see the same numpy batches.
Every step starts both from the same weights and running statistics (the
JAX trainer's), then compares the step's metrics, its clipped gradients,
the parameters after the Adam step and the running statistics it leaves.

Gradients follow tests/test_torch_train.py: absolute error per element
against the size of the model's largest gradient (NOISE_REL) plus relative
error (GRAD_RTOL), and relative L2 error (GRAD_REL_L2) where a tensor
stands clear of that floor.  The parameters after a step: Adam's update is
at most lr per element in size (3 steps), and its sign follows the
gradient's, which rounding may flip where the gradient is at the noise
floor.  So every element is held to 2 lr, and the elements whose gradient
is clear of the floor to 1e-6 plus 1e-2 lr.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu.data import RandomPGMHop
from fgnn_tpu.data import batches as j_batches
from fgnn_tpu.data.generate import NpzRPGMData as JNpzRPGMData
from fgnn_tpu.data.loader import PoolBatcher
from fgnn_tpu.train import common as j_common
from fgnn_tpu.train import synthetic as j_syn
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.data import generate as t_generate
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train import synthetic as t_syn
from test_torch_syn_models import _seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
LR = 3e-3
GRAD_RTOL = 1e-3
GRAD_REL_L2 = 1e-3
NOISE_REL = 1e-5
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _args(**kw):
    base = dict(chain_length=12, hop_cap=3, hop_order=5, seed=2,
                model_name="mp_nn_factor", neighbour=8,
                dims=(8, 8, 72, 8, 2), batch_size=B)
    return Namespace(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_setup():
    args = _args()
    jwl = j_syn.SynWorkload("hop", args)
    batches = list(j_batches(jwl.dataset, B, 4))
    variables = _seeded_variables(jwl, jwl.model_inputs(batches[0]), 0)
    state = j_syn.TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=None, gcnt=jnp.asarray(0, jnp.int32))
    return args, jwl, batches, state


def _vars(state):
    return {"params": _np_tree(state.params),
            "batch_stats": _np_tree(state.batch_stats)}


def _port_tensors(args, variables):
    """name -> tensor of a port model loaded from ``variables``."""
    model = tm.load_flax_variables(t_syn.SynWorkload("hop", args).model,
                                   variables)
    return dict(model.named_parameters()), model.state_dict()


def test_three_hop_train_steps_match_jax(jax_setup):
    args, jwl, batches, state = jax_setup
    # the JAX trainer's optimizer with a pass-through transform after the
    # clip that keeps each step's clipped gradients as its state
    tap = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(optax.clip_by_global_norm(1.0), tap,
                     optax.inject_hyperparams(optax.adam)(learning_rate=LR))
    step = j_syn.make_train_step(jwl, tx)
    j_state = jax.tree.map(jnp.copy, state).replace(
        opt_state=tx.init(state.params))

    twl = t_syn.SynWorkload("hop", args)
    tm.load_flax_variables(twl.model, _vars(j_state))
    opt = t_common.make_optimizer(twl.model.parameters(), LR,
                                  weight_decay=0.0)
    for i, batch in enumerate(batches[1:]):
        tm.load_flax_variables(twl.model, _vars(j_state))
        j_state, j_m = step(j_state, batch)
        fused_mp.reset_counts()
        t_m = t_syn.train_step(twl, opt, batch, "cpu")
        assert fused_mp.EXT_COUNTS == {"kernel_launches": 0,
                                       "bf16_launches": 0,
                                       "plain_calls": 4}
        assert fused_mp.EXT_BWD_COUNTS == {"kernel_launches": 0,
                                           "bf16_launches": 0,
                                           "plain_calls": 4}
        for k in ("loss", "acc", "lp_acc"):
            np.testing.assert_allclose(float(t_m[k]), float(j_m[k]),
                                       **METRIC_TOL, err_msg=f"step {i}: {k}")

        grads, _ = _port_tensors(args, {
            "params": _np_tree(j_state.opt_state[1]),
            "batch_stats": _vars(j_state)["batch_stats"]})
        new_params, want_sd = _port_tensors(args, _vars(j_state))
        floor = NOISE_REL * max(g.abs().max().item() for g in grads.values())
        n_clear = 0
        for name, p in twl.model.named_parameters():
            want = grads[name].detach()
            got = p.grad
            if got is None:  # no path to the loss: JAX's gradient is 0
                assert not want.any(), name
                continue
            err = (got - want).abs().max().item()
            assert err <= floor + GRAD_RTOL * want.abs().max().item(), \
                (i, name, err)
            if want.abs().max().item() > 100 * floor:
                rel = ((got - want).norm() / want.norm()).item()
                assert rel <= GRAD_REL_L2, (i, name, rel)
            moved = (p.detach() - new_params[name].detach()).abs()
            assert moved.max().item() <= 2 * LR + 1e-6, (i, name)
            clear = want.abs() > 100 * floor
            if clear.any():
                assert moved[clear].max().item() <= 1e-6 + 1e-2 * LR, \
                    (i, name, moved[clear].max().item())
                n_clear += 1
        assert n_clear > 20
        n = 0
        for k, v in twl.model.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           **STATS_TOL,
                                           err_msg=f"step {i}: {k}")
                n += 1
        assert n > 10


def test_hop_step_launches_per_conv(jax_setup):
    """12 extension convs per step of the reference-width hop model, as
    chip_smoke.py expects on the card: 12 forwards, 10 of them (the max
    convs) with the argmax, and 12 backwards."""
    args = _args(dims=None, chain_length=30, hop_order=9)
    twl = t_syn.SynWorkload("hop", args)
    tm.init_weights(twl.model, 0)
    opt = t_common.make_optimizer(twl.model.parameters(), LR,
                                  weight_decay=0.0)
    batch = next(t_syn.batches(twl.dataset, 2, 1))
    calls = []
    real = fused_mp.typed_gather_mix_agg

    def spy(*a, **kw):
        calls.append(a[5])  # want_argmax
        return real(*a, **kw)

    fused_mp.reset_counts()
    fused_mp.typed_gather_mix_agg = spy
    try:
        t_syn.train_step(twl, opt, batch, "cpu")
    finally:
        fused_mp.typed_gather_mix_agg = real
    assert len(calls) == 12 and sum(calls) == 10
    assert fused_mp.EXT_BWD_COUNTS["plain_calls"] == 12
    assert fused_mp.COUNTS["plain_calls"] == 0


def test_clip_and_adam_match_optax():
    """The same gradients through the JAX trainer's optimizer (optax
    clip_by_global_norm(1.0) then adam) and the port's clip_grad_norm then
    torch Adam without weight decay: steps with the norm above and below
    1, and an LR change as the per-epoch schedule makes one."""
    rng = np.random.RandomState(3)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    scales = [1.0, 0.01, 3.0]  # global norms about 8, 0.08, 24
    grads = [[(rng.randn(*s) * sc).astype(np.float32) for s in shapes]
             for sc in scales]
    tx = j_common.make_optimizer(LR, clip_norm=1.0)
    j_params = [jnp.asarray(p) for p in params]
    j_opt = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                for p in params]
    t_opt = t_common.make_optimizer(t_params, LR, weight_decay=0.0)
    for i, gs in enumerate(grads):
        lr = LR * (0.98 if i == 2 else 1.0)
        j_opt = j_common.set_lr(j_opt, lr)
        t_common.set_lr(t_opt, lr)
        j_gs = [jnp.asarray(g) for g in gs]
        clipped, _ = optax.clip_by_global_norm(1.0).update(j_gs, None)
        upd, j_opt = tx.update(j_gs, j_opt, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, g in zip(t_params, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = t_common.clip_grad_norm(t_params, 1.0)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum(
            (g.astype(np.float64) ** 2).sum() for g in gs))), rtol=1e-6)
        for p, c in zip(t_params, clipped):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(c),
                                       rtol=1e-6, atol=1e-7)
        t_opt.step()
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)


def test_clip_leaves_small_gradients_alone():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([0.3, 0.4, 0.0])  # norm 0.5
    q = torch.nn.Parameter(torch.zeros(2))  # no gradient: skipped
    t_common.clip_grad_norm([p, q], 1.0)
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4, 0.0]))


def test_exp_decay_schedule_matches_jax():
    t, j = t_common.Schedules.exp_decay(0.98), j_common.Schedules.exp_decay(
        0.98)
    for epoch in range(0, 800, 7):
        assert t(epoch) == j(epoch)


def _record(monkeypatch):
    seen = {"train": [], "eval": []}

    def train_step(wl, optimizer, batch, device, mesh=None):
        seen["train"].append(batch)
        return {k: torch.zeros(()) for k in ("loss", "acc", "lp_acc")}

    def eval_step(wl, batch, device):
        seen["eval"].append(batch)
        return torch.zeros(batch["label"].shape, dtype=torch.long)

    monkeypatch.setattr(t_syn, "train_step", train_step)
    monkeypatch.setattr(t_syn, "eval_step", eval_step)
    return seen


def _recorded_run(monkeypatch, tmp_path, *extra):
    """(train batches, eval batches) that a hop run of 2 epochs x 3 steps
    and 2 eval batches hands its steps, seed 7."""
    seen = _record(monkeypatch)
    args = t_syn.parse_args(["--chain-length", "12", "--hop-order", "5",
                             "--train-size", str(3 * B),
                             "--test-size", str(2 * B),
                             "--batch-size", str(B), "--train-epoches", "2",
                             "--seed", "7", "--work-dir", str(tmp_path),
                             *extra], "hop")
    args.dims = (8, 8, 72, 8, 2)
    t_syn.train_and_eval("hop", args, device="cpu")
    assert (len(seen["train"]), len(seen["eval"])) == (6, 2)
    return seen["train"], seen["eval"]


def _check_staged(got, want):
    """Train batches arrive staged (the model's argument names, tensors on
    the device): each holds the host batch's arrays."""
    keys = {"node_feature": "node_feature", "pws": "pws",
            "hops": "efeature_hop", "label": "label", "lp_label": "lp_label"}
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(keys)
        for k, key in keys.items():
            assert isinstance(a[k], torch.Tensor), k
            np.testing.assert_array_equal(a[k].numpy(), b[key], err_msg=k)


def _check_host(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_trainer_batch_order_matches_jax(monkeypatch, tmp_path):
    """With inline synthesis the JAX trainer draws one batch for its
    init, then each epoch's batches, then the eval batches, all from one
    generator; the port draws the same batches in the same order (the
    train batches staged by the prefetch thread)."""
    train, evals = _recorded_run(monkeypatch, tmp_path, "--workers", "0")
    ds = RandomPGMHop(12, hop_order=5, ret_efeature_pw=False, seed=7)
    want = list(j_batches(ds, B, 1 + 2 * 3 + 2))[1:]
    _check_staged(train, want[:6])
    _check_host(evals, want[6:])


@pytest.mark.parametrize("workers", [1, 3])
def test_worker_pool_batches_match_jax(monkeypatch, tmp_path, workers):
    """--workers N: the port's train batches are the JAX trainer's pool
    stream (its first batch drawn for the init), whatever N; the eval
    batches come inline from a fresh generator of the seed, as there."""
    train, evals = _recorded_run(monkeypatch, tmp_path, "--workers",
                                 str(workers))
    args = _args(chain_length=12, hop_order=5, seed=7)
    with PoolBatcher(lambda d=j_syn.make_syn_dataset("hop", args): d, B,
                     n_workers=workers, seed=7) as pool:
        want = list(pool.batches(1 + 2 * 3))[1:]
    _check_staged(train, want)
    ds = RandomPGMHop(12, hop_order=5, ret_efeature_pw=False, seed=7)
    _check_host(evals, list(j_batches(ds, B, 2)))


def test_written_datasets_match_jax_order(monkeypatch, tmp_path):
    """--train-path: one shuffled batch drawn for the init (seed + 1),
    then each epoch in the order of seed + 2, seed + 3; --test-path: the
    first batches in file order.  As NpzRPGMData of the JAX package
    reads the same file."""
    path = str(tmp_path / "hops.npz")
    t_generate.main(["rpgm", "--type", "hops", "--size", str(5 * B),
                     "--chain-length", "12", "--hop-order", "5",
                     "--workers", "2", "--seed", "4", "--out", path])
    train, evals = _recorded_run(monkeypatch, tmp_path / "runs",
                                 "--train-path", path, "--test-path", path)
    npz = JNpzRPGMData(path, size=3 * B)
    want = [b for e in (2, 3)
            for b in npz.batches(B, shuffle=True, seed=7 + e)]
    _check_staged(train, want)
    _check_host(evals, list(JNpzRPGMData(path, size=2 * B).batches(
        B, shuffle=False)))


def _cli(work, *extra, workload="hop"):
    t_syn.main(workload, [
        "--device", "cpu", "--workers", "0",
        "--chain-length", "12", "--hop-order", "5",
        "--train-size", "40", "--test-size", "8", "--batch-size", "4",
        "--seed", "1", "--work-dir", work, *extra])
    (run,) = os.listdir(work)
    return os.path.join(work, run)


def test_cli_trains_evaluates_and_resumes(tmp_path):
    run = _cli(str(tmp_path / "a"), "--train-epoches", "1")
    latest = os.path.join(run, "latest.ckpt")
    first = torch.load(latest, weights_only=True)
    assert (first["epoch"], first["gcnt"]) == (1, 10)
    with open(os.path.join(run, "tf_logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert tags == {"syn_train/loss", "syn_train/acc", "syn_train/lp_acc",
                    "syn_train/samples_per_s", "syn_test/acc",
                    "syn_test/lp_acc", "syn_test/samples_per_s"}
    assert all(np.isfinite(r["value"]) and r["step"] == 10 for r in rows)
    for r in rows:
        if r["tag"].endswith("acc"):
            assert 0.0 <= r["value"] <= 1.0

    run2 = _cli(str(tmp_path / "b"), "--train-epoches", "2",
                "--model-path", latest)
    second = torch.load(os.path.join(run2, "latest.ckpt"),
                        weights_only=True)
    assert (second["epoch"], second["gcnt"]) == (2, 20)
    assert any(not torch.equal(first["model"][k], second["model"][k])
               for k in first["model"] if k.endswith("weight"))


@pytest.mark.parametrize("workload", ["fixed", "pw"])
def test_other_clis_train_on_the_cpu(tmp_path, workload):
    run = _cli(str(tmp_path), "--train-epoches", "1", "--train-size", "8",
               workload=workload)
    assert torch.load(os.path.join(run, "latest.ckpt"),
                      weights_only=True)["gcnt"] == 2


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_syn.main("hop", ["--train-size", "4", "--batch-size", "4",
                           "--workers", "0", "--work-dir", str(tmp_path)])


@pytest.mark.parametrize("cli,flag,item", [
    pytest.param("hop", ["--mesh", "8x1"], "item 6", id="flag0-item 6"),
    pytest.param("ldpc", ["--mesh", "8x1"], "item 6",
                 id="ldpc-flag0-item 6")])
def test_unported_flags_raise(tmp_path, cli, flag, item):
    """--mesh, the last flag that waited for a port-queue item (ROADMAP.md,
    ``item``), is ported: a mesh that is not the world size (8 ranks, in a
    world of one) raises ValueError, naming the world size, before
    anything is written."""
    main, argv = ((t_ldpc.main, ["--train"]) if cli == "ldpc"
                  else (partial(t_syn.main, "hop"), ["--workers", "0"]))
    with pytest.raises(ValueError, match="needs 8 ranks; the world size "
                                         "is 1"):
        main(argv + ["--device", "cpu", "--work-dir", str(tmp_path), *flag])
    assert not os.listdir(tmp_path)


def test_parse_args_keeps_the_jax_defaults():
    t = vars(t_syn.parse_args([], "hop"))
    j = vars(j_syn.parse_args([], "hop"))
    assert set(t) == set(j) | {"device"}
    for k, v in j.items():
        assert t[k] == v, k
    assert t["workers"] == max(1, min(8, (os.cpu_count() or 2) - 1))
    assert t["device"] == "cuda"
    assert t_syn.parse_args([], "fixed").model_name == "mp_nn"


def test_syn_modules_import_no_jax():
    code = ("import sys, fgnn_tpu_torch.train.syn_hop_factor, "
            "fgnn_tpu_torch.train.syn_pw_factor, "
            "fgnn_tpu_torch.train.syn_fixed_pw_hop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax') or m == 'fgnn_tpu' "
            "or m.startswith('fgnn_tpu.')]\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'fgnn_tpu_torch.')), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().endswith(" []")
    for mod in ("data.rpgm", "data.rpgm_oracle", "data.tables",
                "models.containers", "models.factor_mpnn",
                "models.synthetic", "train.synthetic", "graph",
                "ops.segment"):
        assert f"fgnn_tpu_torch.{mod}" in out.stdout, mod
