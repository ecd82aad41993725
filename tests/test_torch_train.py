"""The port's LDPC trainer against the JAX trainer, on the CPU.

Weights come from a flax init (``fgnn_tpu.train.ldpc.create_state``) and
are carried across with ``load_flax_variables``; both trainers see the
same numpy batches.  The port's conv backward runs its plain version here
(the kernel is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py).

Some gradients are zero in exact arithmetic: a bias right before a
BatchNorm or an instance norm (the norm removes any constant shift), and in
the small model the whole global-factor branch of the last layers (its
message is the same for every variable, and the final instance norm removes
it).  In f32 both trainers get rounding noise there instead, and Adam,
which divides by the gradient's own size, turns that noise into updates of
up to lr, of either sign, which then differ between the two trainers.  So:

* every step starts both trainers from the same weights and running
  statistics (the JAX trainer's, carried across), and compares the step's
  metrics, its gradients and the running statistics it leaves;
* a gradient is held to the JAX one by absolute error per element, against
  the size of the model's largest gradient (NOISE_REL), plus relative error
  (GRAD_RTOL); a tensor whose gradient stands clear of that floor is also
  held by relative L2 error (GRAD_REL_L2).  The biases before a norm are
  checked to be at the floor on both sides;
* the optimizer is checked on its own: the same gradients through the JAX
  package's optax chain and through the port's torch Adam, 3 steps,
  parameters equal to 1e-6.
"""

import json
import os
from argparse import Namespace
from itertools import islice

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.train import common as j_common
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models.base import IIDMapBN, IIDMapIN
from fgnn_tpu_torch.models.factor_nn import FactorNN
from fgnn_tpu_torch.models.ldpc_model import SigmaBRegressor
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc

SMALL = dict(dim_mapping_list=(16, 16, 32, 160, 32), skip_link={3: 1})
B = 4
LR = 1e-2
# f32 on both sides, sums taken in other orders through 4 layers of norms
GRAD_RTOL = 1e-3
GRAD_REL_L2 = 1e-3
NOISE_REL = 1e-5     # the noise floor, against the largest gradient
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
# the port's f64-rounded bias against XLA's f32 chain: f32 rounds pow, two
# products, exp, a sum and a division, each to a relative 2^-24 (the
# exponent's rounding amplified by its size)
BIAS_ULPS = 8


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _pre_norm_biases(port):
    """Port parameter names of the biases that feed a norm directly."""
    names = []
    for name, mod in port.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, tm.MPConv):
            names.append(f"{pre}bias")
        elif isinstance(mod, tm.MPConvResidual):
            names += [f"{pre}conv1.bias", f"{pre}conv2.bias"]
        elif isinstance(mod, (IIDMapBN, IIDMapIN)):
            names.append(f"{pre}conv.bias")
        elif isinstance(mod, SigmaBRegressor):
            names.append(f"{pre}fc1.bias")
        elif isinstance(mod, FactorNN):
            names.append(f"{pre}final_conv1.bias")
    return set(names)


@pytest.fixture(scope="module")
def jax_setup():
    batches = list(ContinuousCodesSP(length=4 * B, seed=1).batches(B))
    model = jm.LDPCModel(**SMALL)
    state, tx = j_ldpc.create_state(model, batches[0], seed=0, base_lr=LR)
    variables = {"params": _np_tree(state.params),
                 "batch_stats": _np_tree(state.batch_stats)}
    return batches, model, state, tx, variables


def _copy(state):
    """A copy of a JAX train state: the jitted step donates its input."""
    return jax.tree.map(jnp.copy, state)


def _port(variables):
    return tm.load_flax_variables(tm.LDPCModel(**SMALL), variables)


def _check_metrics(got, want):
    for k in ("loss", "sigma_b_loss", "acc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **METRIC_TOL, err_msg=k)


def _check_grads(port, ref_grads):
    traps = _pre_norm_biases(port)
    assert len(traps) > 10
    floor = NOISE_REL * max(g.abs().max().item() for g in ref_grads.values())
    for name, p in port.named_parameters():
        want = ref_grads[name].detach()
        if p.grad is None:  # no path to the loss: JAX's gradient is 0
            assert not want.any(), name
            continue
        got = p.grad
        err = (got - want).abs().max().item()
        assert err <= floor + GRAD_RTOL * want.abs().max().item(), (name, err)
        if name in traps:
            assert max(got.abs().max().item(),
                       want.abs().max().item()) <= floor, name
        elif want.abs().max().item() > 100 * floor:
            rel = ((got - want).norm() / want.norm()).item()
            assert rel <= GRAD_REL_L2, (name, rel)


@pytest.mark.parametrize("clean_weight", [0.0, 2.0])
def test_three_train_steps_match_jax(jax_setup, clean_weight):
    batches, model, state, tx, variables = jax_setup
    # a pass-through transform that keeps each step's gradients as its state
    tap = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx_tap = optax.chain(tap, tx)
    step = j_ldpc.make_train_step(model, tx_tap, clean_weight=clean_weight)
    j_state = _copy(state).replace(opt_state=tx_tap.init(state.params))

    port = _port(variables)
    opt = t_common.make_optimizer(port.parameters(), LR)
    for i, batch in enumerate(batches[1:]):
        tm.load_flax_variables(port, {
            "params": _np_tree(j_state.params),
            "batch_stats": _np_tree(j_state.batch_stats)})
        j_state, j_m = step(j_state, batch)
        fused_mp.reset_counts()
        t_m = t_ldpc.train_step(port, opt, batch, "cpu", clean_weight)
        # 4 layers x 2 directions of type-0 convs, plain on the CPU; the
        # last layer's v2f conv feeds no loss, so autograd skips its
        # backward
        assert fused_mp.COUNTS == {"kernel_launches": 0,
                                   "bf16_launches": 0, "plain_calls": 8}
        assert fused_mp.BWD_COUNTS == {"kernel_launches": 0,
                                       "bf16_launches": 0,
                                       "plain_calls": 7}
        _check_metrics(t_m, j_m)
        _check_grads(port, dict(_port({
            "params": _np_tree(j_state.opt_state[0]),
            "batch_stats": variables["batch_stats"]}).named_parameters()))

        want_sd = _port({"params": _np_tree(j_state.params),
                         "batch_stats": _np_tree(j_state.batch_stats)}
                        ).state_dict()
        n = 0
        for k, v in port.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           **STATS_TOL,
                                           err_msg=f"step {i + 1}: {k}")
                n += 1
        assert n > 20


@pytest.fixture(scope="module")
def jax_bp_setup():
    """The 3-step test's init and batches (seeds 0 and 1), for the model
    of 4 node features.  At the flax init a step is ill-conditioned (near
    ties in max): against an f64 run of the port, at other seed pairs one
    package's f32 step or the other's lies up to 1.4e-2 relative L2 away
    on a few tensors (the JAX package's 2.2e-3 at (1, 5) without the
    features, the port's 1.4e-2 there with them); at (0, 1) both lie
    within 1e-4, with and without."""
    batches = list(ContinuousCodesSP(length=4 * B, seed=1).batches(B))
    model = jm.LDPCModel(**SMALL)
    state, tx = j_ldpc.create_state(model, batches[0], seed=0, base_lr=LR,
                                    bp_features=True)
    return batches, model, state, tx


def _jax_bias(node_feature):
    """The JAX trainer's f32 bias (fgnn_tpu/train/ldpc.py:90-92)."""
    nf = jnp.asarray(node_feature)
    gcx = jnp.power(10.0, nf[..., 1] / 20.0)
    return np.asarray(1.0 / (1.0 + jnp.exp(-2.0 * gcx * nf[..., 0])))


def test_bp_features_train_and_eval_step_match_jax(jax_bp_setup,
                                                   monkeypatch):
    """--bp-features: one train step against make_train_step(bp_features=
    True), under the 3-step test's tolerances, then one eval step against
    make_eval_step(bp_features=True).  The flax tree of the 4-feature
    model loads strictly into LDPCModel(node_feature_dim=4).

    The port's decoder runs inside its step on the JAX trainer's f32 bias:
    the port rounds its bias from f64 (``bp_bias``), an ulp or so from
    XLA's f32 exp, and the words the decode does not solve in 50 loops
    grow such an ulp to 1e-2 in their posterior (test_bp_features_match_
    jax holds the bias and the decode apart)."""
    monkeypatch.setattr(t_ldpc, "bp_bias", lambda nf: torch.from_numpy(
        _jax_bias(nf.numpy())))
    batches, model, state, tx = jax_bp_setup
    tap = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx_tap = optax.chain(tap, tx)
    step = j_ldpc.make_train_step(model, tx_tap, bp_features=True)
    j_state = _copy(state).replace(opt_state=tx_tap.init(state.params))
    variables = {"params": _np_tree(state.params),
                 "batch_stats": _np_tree(state.batch_stats)}

    def port_of(v):
        return tm.load_flax_variables(
            tm.LDPCModel(**SMALL, node_feature_dim=4), v)

    port = port_of(variables)
    assert port.main.node_mapping.conv.weight.shape[1] == 4
    opt = t_common.make_optimizer(port.parameters(), LR)
    j_state, j_m = step(j_state, batches[1])
    t_m = t_ldpc.train_step(port, opt, batches[1], "cpu", bp_features=True)
    _check_metrics(t_m, j_m)
    _check_grads(port, dict(port_of({
        "params": _np_tree(j_state.opt_state[0]),
        "batch_stats": variables["batch_stats"]}).named_parameters()))
    want_sd = port_of({"params": _np_tree(j_state.params),
                       "batch_stats": _np_tree(j_state.batch_stats)}
                      ).state_dict()
    for k, v in port.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       **STATS_TOL, err_msg=k)

    # one eval step from the weights the train step left
    tm.load_flax_variables(port, {
        "params": _np_tree(j_state.params),
        "batch_stats": _np_tree(j_state.batch_stats)})
    port.eval()
    j_pred = np.asarray(j_ldpc.make_eval_step(model, bp_features=True)(
        j_state, batches[2]))
    j_logits, _ = model.apply(
        {"params": j_state.params, "batch_stats": j_state.batch_stats},
        **j_ldpc._model_inputs(batches[2], bp_features=True), train=False)
    t_logits = t_ldpc.decode_logits(port, batches[2], "cpu",
                                    bp_features=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    t_pred = t_ldpc.decode_step(port, batches[2], "cpu",
                                bp_features=True).numpy()
    clear = np.abs(np.asarray(j_logits)) > 1e-4
    np.testing.assert_array_equal(t_pred[clear], j_pred[:, :48][clear])


def test_bp_features_match_jax(monkeypatch):
    """The appended channels (2 q1 - 1 and the convergence flag of the
    50-loop decode) from the features' own (y, snr_db): the port's bias
    within BIAS_ULPS roundings of the JAX trainer's f32 bias, and from the
    same bias
    the port's channels within 1e-6 of the JAX trainer's on every word."""
    batch = next(ContinuousCodesSP(length=64, seed=6).batches(64))
    nf = batch["node_feature"]
    bias = t_ldpc.bp_bias(torch.from_numpy(nf)).numpy()
    assert bias.dtype == np.float32
    # f32 rounds the exponent a = -2 gcx y to a relative 2^-24, which
    # exp turns into an absolute 2^-24 |a| in its result's relative error
    arg = 2.0 * np.power(10.0, nf[..., 1] / 20.0) * np.abs(nf[..., 0])
    want_bias = _jax_bias(nf)
    err = np.abs(bias - want_bias) / want_bias
    assert (err <= BIAS_ULPS * 2.0 ** -24 * (1.0 + arg)).all(), err.max()
    want = np.asarray(j_ldpc._augment_bp_features(jnp.asarray(nf)))
    monkeypatch.setattr(t_ldpc, "bp_bias", lambda x: torch.from_numpy(
        _jax_bias(x.numpy())))
    got = t_ldpc.augment_bp_features(torch.from_numpy(nf)).numpy()
    assert got.shape == want.shape == (64, 96, 4)
    np.testing.assert_array_equal(got[..., :2], nf)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert 0 < got[:, 0, 3].sum() < 64  # words of both kinds
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                               atol=1e-6)


def test_cli_defaults_match_jax():
    """Every default of the JAX LDPC CLI, and --eval-bp-baseline (on; "0"
    turns it off), --workers and --bp-features as the JAX parser reads
    them."""
    t, j = vars(t_ldpc.parse_args([])), vars(j_ldpc.parse_args([]))
    # every flag of the JAX CLI and the port's --device
    assert set(t) == set(j) | {"device"}
    for k in set(t) - {"device"}:
        assert t[k] == j[k], k
    for argv in (["--eval-bp-baseline", "0"], ["--eval-bp-baseline", "1"],
                 ["--workers", "3", "--bp-features"]):
        t, j = vars(t_ldpc.parse_args(argv)), vars(j_ldpc.parse_args(argv))
        for k in ("eval_bp_baseline", "workers", "bp_features"):
            assert t[k] == j[k], (argv, k)


def test_worker_pool_trains_on_the_jax_pool_stream(monkeypatch, tmp_path):
    """--workers 2: the batches are the JAX trainer's PoolBatcher stream
    over ContinuousCodesSP for the seed."""
    from functools import partial

    from fgnn_tpu.data.loader import PoolBatcher

    seen = []

    def record(model, optimizer, batch, device, clean_weight=0.0,
               bp_features=False, mesh=None):
        seen.append(batch)
        return {k: torch.zeros(()) for k in ("loss", "sigma_b_loss", "acc")}

    monkeypatch.setattr(t_ldpc, "train_step", record)
    args = Namespace(samples_per_epoch=40, snr=None, seed=4, batch_size=B,
                     n_epochs=2, steps_per_epoch=3, model_path="",
                     clean_weight=0.0, workers=2)
    with t_ldpc.MetricsWriter(str(tmp_path / "logs")) as writer:
        t_ldpc.train(args, tm.LDPCModel(**SMALL), writer, str(tmp_path),
                     device="cpu")
    with PoolBatcher(partial(ContinuousCodesSP, length=40, snr=None, seed=4),
                     B, n_workers=2, seed=4) as pool:
        want = list(pool.batches(6))
    assert len(seen) == 6
    for got, ref in zip(seen, want):
        for k in ("node_feature", "hop_feature", "efeature_f2v",
                  "efeature_v2f", "sigma_b"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
        np.testing.assert_array_equal(got["label"].numpy(),
                                      ref["label"][:, :48])


def test_optimizer_matches_optax():
    """The same gradients through optax (add_decayed_weights + adam, the
    JAX package's make_optimizer) and torch Adam, with an LR change as the
    per-epoch schedule makes one."""
    rng = np.random.RandomState(3)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = j_common.make_optimizer(LR, weight_decay=1e-8)
    j_params = [jnp.asarray(p) for p in params]
    j_opt = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                for p in params]
    t_opt = t_common.make_optimizer(t_params, LR)
    for i, gs in enumerate(grads):
        lr = LR * (0.5 if i == 2 else 1.0)
        j_opt = j_common.set_lr(j_opt, lr)
        t_common.set_lr(t_opt, lr)
        upd, j_opt = tx.update([jnp.asarray(g) for g in gs], j_opt, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, g in zip(t_params, gs):
            p.grad = torch.from_numpy(g)
        t_opt.step()
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)


def test_ldpc_schedule_matches_jax():
    t, j = t_common.Schedules.ldpc(), j_common.Schedules.ldpc()
    for epoch in range(0, 40):
        assert t(epoch) == j(epoch)


def test_trainer_sees_the_jax_batches(monkeypatch, tmp_path):
    """The JAX trainer draws one batch before training; the port draws and
    drops it, so that both train on the same batches for one seed.  The
    batches arrive staged by the prefetch thread (``stage_batch``: the
    info-bit labels, tensors on the device)."""
    seen = []

    def record(model, optimizer, batch, device, clean_weight=0.0,
               bp_features=False, mesh=None):
        seen.append(batch)
        return {k: torch.zeros(()) for k in ("loss", "sigma_b_loss", "acc")}

    monkeypatch.setattr(t_ldpc, "train_step", record)
    args = Namespace(samples_per_epoch=40, snr=None, seed=4, batch_size=B,
                     n_epochs=2, steps_per_epoch=3, model_path="",
                     clean_weight=0.0)
    with t_ldpc.MetricsWriter(str(tmp_path / "logs")) as writer:
        t_ldpc.train(args, tm.LDPCModel(**SMALL), writer, str(tmp_path),
                     device="cpu")
    ds = ContinuousCodesSP(length=40, snr=None, seed=4)
    next(ds.batches(B))
    want = [b for _ in range(2) for b in islice(ds.batches(B), 3)]
    assert len(seen) == len(want) == 6
    for got, ref in zip(seen, want):
        for k in ("node_feature", "sigma_b"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
        np.testing.assert_array_equal(got["label"].numpy(),
                                      ref["label"][:, :48])


def _ckpts(work_dir):
    """The one run directory the CLI made under ``work_dir``."""
    (run,) = os.listdir(work_dir)
    return os.path.join(work_dir, run)


def test_cli_trains_on_the_cpu_and_resumes(tmp_path):
    def cli(work, *extra):
        t_ldpc.main(["--train", "--device", "cpu", "--steps-per-epoch", "10",
                     "--batch-size", "2", "--seed", "2", "--work-dir", work,
                     *extra])
        return _ckpts(work)

    run = cli(str(tmp_path / "runs"), "--n-epochs", "1")
    latest = os.path.join(run, "ldpc_latest.ckpt")
    final = os.path.join(run, "ldpc_final.ckpt")
    first = torch.load(latest, weights_only=True)
    assert (first["epoch"], first["gcnt"]) == (1, 10)
    assert os.path.exists(final)
    with open(os.path.join(run, "tf_logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["tag"] for r in rows} == {"syn_train/loss",
                                        "syn_train/sigma_b_loss",
                                        "syn_train/acc"}
    assert all(np.isfinite(r["value"]) and r["step"] == 10 for r in rows)

    # resume: one more epoch from the latest checkpoint, in a new run dir
    run2 = cli(str(tmp_path / "runs2"), "--n-epochs", "2", "--model-path",
               latest)
    second = torch.load(os.path.join(run2, "ldpc_latest.ckpt"),
                        weights_only=True)
    assert (second["epoch"], second["gcnt"]) == (2, 20)
    moved = [not torch.equal(first["model"][k], second["model"][k])
             for k in first["model"] if "weight" in k]
    assert any(moved)

    # the decoder reads the trainer's checkpoint
    model = t_ldpc.load_checkpoint(final, tm.LDPCModel())
    assert torch.equal(model.state_dict()["main.final_conv2.weight"],
                       first["model"]["main.final_conv2.weight"])


def test_train_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ldpc.main(["--train", "--steps-per-epoch", "1", "--batch-size",
                     "2", "--work-dir", str(tmp_path)])


def test_resume_refuses_a_bare_state_dict(tmp_path):
    port = tm.LDPCModel(**SMALL)
    path = str(tmp_path / "bare.pt")
    torch.save(port.state_dict(), path)
    opt = t_common.make_optimizer(port.parameters(), LR)
    with pytest.raises(ValueError, match="optimizer state"):
        t_common.load_checkpoint(path, port, opt)
