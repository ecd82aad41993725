"""The JAX package's checkpoints in the port (``train/jax_checkpoint.py``),
on the CPU.

The JAX trainers wrote the committed fixture ``fgnn_tpu_torch/testdata/``
(``write_fixture``, which ``chip_smoke.py`` also reads on the card): an
LDPC decoder and a hop model (the synthetic trainers' clip chain), each
after 2 JAX train steps with the optimizer in each layout (per-leaf
``"tree"`` and ``optax.flatten``'s ``"flat"``).  The tests hold those files
to the JAX package as it runs here: they load with its ``load_checkpoint``
and give its logits.  The port then decodes each (logits within 1e-4 of
``model.apply``'s), restores its Adam state (the next steps on the same
gradients within 1e-6 of optax's, the moments' map checked without
gradient noise, as tests/test_torch_train.py checks the optimizer) and
resumes through the CLIs.  The models are cut to one layer of width 8
(``LDPC_WIDTHS``, ``HOP``): the leaf map does not depend on depth, and one
layer keeps a checkpoint near 0.8 MB (the fixed 64-wide bottlenecks and the
128-wide regressor) and the JAX compiles few.  Rewrite the fixture with
``JAX_PLATFORMS=cpu python -m tests.test_torch_jax_ckpt`` from the root of
the repository.
"""

import contextlib
import os
import pickle
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.data import batches as j_batches
from fgnn_tpu.train import common as j_common
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu.train import synthetic as j_syn
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models.from_jax import flax_leaves, flax_tensors
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import jax_checkpoint as t_jck
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train import synthetic as t_syn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "fgnn_tpu_torch", "testdata")
FIXTURE = chip_smoke.JAX_FIXTURE
LDPC_WIDTHS = chip_smoke.JAX_FIXTURE_LDPC
HOP = chip_smoke.JAX_FIXTURE_HOP
B = 4
LDPC_LR, HOP_LR = 1e-2, 3e-3
EPOCH = 3          # the epoch the checkpoints record; 2 steps: gcnt 2
STEP_LR = 5e-3     # the LR of the isolated Adam steps
NAMES = ("ldpc_tree", "ldpc_flat", "hop_tree", "hop_flat")
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and torch's thread pools in each would contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


@contextlib.contextmanager
def _layout(layout):
    """The JAX optimizer layout: ``make_optimizer`` and ``load_checkpoint``
    read FGNN_OPT_FLATTEN."""
    old = os.environ.get("FGNN_OPT_FLATTEN")
    os.environ["FGNN_OPT_FLATTEN"] = "1" if layout == "flat" else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FGNN_OPT_FLATTEN"]
        else:
            os.environ["FGNN_OPT_FLATTEN"] = old


def _hop_args():
    return Namespace(chain_length=HOP["chain_length"], hop_cap=3,
                     hop_order=HOP["hop_order"], seed=2,
                     model_name="mp_nn_factor", neighbour=8,
                     dims=HOP["dims"], batch_size=B)


def _path(name):
    return os.path.join(FIXTURE_DIR, f"{name}.pkl")


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


class _Kind:
    """One JAX model (``"ldpc"`` or ``"hop"``) as its trainer builds it:
    the optimizer and train step under the current layout, the init state,
    a state of the trainer's structure from shapes alone, and its eval
    logits on a batch."""

    def __init__(self, name):
        self.name = name
        if name == "ldpc":
            self.model = jm.LDPCModel(**LDPC_WIDTHS)
            self.make_tx = partial(j_common.make_optimizer, LDPC_LR,
                                   weight_decay=1e-8)
            self.make_step = partial(j_ldpc.make_train_step, self.model)
            self.inputs = j_ldpc._model_inputs
        else:
            self.wl = j_syn.SynWorkload("hop", _hop_args())
            self.model = self.wl.model
            self.make_tx = partial(j_common.make_optimizer, HOP_LR,
                                   clip_norm=1.0)
            self.make_step = partial(j_syn.make_train_step, self.wl)
            self.inputs = self.wl.model_inputs

    def batches(self, n):
        if self.name == "ldpc":
            return list(ContinuousCodesSP(length=n * B, seed=1).batches(B))
        return list(j_batches(self.wl.dataset, B, n))

    def init_state(self, batch):
        """The JAX trainer's ``create_state``."""
        with _layout("tree"):
            if self.name == "ldpc":
                return j_ldpc.create_state(self.model, batch, seed=0,
                                           base_lr=LDPC_LR)[0]
            return j_syn.create_state(self.wl, batch, 0,
                                      base_lr=HOP_LR)[0]

    def template(self, batch, tx):
        """A state of the trainer's structure for ``load_checkpoint``,
        from the init's shapes (no compile)."""
        inputs = self.inputs(batch)
        shapes = jax.eval_shape(lambda k: self.model.init(
            k, **inputs, train=True), jax.random.PRNGKey(0))
        zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        return j_common.TrainState(
            params=zeros["params"],
            batch_stats=zeros.get("batch_stats", {}),
            opt_state=tx.init(zeros["params"]),
            gcnt=jnp.asarray(0, jnp.int32))

    def logits(self, batch):
        """The eval-mode logits on ``batch``, jitted over the variables."""
        inputs = self.inputs(batch)
        if self.name == "ldpc":
            return jax.jit(lambda v: self.model.apply(
                v, **inputs, train=False)[0])
        return jax.jit(lambda v: self.model.apply(v, **inputs, train=False))

    def grads(self, params, n):
        """n seeded gradient trees shaped like ``params``; the hop ones
        big enough that the chain's clip by norm 1.0 acts."""
        rng = np.random.RandomState(7 if self.name == "ldpc" else 8)
        scale = 0.1 if self.name == "ldpc" else 0.5
        return [jax.tree.map(
            lambda p: (scale * rng.randn(*p.shape)).astype(np.float32),
            _np_tree(params)) for _ in range(n)]


def _steps(update, state, grads):
    """Params after optax steps on ``grads`` from ``state`` at STEP_LR."""
    params, opt = state.params, j_common.set_lr(
        jax.tree.map(jnp.copy, state.opt_state), STEP_LR)
    for g in grads:
        upd, opt = update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return _np_tree(params)


def _paths(tree, prefix):
    return {f"{prefix}/{'/'.join(p)}": np.asarray(v)
            for p, v in flax_leaves(tree)}


def _stored_tree(stored, prefix):
    """The nested tree ``_paths`` stored under ``prefix``."""
    tree = {}
    for key, value in stored.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = value
    return tree


def write_fixture(out_dir):
    """The JAX trainers' checkpoints after 2 steps (``<kind>_<layout>.pkl``
    for ldpc and hop, tree and flat) and ``jax_fixture.npz``: each kind's
    eval batch (``<kind>/batch/<key>``) and a gradient tree
    (``<kind>/grad/<flax path>``), each checkpoint's eval logits
    (``<name>/logits``) and its params after one optax step on that
    gradient at ``step_lr`` (``<name>/after/<flax path>``)."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {"step_lr": np.float32(STEP_LR)}
    for kind in (_Kind("ldpc"), _Kind("hop")):
        batches = kind.batches(4)
        state0 = kind.init_state(batches[0])
        logits = kind.logits(batches[3])
        grad = kind.grads(state0.params, 1)
        for key, value in batches[3].items():
            arrays[f"{kind.name}/batch/{key}"] = np.asarray(value)
        arrays.update(_paths(grad[0], f"{kind.name}/grad"))
        for layout in ("tree", "flat"):
            with _layout(layout):
                tx = kind.make_tx()
            state = jax.tree.map(jnp.copy, state0.replace(
                opt_state=tx.init(state0.params)))
            step = kind.make_step(tx)
            for batch in batches[1:3]:
                state, _ = step(state, batch)
            name = f"{kind.name}_{layout}"
            j_common.save_checkpoint(os.path.join(out_dir, f"{name}.pkl"),
                                     state, EPOCH)
            arrays[f"{name}/logits"] = np.asarray(logits(_variables(state)))
            arrays.update(_paths(_steps(jax.jit(tx.update), state, grad),
                                 f"{name}/after"))
    np.savez(os.path.join(out_dir, FIXTURE), **arrays)


@pytest.fixture(scope="module")
def runs():
    """The committed checkpoints as the JAX package loads them: name ->
    (kind, layout, path, eval batch, restored state, epoch, jitted optax
    update, JAX eval logits), and the stored arrays."""
    with np.load(os.path.join(FIXTURE_DIR, FIXTURE)) as f:
        stored = dict(f)
    out = {"stored": stored}
    for kind in (_Kind("ldpc"), _Kind("hop")):
        prefix = f"{kind.name}/batch/"
        batch = {k[len(prefix):]: v for k, v in stored.items()
                 if k.startswith(prefix)}
        logits = kind.logits(batch)
        for layout in ("tree", "flat"):
            name = f"{kind.name}_{layout}"
            with _layout(layout):
                tx = kind.make_tx()
                state, epoch, _ = j_common.load_checkpoint(
                    _path(name), kind.template(batch, tx))
            out[name] = Namespace(
                kind=kind, layout=layout, path=_path(name), batch=batch,
                state=state, epoch=epoch, update=jax.jit(tx.update),
                logits=np.asarray(logits(_variables(state))))
    return out


def _port_model(kind):
    if kind == "ldpc":
        return tm.LDPCModel(**LDPC_WIDTHS)
    return t_syn.SynWorkload("hop", _hop_args()).model


def test_committed_fixture_is_the_jax_packages(runs):
    """The committed files load with the JAX package's own loader, and the
    stored logits and one-step params equal its recomputation."""
    stored = runs["stored"]
    for name in NAMES:
        run = runs[name]
        assert run.epoch == EPOCH
        np.testing.assert_allclose(run.logits, stored[f"{name}/logits"],
                                   rtol=0, atol=1e-6, err_msg=name)
        grad = _stored_tree(stored, f"{run.kind.name}/grad")
        after = _steps(run.update, run.state, [grad])
        for key, v in _paths(after, f"{name}/after").items():
            np.testing.assert_allclose(v, stored[key], rtol=0, atol=1e-6,
                                       err_msg=key)


# --------------------------------------------------------------------------
# decode


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_decode_logits_match_jax(runs, layout):
    run = runs[f"ldpc_{layout}"]
    assert t_common.read_checkpoint(run.path)["opt_layout"] == layout
    port = t_ldpc.load_checkpoint(run.path, _port_model("ldpc")).eval()
    got = t_ldpc.decode_logits(port, run.batch, "cpu")
    np.testing.assert_allclose(got.numpy(), run.logits, **LOGITS_TOL)


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_hop_logits_match_jax(runs, layout):
    run = runs[f"hop_{layout}"]
    wl = t_syn.SynWorkload("hop", _hop_args())
    t_jck.restore_jax_payload(t_common.read_checkpoint(run.path), wl.model)
    wl.model.eval()
    with torch.no_grad():
        got = wl.logits(wl.stage(run.batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), run.logits, **LOGITS_TOL)


# --------------------------------------------------------------------------
# Adam state, isolated: the same gradients through optax and torch Adam


@pytest.mark.parametrize("name", NAMES)
def test_restored_adam_steps_match_optax(runs, name):
    run = runs[name]
    grads = run.kind.grads(run.state.params, 2)
    want = _steps(run.update, run.state, grads)

    model = _port_model(run.kind.name)
    opt = t_common.make_optimizer(model.parameters(), 1.0, weight_decay=(
        1e-8 if run.kind.name == "ldpc" else 0.0))
    assert t_common.load_checkpoint(run.path, model, opt) == (EPOCH, 2)
    t_common.set_lr(opt, STEP_LR)
    params = dict(model.named_parameters())
    for g in grads:
        for n, v in flax_tensors(model, "params", g).items():
            params[n].grad = v.clone()
        if run.kind.name == "hop":
            t_common.clip_grad_norm(model.parameters(), 1.0)
        opt.step()
    for n, v in flax_tensors(model, "params", want).items():
        np.testing.assert_allclose(params[n].detach().numpy(), v.numpy(),
                                   **PARAM_TOL, err_msg=n)


def test_flat_and_tree_restore_the_same_moments(runs):
    """Two JAX runs that differ only in the optimizer layout leave the
    same Adam moments; the flat vector's split (ravel order) gives them."""
    states = {}
    for layout in ("tree", "flat"):
        model = _port_model("ldpc")
        opt = t_common.make_optimizer(model.parameters(), LDPC_LR)
        t_common.load_checkpoint(runs[f"ldpc_{layout}"].path, model, opt)
        names = {id(p): n for n, p in model.named_parameters()}
        states[layout] = {names[id(p)]: s for p, s in opt.state.items()}
    assert len(states["tree"]) == len(list(model.parameters()))
    for n, s in states["tree"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(states["flat"][n][k].numpy(),
                                       s[k].numpy(), rtol=1e-6, atol=1e-12,
                                       err_msg=f"{n} {k}")
    assert float(s["step"]) == 2.0


# --------------------------------------------------------------------------
# the CLIs


def _tiny_ldpc(monkeypatch):
    monkeypatch.setattr(t_ldpc, "new_model", lambda args: tm.LDPCModel(
        aggregator=args.aggregator, **LDPC_WIDTHS))


def test_decode_cli_reads_a_jax_checkpoint(runs, monkeypatch, tmp_path,
                                           capsys):
    _tiny_ldpc(monkeypatch)
    path = runs["ldpc_flat"].path
    grid = str(tmp_path / "grid.npz")
    argv = ["--device", "cpu", "--model-path", path, "--test-path", grid,
            "--eval-per-cell", "1", "--batch-size", "10",
            "--eval-bp-baseline", "0"]
    t_ldpc.main(argv)
    printed = capsys.readouterr().out
    args = t_ldpc.parse_args(argv)
    want = t_ldpc.load_checkpoint(path, _port_model("ldpc"))
    ber, err = t_ldpc.evaluate(args, want, device="cpu")
    assert printed == capsys.readouterr().out
    assert err.shape == (5, 6) and 0.0 < ber < 1.0


@pytest.mark.parametrize("layout", ["tree", "flat"])
def test_ldpc_train_cli_resumes_a_jax_checkpoint(runs, monkeypatch,
                                                 tmp_path, layout):
    _tiny_ldpc(monkeypatch)
    work = str(tmp_path / "runs")
    t_ldpc.main(["--train", "--device", "cpu", "--steps-per-epoch", "2",
                 "--batch-size", "2", "--n-epochs", str(EPOCH + 1),
                 "--model-path", runs[f"ldpc_{layout}"].path,
                 "--work-dir", work])
    (run,) = os.listdir(work)
    ckpt = torch.load(os.path.join(work, run, "ldpc_latest.ckpt"),
                      weights_only=True)
    # one epoch from the stored one: the stored 2 steps and 2 more
    assert (ckpt["epoch"], ckpt["gcnt"]) == (EPOCH + 1, 4)
    assert float(ckpt["optimizer"]["state"][0]["step"]) == 4.0


@pytest.mark.parametrize("layout,coo", [("tree", False), ("flat", False),
                                        ("tree", True)])
def test_hop_cli_resumes_a_jax_checkpoint(runs, tmp_path, layout, coo):
    """``train_and_eval`` as ``syn_hop_factor`` runs it, at the fixture's
    widths; a JAX hop checkpoint also resumes the ``--coo`` model."""
    args = t_syn.parse_args([
        "--device", "cpu", "--workers", "0",
        "--chain-length", str(HOP["chain_length"]),
        "--hop-order", str(HOP["hop_order"]), "--train-size", "8",
        "--test-size", "4", "--batch-size", "4",
        "--train-epoches", str(EPOCH + 1), "--seed", "1",
        "--model-path", runs[f"hop_{layout}"].path,
        "--work-dir", str(tmp_path)] + (["--coo"] if coo else []), "hop")
    args.dims = HOP["dims"]
    acc, _ = t_syn.train_and_eval("hop", args)
    (run,) = os.listdir(tmp_path)
    ckpt = torch.load(os.path.join(tmp_path, run, "latest.ckpt"),
                      weights_only=True)
    assert (ckpt["epoch"], ckpt["gcnt"]) == (EPOCH + 1, 4)
    assert 0.0 <= acc <= 1.0


# --------------------------------------------------------------------------
# refusals


class _Shell:
    """Unpickles as a shell command."""

    def __reduce__(self):
        return (os.system, ("touch ran",))


def test_a_pickle_naming_another_global_is_refused(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "opt_state": _Shell()}, f)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(ValueError, match="refusing to unpickle the "
                                             "global posix.system"):
            t_common.read_checkpoint(path)
        with pytest.raises(ValueError, match="global argparse.Namespace"):
            t_jck.read_jax_checkpoint(_dump(tmp_path, {
                "params": {}, "extra": Namespace(a=1)}))
    finally:
        os.chdir(cwd)
    assert not os.path.exists(tmp_path / "ran")   # nothing ran


def _dump(tmp_path, payload, name="ckpt.pkl"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def _plain(path):
    """The payload as the JAX package unpickles it (optax classes)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def test_another_format_version_is_refused(runs, tmp_path):
    payload = _plain(runs["ldpc_tree"].path)
    payload["format_version"] = 999
    with pytest.raises(ValueError, match="format version 999"):
        t_common.read_checkpoint(_dump(tmp_path, payload))
    del payload["format_version"], payload["opt_layout"]  # the oldest
    assert t_common.read_checkpoint(_dump(tmp_path, payload))[
        "opt_layout"] == "flat"


def test_a_flat_moment_of_the_wrong_size_is_refused(runs, tmp_path):
    payload = _plain(runs["ldpc_flat"].path)
    inject = payload["opt_state"][-1]
    adam = inject.inner_state[0]
    short = adam._replace(mu=adam.mu[:-1], nu=adam.nu[:-1])
    payload["opt_state"] = payload["opt_state"][:-1] + (inject._replace(
        inner_state=(short,) + inject.inner_state[1:]),)
    model = _port_model("ldpc")
    opt = t_common.make_optimizer(model.parameters(), LDPC_LR)
    with pytest.raises(ValueError, match="flat opt_state"):
        t_common.load_checkpoint(_dump(tmp_path, payload), model, opt)


def test_params_only_decodes_but_does_not_resume(runs, tmp_path):
    full = _plain(runs["ldpc_tree"].path)
    path = _dump(tmp_path, {"params": full["params"],
                            "batch_stats": full["batch_stats"]})
    model = t_ldpc.load_checkpoint(path, _port_model("ldpc"))
    want = flax_tensors(model, "params", full["params"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    opt = t_common.make_optimizer(model.parameters(), LDPC_LR)
    with pytest.raises(ValueError, match="no opt_state"):
        t_common.load_checkpoint(path, model, opt)


# --------------------------------------------------------------------------
# the committed fixture on the card's code path


def test_port_reads_the_committed_fixture():
    """``chip_smoke.py``'s fixture check on the CPU: logits within 1e-4,
    the Adam step within 1e-6 of the stored JAX results."""
    readings = chip_smoke.check_jax_fixture(torch, "cpu")
    assert sorted(readings) == sorted(NAMES)
    for r in readings.values():
        assert r["logits_max_abs_err"] <= 1e-4
        assert r["step_max_abs_err"] <= 1e-6
        assert (r["epoch"], r["gcnt"]) == (EPOCH, 2)


if __name__ == "__main__":
    # the settings tests/conftest.py gives the tests
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    write_fixture(FIXTURE_DIR)
    print("wrote", sorted(os.listdir(FIXTURE_DIR)))
