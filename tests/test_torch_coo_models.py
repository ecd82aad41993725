"""The port's COO hop model, its data and its trainer modes against the
JAX package's, on the CPU.

``SynHopFactorModelCoo`` takes the JAX COO model's flax tree through
``load_flax_variables`` (seeded at a trained model's scale, as in
tests/test_torch_syn_models.py) and the same numpy batch through both
trainers' workloads (``SynWorkload`` with ``--coo``): logits within 1e-4,
in eval mode against the JAX model, in training mode each of the JAX
model's and the port's f32 logits against the port's f64 run (the pivot of
tests/test_torch_syn_models.py).  On uniform lengths the port's COO and
dense models agree at 1e-4 on one state dict, as
tests/test_coo_batching.py holds the JAX pair.  ``MixedLengthHopData`` and
``BucketedHopData`` give the JAX package's samples bit for bit; three
``--coo`` train steps give the JAX ``make_train_step``'s losses within
2e-4; under ``--bf16`` every COO conv gets the JAX package's dtypes.
"""

import copy
import os
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.data import BucketedHopData as JBucketed
from fgnn_tpu.data import MixedLengthHopData as JMixed
from fgnn_tpu.data import batches as j_batches
from fgnn_tpu.models import mp_conv as j_mp_conv
from fgnn_tpu.models import policy as j_policy
from fgnn_tpu.train import synthetic as j_syn
from fgnn_tpu_torch import data as t_data
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models import mp_conv as t_mp_conv
from fgnn_tpu_torch.models import policy as t_policy
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.segment import CooGraph
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import synthetic as t_syn
from test_torch_syn_models import _np_tree, _perturb_stats, _seeded_variables
from test_torch_syn_train import B as RUN_B
from test_torch_syn_train import _recorded_run

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_DIMS = (8, 8, 72, 8, 2)
B = 3
HOP = 5


def _args(mixed="", dist="", coo=True, L=10, dims=SMALL_DIMS, batch=B,
          seed=1):
    return Namespace(chain_length=L, hop_cap=3, hop_order=HOP, seed=seed,
                     model_name="mp_nn_factor", neighbour=8, dims=dims,
                     batch_size=batch, coo=coo, mixed_lengths=mixed,
                     length_dist=dist)


def _setup(mixed):
    """(args, JAX workload, port workload, numpy batch, JAX inputs,
    seeded variables) of a --coo hop workload; ``mixed`` "" is uniform
    length 10."""
    args = _args(mixed)
    jwl = j_syn.SynWorkload("hop", args)
    batch = next(j_batches(jwl.dataset, B, 1))
    inputs = jwl.model_inputs(batch)
    return (args, jwl, t_syn.SynWorkload("hop", args), batch, inputs,
            _seeded_variables(jwl, inputs, 0))


def _apply(jwl, variables, inputs, train):
    if train:
        return jax.jit(partial(jwl.model.apply, train=True,
                               mutable=["batch_stats"]))(variables, **inputs)
    return jax.jit(partial(jwl.model.apply, train=False))(variables,
                                                          **inputs)


def _f64_logits(args, variables, batch):
    wl = t_syn.SynWorkload("hop", args)
    tm.load_flax_variables(wl.model, variables)
    wl.model.double().train(True)
    wl.buckets = {n: {k: v.double() for k, v in s.items()}
                  for n, s in wl.buckets.items()}
    staged = {k: v.double() if v.is_floating_point() else v
              for k, v in wl.stage(batch, "cpu").items()}
    return wl.logits(staged).detach().numpy()


@pytest.mark.parametrize("mixed", ["", "7,12,5"])
@pytest.mark.parametrize("train", [True, False])
def test_coo_model_matches_flax(mixed, train):
    args, jwl, twl, batch, inputs, variables = _setup(mixed)
    nodes = sum(int(x) for x in mixed.split(",")) if mixed else 10
    assert isinstance(twl.model, tm.SynHopFactorModelCoo)
    assert isinstance(twl.static["coo_pw"], CooGraph)
    if not train:
        variables["batch_stats"] = _perturb_stats(variables["batch_stats"],
                                                  3)
    tm.load_flax_variables(twl.model, variables)
    twl.model.train(train)
    fused_mp.reset_counts()
    got = twl.logits(twl.stage(batch, "cpu")).detach().numpy()
    assert got.shape == (B * nodes, 2)
    assert all(c["plain_calls"] == c["kernel_launches"] == 0 for c in (
        fused_mp.COUNTS, fused_mp.EXT_COUNTS)), "no typed-mp kernel"
    if train:
        ref, upd = _apply(jwl, variables, inputs, True)
        want_sd = tm.load_flax_variables(
            t_syn.SynWorkload("hop", args).model,
            {"params": variables["params"],
             "batch_stats": _np_tree(upd["batch_stats"])}).state_dict()
        n = 0
        for k, v in twl.model.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           **TOL, err_msg=k)
                n += 1
        assert n > 5
        pivot = _f64_logits(args, variables, batch)
        np.testing.assert_allclose(np.asarray(ref), pivot, **TOL,
                                   err_msg="JAX f32 vs the port's f64")
        np.testing.assert_allclose(got, pivot, **TOL,
                                   err_msg="port f32 vs the port's f64")
    else:
        ref = _apply(jwl, variables, inputs, False)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_coo_model_equals_the_dense_model(train):
    """Uniform lengths: the port's COO and dense hop models on one state
    dict give the same logits (tests/test_coo_batching.py's JAX check)."""
    args, jwl, coo, batch, inputs, variables = _setup("")
    variables["batch_stats"] = _perturb_stats(variables["batch_stats"], 5)
    dense = t_syn.SynWorkload("hop", _args(coo=False))
    tm.load_flax_variables(dense.model, variables)
    coo.model.load_state_dict(dense.model.state_dict())
    assert isinstance(dense.model, tm.SynHopFactorModel) and not isinstance(
        dense.model, tm.SynHopFactorModelCoo)
    assert list(coo.model.state_dict()) == list(dense.model.state_dict())
    coo.model.train(train)
    dense.model.train(train)
    got = coo.logits(coo.stage(batch, "cpu")).detach().numpy()
    want = dense.logits(dense.stage(batch, "cpu")).detach().numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, **TOL)
    if train:
        for k, v in coo.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(),
                                       dense.model.state_dict()[k].numpy(),
                                       **TOL, err_msg=k)


def test_reference_width_coo_tables():
    """The path's shapes at the trainer's defaults: B=32 composite groups
    of 24, 30 and 36 nodes are 2880 variables, 2880 factors of each type,
    11520 pairwise and 51840 hop edges; every node receives its table's
    K edges."""
    wl = t_syn.SynWorkload("hop", t_syn.parse_args(
        ["--coo", "--mixed-lengths", "24,30,36"], "hop"))
    assert list(wl.buckets) == [90]
    pw, high = wl.static["coo_pw"], wl.static["coo_high"]
    assert (pw.num_nodes, pw.n_edges, high.n_edges) == (5760, 11520, 51840)
    assert (pw.num_segments, pw.bins.n) == (96, 97)
    assert (pw.by_dst.width, high.by_dst.width, high.by_src.width) == (2, 9,
                                                                       9)
    assert not (pw.by_dst.padded or high.by_dst.padded or high.masked)
    assert tuple(wl.static["ef_high"].shape) == (51840, 2)


# --------------------------------------------------------------------------
# data


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mixed_length_data_matches_jax():
    t = t_data.MixedLengthHopData([7, 12, 5], hop_order=HOP, seed=3)
    j = JMixed([7, 12, 5], hop_order=HOP, seed=3)
    assert t.total_nodes == j.total_nodes == 24
    for _ in range(3):
        _same(t.sample(), j.sample())


def test_bucketed_data_matches_jax():
    kw = dict(hop_order=HOP, seed=4)
    t = list(t_data.BucketedHopData([6, 9, 11], [0.5, 0.3, 0.2], **kw)
             .batches(3, 8))
    j = list(JBucketed([6, 9, 11], [0.5, 0.3, 0.2], **kw).batches(3, 8))
    lengths = [b["label"].shape[1] for b in t]
    assert lengths == [b["label"].shape[1] for b in j]
    assert len(set(lengths)) > 1
    for a, b in zip(t, j):
        _same(a, b)
    with pytest.raises(ValueError, match="one probability per length"):
        t_data.BucketedHopData([6, 9], [1.0], **kw)


def test_bucketed_trainer_draws_the_jax_batches(monkeypatch, tmp_path):
    """--coo --length-dist with the default --workers: the ragged modes
    synthesise inline, and the port's trainer hands its steps the JAX
    trainer's batches (one drawn for the init, 6 train, then 2 eval from
    the same generator), flat and on the tables of each batch's length."""
    train, evals = _recorded_run(monkeypatch, tmp_path, "--coo",
                                 "--mixed-lengths", "7,12",
                                 "--length-dist", "0.6,0.4")
    want = list(JBucketed([7, 12], [0.6, 0.4], hop_order=HOP, seed=7)
                .batches(RUN_B, 9))[1:]
    for got, b in zip(train, want[:6]):
        for arg, key in (("node_feature", "node_feature"), ("pws", "pws"),
                         ("hops", "efeature_hop")):
            np.testing.assert_array_equal(
                got[arg].numpy(), b[key].reshape((-1,) + b[key].shape[2:]))
        np.testing.assert_array_equal(got["label"].numpy(), b["label"])
    for got, b in zip(evals, want[6:]):
        _same(got, b)
    assert len({b["label"].shape[1] for b in want}) == 2


# --------------------------------------------------------------------------
# the trainer


def test_three_coo_train_steps_match_jax():
    """Three --coo --mixed-lengths steps from the JAX trainer's init, dims
    (8, 8, 16, 2): the losses of the JAX make_train_step within 2e-4."""
    args = _args("6,9", dims=(8, 8, 16, 2), batch=4, seed=3)
    jwl = j_syn.SynWorkload("hop", args)
    data = list(j_batches(jwl.dataset, args.batch_size, 3))
    state, tx = j_syn.create_state(jwl, data[0], args.seed)
    twl = t_syn.SynWorkload("hop", args)
    tm.load_flax_variables(twl.model, {
        "params": _np_tree(state.params),
        "batch_stats": _np_tree(state.batch_stats)})
    opt = t_common.make_optimizer(twl.model.parameters(), t_syn.BASE_LR,
                                  weight_decay=0.0)
    step = j_syn.make_train_step(jwl, tx)
    j_loss, t_loss = [], []
    for batch in data:
        state, m = step(state, batch)
        j_loss.append(float(m["loss"]))
        t_m = t_syn.train_step(twl, opt, batch, "cpu")
        t_loss.append(float(t_m["loss"]))
        assert 0.0 <= float(t_m["acc"]) <= 1.0
        np.testing.assert_allclose(float(t_m["lp_acc"]), float(m["lp_acc"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("extra", [["--mixed-lengths", "9,12,15"],
                                   ["--mixed-lengths", "9,12,15",
                                    "--length-dist", "0.5,0.3,0.2"]])
def test_coo_cli_trains_and_evaluates_on_the_cpu(tmp_path, extra):
    acc, lp_acc = t_syn.main("hop", [
        "--device", "cpu", "--coo", *extra, "--train-epoches", "1",
        "--train-size", "12", "--test-size", "6", "--batch-size", "2",
        "--hop-order", str(HOP), "--work-dir", str(tmp_path)])
    assert 0.0 <= acc <= 1.0 and 0.0 <= lp_acc <= 1.0
    (run,) = os.listdir(tmp_path)
    ckpt = torch.load(os.path.join(tmp_path, run, "latest.ckpt"),
                      weights_only=True)
    assert ckpt["gcnt"] == 6
    assert set(ckpt["model"]) == set(tm.SynHopFactorModel(
        hop_order=HOP).state_dict())


# --------------------------------------------------------------------------
# bf16


def _spy(monkeypatch, module, name, seen, dtype_of):
    real = getattr(module, name)

    def spy(x, *a, **kw):
        out = real(x, *a, **kw)
        seen.append((dtype_of(x), dtype_of(out)))
        return out

    monkeypatch.setattr(module, name, spy)


def test_bf16_coo_conv_dtypes_match_jax(monkeypatch):
    """Under the bf16 policy each COO conv's x and output have the JAX
    package's dtypes (bf16 x @ f32 filters promotes to f32 in both)."""
    args, jwl, twl, batch, inputs, variables = _setup("7,12,5")
    tm.load_flax_variables(twl.model, copy.deepcopy(variables))
    j_seen, t_seen = [], []
    _spy(monkeypatch, j_mp_conv, "typed_mp_conv_coo", j_seen,
         lambda a: str(a.dtype))
    _spy(monkeypatch, t_mp_conv, "typed_mp_conv_coo", t_seen,
         lambda a: str(a.dtype).replace("torch.", ""))
    with j_policy.compute_dtype(jnp.bfloat16):
        _apply(jwl, variables, inputs, True)  # the spy runs as it traces
    with t_policy.compute_dtype(torch.bfloat16):
        out = twl.logits(twl.stage(batch, "cpu"))
    assert len(j_seen) == len(t_seen) == 4  # the small dims' convs
    assert t_seen == j_seen
    assert ("bfloat16", "float32") in t_seen
    assert torch.isfinite(out.float()).all()
