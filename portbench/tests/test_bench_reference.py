"""The plain references against the port's CPU path at a tiny size, on
the benchmark's weights: forward, loss and every gradient; and a whole
run of each cell on the CPU comes out correct."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import common as C
from portbench.tests.tiny import CELLS, tiny

DEV = torch.device("cpu")


def setup(name, batch=8, seed=3):
    cell = tiny(name, batch)
    run = harness.Run(cell, seed, 0.1, 0, device="cpu", n_workers=1)
    run.make_pool()
    fam = run.family
    specs = fam.specs(cell.config)
    flat, state = weights.make(specs, seed, DEV)
    prog = fam.Program(cell.config, cell.mix, batch, DEV)
    prog.model.load_state_dict(state)
    ref = fam.Reference(cell.config, cell.mix, DEV)
    return cell, run.pool_host[0], specs, flat, prog, ref


def leaves(specs):
    return [s[0] for s in specs if C.is_parameter(s)]


def rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def check_grads(prog_model, specs, ref_grads):
    named = dict(prog_model.named_parameters())
    for k in leaves(specs):
        gp, gr = named[k].grad, ref_grads[k]
        if gr is None:
            assert gp is None or float(gp.abs().max()) == 0.0, k
            continue
        # f32 rounding alone: at this size the f32 reference itself lies
        # up to 1.4e-4 from an f64 run on the first layer's weights
        scale = max(float(gr.norm()), 1e-3 * max(
            float(g.norm()) for g in ref_grads.values() if g is not None))
        assert float((gp - gr).norm()) <= 1e-3 * scale, k


@pytest.mark.parametrize("train", [True, False])
def test_ldpc_forward_loss_and_gradients(train):
    cell, batch, specs, flat, prog, ref = setup("ldpc_train.b4096")
    from portbench.reference import ldpc as R
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.views(flat, specs).items()}
    inp = ref.inputs(batch, torch.float32)
    prog.model.train(train)
    pin = {k: torch.as_tensor(batch[k]) for k in
           ("node_feature", "hop_feature", "efeature_f2v", "efeature_v2f")}
    lp, sp = prog.model(**pin)
    lr, sr = R.forward(P, cell.config, ref.tabs, inp, train)
    assert rel(lp, lr) < 1e-5 and rel(sp, sr) < 1e-5
    if not train:
        return
    bce, mse = R.losses(cell.config, lr, sr, inp)
    lab = torch.as_tensor(batch["label"][:, :48]).float()
    sb = torch.as_tensor(batch["sigma_b"])
    pbce = torch.nn.functional.binary_cross_entropy_with_logits(lp, lab)
    pmse = (sp.reshape(-1) - torch.pow(10.0, sb / 20.0)).square().mean()
    assert abs(float(pbce) - float(bce)) <= 1e-6 * float(bce)
    assert abs(float(pmse) - float(mse)) <= 1e-5 * float(mse)
    (pbce + 0.1 * pmse).backward()
    ks = leaves(specs)
    g = torch.autograd.grad(R.objective(cell.config, bce, mse),
                            [P[k] for k in ks], allow_unused=True)
    check_grads(prog.model, specs, dict(zip(ks, g)))


@pytest.mark.parametrize("name", ["hop_train.b2048", "hop_coo_mixed.b512"])
def test_hop_forward_loss_and_gradients(name):
    cell, batch, specs, flat, prog, ref = setup(name, batch=4)
    from portbench.reference import hop as R
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.views(flat, specs).items()}
    staged = prog.wl.stage({k: torch.as_tensor(v) for k, v in batch.items()},
                           DEV)
    prog.model.train()
    lp = prog.wl.logits(staged).reshape(-1, 2)
    m, inp = ref.inputs(batch, torch.float32)
    lr = R.forward(P, cell.config, ref.union(m), inp, True)
    # six layers of BatchNorm over 4 chains: f32 rounding reads 1.2e-5
    assert rel(lp, lr) < 1e-4
    label = staged["label"].reshape(-1).long()
    pl = torch.nn.functional.cross_entropy(lp, label)
    rl = R.loss(lr, inp["label"])
    assert abs(float(pl) - float(rl)) <= 1e-6 * float(rl)
    pl.backward()
    ks = leaves(specs)
    g = torch.autograd.grad(rl, [P[k] for k in ks], allow_unused=True)
    check_grads(prog.model, specs, dict(zip(ks, g)))


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_is_correct(name):
    out = harness.execute(tiny(name), 2 ** 31 + 99, 0.2, 0, device="cpu",
                          n_workers=1)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) >= {"setup_s"}
