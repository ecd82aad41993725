"""The port's ECCT (``models/ecct.py``, ``ops/code_attention.py``,
``train/ecct.py``) on the CPU, at N=2 layers of width 32 with 8 heads on
the real 96.3.963 code, against the benchmark's plain reference
(``portbench/reference/ecct.py``, which imports nothing of the port):
logits, loss and every parameter's gradient; the code's mask; a masked key
that leaves the output's bits alone; the syndrome; the plain route against
torch's attention; the card kernels' row and column tables, and their
forward and backward recurrences over them in PyTorch ops against the
plain route; the reference in bfloat16 failing the tolerances the port
meets; the train step's spans and counters; the CLI."""

import glob
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fgnn_tpu_torch.data import code_mask, default_structure, parity_check, \
    syndrome
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.code_attention import (CodeTables, code_attention,
                                               plain_attention)
from fgnn_tpu_torch.train import ecct as T
from fgnn_tpu_torch.train.common import Schedules, make_optimizer
from fgnn_tpu_torch.utils.profiling import record_spans
from portbench import weights
from portbench.reference import ecct as R

CFG = {"dims": 32, "layers": 2, "heads": 8}
B = 4
# f32 round-off alone: the port and the reference sum in other orders (the
# attention's scores, LayerNorm's statistics, the GEMMs); over two layers
# the logits read under 1e-6 and the loss under 1e-7, relative
LOGIT_TOL, LOSS_TOL = 1e-5, 1e-6
# each leaf against the larger of its own norm and a thousandth of the
# largest leaf's: the key maps' biases have a gradient of round-off alone
# (a shift of every key's score for one query leaves its softmax)
GRAD_TOL = 1e-4


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def words(seed=3, n=B):
    return T.words(np.random.RandomState(seed), n, T.TRAIN_SNRS)


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    specs = R.specs(CFG)
    flat, state = weights.make(specs, 11, torch.device("cpu"))
    model = T.new_model(CFG["dims"], CFG["layers"], CFG["heads"])
    model.load_state_dict(state)
    P = {k: v.detach().clone() for k, v in weights.views(flat, specs).items()}
    batch = words()
    staged = T.stage_batch(batch, "cpu")
    return specs, model, P, batch, staged


def reference(P, staged, dtype):
    """The reference's logits and loss in ``dtype``, and its gradients."""
    Pd = {k: v.to(dtype).requires_grad_(True) for k, v in P.items()}
    tabs = R.Tables(torch.device("cpu"))
    y = staged["y"].to(dtype)
    logits = R.forward(Pd, CFG, tabs, y)
    loss = F.binary_cross_entropy_with_logits(logits,
                                              staged["flips"].to(dtype))
    keys = sorted(Pd)
    grads = torch.autograd.grad(loss, [Pd[k] for k in keys])
    return logits, loss, dict(zip(keys, grads))


def gaps(model, P, staged, dtype):
    """(logit gap, loss gap, worst leaf's gradient gap) of the port's f32
    CPU path against the reference in ``dtype``."""
    model.zero_grad(set_to_none=True)
    logits = model(staged["y"])
    loss = F.binary_cross_entropy_with_logits(logits,
                                              staged["flips"].float())
    loss.backward()
    r_logits, r_loss, r_grads = reference(P, staged, dtype)
    floor = 1e-3 * max(float(g.double().norm()) for g in r_grads.values())
    named = dict(model.named_parameters())
    g_gap = max(float((named[k].grad.double() - g.double()).norm())
                / max(float(g.double().norm()), floor)
                for k, g in r_grads.items())
    return (rel(logits, r_logits),
            abs(float(loss.detach()) - float(r_loss.detach()))
            / float(r_loss.detach()), g_gap)


def test_port_matches_the_plain_reference(setup):
    specs, model, P, _, staged = setup
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {n: tuple(s) for n, s, _ in specs}
    logit_gap, loss_gap, grad_gap = gaps(model, P, staged, torch.float32)
    assert logit_gap < LOGIT_TOL
    assert loss_gap < LOSS_TOL
    assert grad_gap < GRAD_TOL


def test_the_reference_in_bfloat16_fails_the_tolerances(setup):
    _, model, P, _, staged = setup
    logit_gap, loss_gap, grad_gap = gaps(model, P, staged, torch.bfloat16)
    assert logit_gap > 10 * LOGIT_TOL
    assert loss_gap > LOSS_TOL and grad_gap > GRAD_TOL


def test_the_code_mask():
    h = parity_check()
    # the encoded words' matrix: 96.3.963 with three ones added
    alist = default_structure()
    h0 = np.zeros_like(h)
    h0[np.arange(48)[:, None], alist.factors] = 1
    assert h.shape == (48, 96) and (h != h0).sum() == 3 and (h >= h0).all()
    assert np.linalg.matrix_rank(h.astype(float)) == 48
    assert np.linalg.matrix_rank(h0.astype(float)) == 46
    # Algorithm 1 on 96.3.963: 19 tokens per bit (itself, 15 bits, 3
    # checks), 7 per check, 2160 in all
    m0 = code_mask(h0)
    assert m0.sum() == 2160
    assert (m0[:96].sum(1) == 19).all() and (m0[96:].sum(1) == 7).all()
    # on the encoded words' matrix the three added ones join more tokens
    m = code_mask(h)
    assert m.sum() == 2198
    assert sorted(np.unique(m[:96].sum(1))) == [19, 20, 25, 26, 27]
    assert sorted(np.unique(m[96:].sum(1))) == [7, 8]
    for mk in (m0, m):
        assert (mk == mk.T).all() and mk.diagonal().all()
        assert not (mk[96:, 96:] & ~np.eye(48, dtype=bool)).any()
    # the reference builds its own from the benchmark's copy of the code
    assert np.array_equal(m, R.mask())


def test_the_syndrome():
    h = parity_check()
    bits = np.random.RandomState(5).randint(0, 2, (7, 96))
    got = syndrome(torch.as_tensor(bits, dtype=torch.float32),
                   torch.as_tensor(h, dtype=torch.float32))
    assert np.array_equal(got.numpy(), (bits @ h.T) % 2)
    # every encoded word is a codeword of it
    cw = words(n=64)["label"]
    assert not syndrome(torch.as_tensor(cw, dtype=torch.float32),
                        torch.as_tensor(h, dtype=torch.float32)).any()


def sdpa_attention(q, k, v, mask):
    """torch's attention with the mask broadcast as the card's route
    passes it, on the back end torch picks here."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def qkv(seed=0, d=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, 8, 144, d, generator=g) for _ in range(3)]


@pytest.mark.parametrize("route", [plain_attention, sdpa_attention])
def test_a_masked_key_leaves_the_output_bits(route):
    mask = torch.as_tensor(code_mask(parity_check()))
    q, k, v = qkv()
    out = route(q, k, v, mask)
    j = 120  # a check token: seven queries attend to it
    k2, v2 = k.clone(), v.clone()
    k2[..., j, :] += 50.0
    v2[..., j, :] -= 50.0
    out2 = route(q, k2, v2, mask)
    blind = ~mask[:, j]
    assert blind.sum() == 144 - 7
    assert torch.equal(out[..., blind, :], out2[..., blind, :])
    assert not torch.equal(out[..., ~blind, :], out2[..., ~blind, :])


def test_plain_route_against_torch_attention():
    mask = torch.as_tensor(code_mask(parity_check()))
    q, k, v = qkv(1)
    fused_mp.reset_counts()
    out = code_attention(q, k, v, mask)
    assert fused_mp.CODE_ATTENTION_COUNTS == {"kernel_launches": 0,
                                             "bwd_launches": 0,
                                             "plain_calls": 1}
    assert torch.equal(out, plain_attention(q, k, v, mask))
    # f32 round-off of two summation orders
    assert rel(out, sdpa_attention(q, k, v, mask)) < 1e-6
    assert rel(out, sdpa_attention(q, k, v, torch.ones_like(mask))) > 0.1
    with pytest.raises(ValueError):
        code_attention(q, k, v, mask.float())


def table_rows(table, L: int) -> dict:
    """{row: its allowed columns, ascending} of a packed table of L rows
    (``code_attention.packed_table``)."""
    t = np.asarray(table)
    order, count = t[:L], t[L:2 * L]
    key = t[2 * L:].reshape(-1, L)
    return {int(i): key[:c, s] for s, (i, c) in enumerate(zip(order, count))}


def check_tables(mask: np.ndarray):
    """The tables of ``mask`` give back the mask and its transpose, each
    row's columns ascending, the rows longest first, -1 past a row's
    length."""
    t = CodeTables(torch.as_tensor(mask))
    L = mask.shape[0]
    assert t.tokens == L and t.pairs == mask.sum()
    assert dict(t.state_dict()) == {}
    for table, m in ((t.rows, mask), (t.cols, mask.T)):
        assert table.dtype == torch.int32
        width = int(m.sum(1).max())
        assert table.numel() == (2 + width) * L
        order, count = table[:L].numpy(), table[L:2 * L].numpy()
        assert sorted(order) == list(range(L))
        assert np.array_equal(count, m.sum(1)[order])
        assert (np.diff(count) <= 0).all()
        key = table[2 * L:].numpy().reshape(width, L)
        assert ((key >= 0) == (np.arange(width)[:, None] < count)).all()
        back = np.zeros_like(m)
        for i, cols in table_rows(table, L).items():
            assert (np.diff(cols) > 0).all()
            back[i, cols] = True
        assert np.array_equal(back, m)
    return t


def test_the_tables_reproduce_the_code_mask():
    mask = code_mask(parity_check())
    t = check_tables(mask)
    rows = table_rows(t.rows, 144)
    assert sum(len(c) for c in rows.values()) == 2198
    assert {len(rows[i]) for i in range(96)} == {19, 20, 25, 26, 27}
    assert {len(rows[i]) for i in range(96, 144)} == {7, 8}
    # the bits, longest first, before every check
    assert set(t.rows[:96].tolist()) == set(range(96))
    # the model keeps them beside its mask, out of its state dict
    model = T.new_model(CFG["dims"], CFG["layers"], CFG["heads"])
    assert torch.equal(model.tables.rows, t.rows)
    assert torch.equal(model.tables.cols, t.cols)
    assert not any(k.startswith("tables") for k in model.state_dict())


def test_the_tables_of_a_non_symmetric_mask():
    rng = np.random.RandomState(7)
    mask = rng.rand(37, 37) < 0.2
    mask[np.arange(37), rng.randint(0, 37, 37)] = True  # no empty row
    mask[:, 5] = False  # a key no query attends to: an empty column
    assert not (mask == mask.T).all()
    t = check_tables(mask)
    assert len(table_rows(t.cols, 37)[5]) == 0


def test_an_empty_row_raises():
    mask = code_mask(parity_check())
    mask[100] = False
    with pytest.raises(ValueError, match="allow no key"):
        CodeTables(mask)
    q, k, v = qkv()
    with pytest.raises(ValueError, match="allows no key"):
        code_attention(q, k, v, torch.as_tensor(mask))
    with pytest.raises(ValueError, match="square bool"):
        CodeTables(mask[:, :100])


def table_attention(q, k, v, tables):
    """The forward over the row table: each query's allowed keys gathered,
    then the softmax and the weighted sum of v; and the log-sum-exp."""
    L, scale = q.shape[-2], q.shape[-1] ** -0.5
    rows = table_rows(tables.rows, L)
    out = torch.empty_like(q)
    lse = q.new_empty(q.shape[:3])
    for i, keys in rows.items():
        keys = torch.as_tensor(keys, dtype=torch.long)
        s = (q[..., i:i + 1, :] * k[..., keys, :]).sum(-1) * scale
        out[..., i, :] = (torch.softmax(s, -1)[..., None]
                          * v[..., keys, :]).sum(-2)
        lse[..., i] = torch.logsumexp(s, -1)
    return out, lse


def table_grads(q, k, v, out, lse, dout, tables):
    """The backward kernel's recurrences in PyTorch ops: dq over the row
    table, dk and dv over the column table, p and ds recomputed from the
    log-sum-exp and D = rowsum(dO * O)."""
    L, scale = q.shape[-2], q.shape[-1] ** -0.5
    D = (dout * out).sum(-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    for i, keys in table_rows(tables.rows, L).items():
        keys = torch.as_tensor(keys, dtype=torch.long)
        p = torch.exp((q[..., i:i + 1, :] * k[..., keys, :]).sum(-1) * scale
                      - lse[..., i:i + 1])
        dp = (dout[..., i:i + 1, :] * v[..., keys, :]).sum(-1)
        ds = p * (dp - D[..., i:i + 1])
        dq[..., i, :] = scale * (ds[..., None] * k[..., keys, :]).sum(-2)
    for j, queries in table_rows(tables.cols, L).items():
        qs = torch.as_tensor(queries, dtype=torch.long)
        p = torch.exp((q[..., qs, :] * k[..., j:j + 1, :]).sum(-1) * scale
                      - lse[..., qs])
        dp = (dout[..., qs, :] * v[..., j:j + 1, :]).sum(-1)
        ds = p * (dp - D[..., qs])
        dk[..., j, :] = scale * (ds[..., None] * q[..., qs, :]).sum(-2)
        dv[..., j, :] = (p[..., None] * dout[..., qs, :]).sum(-2)
    return dq, dk, dv


def test_table_attention_equals_the_plain_route():
    mask = torch.as_tensor(code_mask(parity_check()))
    tables = CodeTables(mask)
    q, k, v = qkv(2)
    out, lse = table_attention(q, k, v, tables)
    assert rel(out, plain_attention(q, k, v, mask)) < 1e-6
    scores = torch.matmul(q, k.transpose(-2, -1)) * 0.5
    assert rel(lse, torch.logsumexp(scores.masked_fill(~mask, -math.inf),
                                    -1)) < 1e-6


@pytest.mark.parametrize("symmetric", [True, False])
def test_the_backward_recurrences_over_the_tables(symmetric):
    """In f64 the recurrences give autograd's gradients of the plain route
    to round-off, on the code's mask and on a non-symmetric one."""
    if symmetric:
        mask = code_mask(parity_check())
    else:
        rng = np.random.RandomState(3)
        mask = rng.rand(144, 144) < 0.1
        mask[np.arange(144), rng.randint(0, 144, 144)] = True
        mask[:, 9] = False
    mask = torch.as_tensor(mask)
    tables = CodeTables(mask)
    q, k, v = (t.double().requires_grad_(True) for t in qkv(4, d=8))
    dout = torch.randn(q.shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(5))
    want = plain_attention(q, k, v, mask)
    grads = torch.autograd.grad(want, (q, k, v), dout)
    with torch.no_grad():
        out, lse = table_attention(q, k, v, tables)
        got = table_grads(q, k, v, out, lse, dout, tables)
    assert rel(out, want) < 1e-12
    for a, b in zip(got, grads):
        assert rel(a, b) < 1e-12


def test_train_step_spans_counters_and_decisions(setup):
    _, model, P, batch, _ = setup
    model = T.new_model(CFG["dims"], CFG["layers"], CFG["heads"])
    model.load_state_dict({k: v.clone() for k, v in P.items()})
    opt = make_optimizer(model.parameters(), T.BASE_LR, weight_decay=0.0)
    fused_mp.reset_counts()
    with record_spans() as spans:
        m = T.train_step(model, opt, batch, "cpu")
    assert set(m) == {"loss", "acc"} and m["loss"].ndim == 0
    names = [s.name for s in spans]
    assert names.count("attention") == CFG["layers"]
    top = [s.name for s in spans if s.parent == 0]
    assert top == ["stage", "forward", "loss", "backward", "optimizer",
                   "metrics"]
    forward = names.index("forward")
    assert all(spans[spans[i].parent].name == "forward"
               for i, n in enumerate(names) if n == "attention")
    assert forward < names.index("attention")
    assert fused_mp.CODE_ATTENTION_COUNTS == {
        "kernel_launches": 0, "bwd_launches": 0, "plain_calls": CFG["layers"]}
    dec = T.decode_step(model, batch, "cpu")
    y = T.stage_batch(batch, "cpu")["y"]
    with torch.no_grad():
        flip = model(y) > 0
    assert torch.equal(dec, ((y > 0) ^ flip).to(torch.int32))


def test_the_cosine_schedule():
    f = Schedules.cosine(10, 5e-3)
    assert f(0) == 1.0 and f(10) == pytest.approx(5e-3)
    assert f(5) == pytest.approx((1 + 5e-3) / 2)
    assert f(20) == f(10)
    assert math.isclose(f(3), 5e-3 + (1 - 5e-3) * (1 + math.cos(0.3 * math.pi))
                        / 2)


def test_the_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    common = ["--device", "cpu", "--batch-size", "4", "--eval-words", "8"]
    T.main(["--train", "--n-epochs", "1", "--steps-per-epoch", "2",
            "--work-dir", str(tmp_path)] + common)
    (run,) = glob.glob(str(tmp_path / "ecct_at_*"))
    ckpt = f"{run}/ecct_latest.ckpt"
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 1 and payload["gcnt"] == 2
    T.main(["--train", "--n-epochs", "2", "--steps-per-epoch", "2",
            "--work-dir", str(tmp_path / "b"), "--model-path", ckpt]
           + common)
    (run2,) = glob.glob(str(tmp_path / "b" / "ecct_at_*"))
    assert torch.load(f"{run2}/ecct_final.ckpt",
                      weights_only=True)["gcnt"] == 4
    capsys.readouterr()
    T.main(["--model-path", f"{run2}/ecct_final.ckpt"] + common)
    rows = [line.split() for line in capsys.readouterr().out.splitlines()
            if line[:1].isdigit() and len(line.split()) == 3]
    assert [int(r[0]) for r in rows] == list(T.EVAL_SNRS)
    assert all(0.0 <= float(x) <= 1.0 for r in rows for x in r[1:])
