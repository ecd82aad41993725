"""The port's bf16 compute policy against the JAX package's, on the CPU.

Kernel level: the plain versions' bf16 mode (the port's CPU path, and the
reference its CUDA kernels are held to on the card) against the Pallas
kernels' bf16 mode, ``fgnn_tpu.ops.fused_mp._fused`` with
``mm_dtype_name="bfloat16"`` in interpret mode, through ``jax.vjp``, on
the layouts ``fused_typed_mp`` builds, in both extension modes and with all
four aggregators.  Both round at the same places and sum in f32 in other
orders, so:

* out lies within one bf16 ulp of the JAX value, element by element (a
  different f32 sum may put a value on the other side of a rounding
  boundary), plus 1e-5 of the largest value (a message that cancels to
  near zero has an ulp finer than the f32 sums' rounding);
* max's argmax is equal wherever the top two messages differ by more than
  the bf16 resolution (2^-8 of the top one);
* dh and d_etype lie within GRAD_REL_L2 (relative L2) of the JAX values,
  and the DIFF/NEIGHBOR softmax d_etype within EXT_SOFTMAX_DET_REL_L2: the
  TPU kernel rounds the gathered row sum hg to bf16 where it stores it for
  softmax (``hg_all``, a VMEM tiling choice), and the port keeps it f32,
  so each product dm * hg differs by up to a bf16 rounding before the sum
  over channels.

Conv, model and train-step level: the same flax variables go into both
packages, each run under its own policy (the JAX ``compute_dtype`` and the
port's).  On the CPU the JAX package runs its XLA conv, which keeps h and
out in f32 under the bf16 policy, and its kernels in interpret mode compute
in f32; on a TPU its convs run the kernels' bf16 mode, whose out is bf16,
so the dtypes downstream differ too.  So ``jax_kernel_conv`` puts the TPU's
conv in: a bf16 x goes through ``_fused`` in its bf16 mode on the layouts
of ``fused_typed_mp`` (interpret mode), as on the chip; an f32 x keeps the
JAX package's f32 conv, as the port keeps f32 under the f32 policy (the TPU
would round h to bf16 there too).  First the dtype of x at every conv must
be the same in both packages, so the port takes the bf16 kernel mode
exactly where the TPU kernel does.  Then each package's bf16 result is
measured against its own f32 result, and the port's error must be within
twice the JAX package's plus a floor (``_held``).  The two sum in other
orders and PyTorch rounds each bf16 op where XLA fuses some, so a
bit-for-bit comparison means nothing; the rule catches a port that rounds
where it should not, or fails to round where it should.  Dense and
BatchNorm round where XLA does (each op's result in bf16).
"""

import os
from argparse import Namespace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fgnn_tpu import models as jm
from fgnn_tpu.data import ContinuousCodesSP
from fgnn_tpu.data import batches as j_batches
from fgnn_tpu.models import mp_conv as j_mp_conv
from fgnn_tpu.models import policy as j_policy
from fgnn_tpu.ops import fused_mp as j_fused
from fgnn_tpu.ops.typed_mp import Extension as JExtension
from fgnn_tpu.ops.typed_mp import _concrete_idx
from fgnn_tpu.train import ldpc as j_ldpc
from fgnn_tpu.train import synthetic as j_syn
from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models import mp_conv as t_mp_conv
from fgnn_tpu_torch.models import policy as t_policy
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.typed_mp import Extension, GatherTable
from fgnn_tpu_torch.train import common as t_common
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train import synthetic as t_syn
from test_torch_syn_models import _seeded_variables

AGGS = ("max", "sum", "mean", "softmax")
GRAD_REL_L2 = 4e-3
EXT_SOFTMAX_DET_REL_L2 = 1e-2
# the floor of the twice-plus-floor rule (module docstring): half a bf16
# ulp (2^-9) of relative L2 error; a loss computed from bf16 logits is
# itself a bf16 value (the synthetic trainers' cross-entropy), so a loss
# may differ by one bf16 ulp more (2^-7 of its value, at most)
FLOOR = 2.0 ** -9
LOSS_FLOOR = 2.0 ** -7 + FLOOR
# gradients at most this share of the model's largest are zero in exact
# arithmetic (a bias right before a norm): rounding noise in either
# package, left out of the gradient vector
NOISE_REL = 1e-4
# the LDPC train steps' model and batch: two layers (a gather conv each
# way per layer, 16 -> 32 -> 16), which keeps the compile of the JAX step
# with its interpret-mode kernels short; at B=4 the global factor's
# BatchNorm normalises 4 values per channel, and bf16 rounding there moves
# the gradient by several times its size in both packages
LDPC_TRAIN = dict(dim_mapping_list=(16, 32, 16), skip_link={})
LDPC_TRAIN_B = 16
SMALL_LDPC = dict(dim_mapping_list=(16, 16, 32, 160, 32), skip_link={3: 1})
HOP_ARGS = dict(chain_length=12, hop_cap=3, hop_order=5, seed=2,
                model_name="mp_nn_factor", neighbour=8,
                dims=(8, 8, 72, 8, 2))


@pytest.fixture(autouse=True)
def _restore_policies():
    """Both packages' policies are process globals: every test leaves them
    as it found them."""
    j_prev, t_prev = j_policy.get_compute_dtype(), \
        t_policy.get_compute_dtype()
    yield
    j_policy.set_compute_dtype(j_prev)
    t_policy.set_compute_dtype(t_prev)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(
        tree.unfreeze() if hasattr(tree, "unfreeze") else tree))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _held(port_err, jax_err, what, floor=FLOOR):
    assert port_err <= 2 * jax_err + floor, (
        f"{what}: the port's bf16 error {port_err:.3e} exceeds twice the "
        f"JAX package's {jax_err:.3e} plus {floor:.3e}")


# --------------------------------------------------------------------------
# kernel level: the plain versions against the Pallas kernels' bf16 mode


def _bf16_values(a):
    """``a`` rounded to bf16, as f32 numpy."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _onehot(nn, ext):
    Nd, K = nn.shape
    if not ext:
        n_src = int(nn.max()) + 1
        oh = np.zeros((K * Nd, n_src), np.float32)
        oh[np.arange(K * Nd), nn.T.reshape(-1)] = 1.0
        return oh
    oh = np.zeros((K * Nd, 2 * Nd), np.float32)
    oh[np.arange(K * Nd), np.tile(np.arange(Nd), K)] = 1.0
    oh[np.arange(K * Nd), Nd + nn.T.reshape(-1)] += 1.0
    return oh


def _pallas_bf16(h, nn, et, agg, ext, g):
    """out, argmax, dh, d_etype of the Pallas kernels' bf16 mode (interpret
    mode) on the port's layouts: h (B, R N, T, C) with bf16 values
    (interleaved rows for the extensions), nn (Nd, K), et (B, Nd, K, T),
    the cotangent g (B, Nd, C) with bf16 values."""
    B, RN, T, C = h.shape
    Nd, K = nn.shape
    hs = (np.concatenate([h[:, 0::2], h[:, 1::2]], axis=1) if ext else h)
    h5 = jnp.asarray(np.transpose(hs, (2, 1, 0, 3)).reshape(T, RN, B * C),
                     jnp.bfloat16)
    et3 = jnp.asarray(np.transpose(et, (3, 0, 2, 1)).reshape(T, B, K * Nd))
    oh = _onehot(nn, ext)
    assert oh.shape[1] == RN
    oh, oht = (jnp.asarray(a, jnp.bfloat16) for a in (oh, oh.T.copy()))
    args = (C, agg, 3.0, "bfloat16", Nd, K, B, B)
    out, amax = j_fused._fused_fwd_impl(h5, et3, oh, oht, *args, "bfloat16")
    _, vjp = jax.vjp(lambda a, b: j_fused._fused(a, b, oh, oht, *args,
                                                 "bfloat16"), h5, et3)
    g2 = jnp.asarray(np.transpose(g, (1, 0, 2)).reshape(Nd, B * C),
                     jnp.bfloat16)
    dh5, det3 = vjp(g2)
    assert dh5.dtype == jnp.bfloat16 and det3.dtype == jnp.float32

    def back(a):
        return np.transpose(np.asarray(a, np.float32).reshape(Nd, B, C),
                            (1, 0, 2))

    dh = np.transpose(np.asarray(dh5, np.float32).reshape(T, RN, B, C),
                      (2, 1, 0, 3))
    if ext:
        dh = np.stack([dh[:, :Nd], dh[:, Nd:]], axis=2).reshape(B, RN, T, C)
    det = np.transpose(np.asarray(det3).reshape(T, B, K, Nd), (1, 3, 2, 0))
    return back(out), back(amax), dh, det


def _ulp_bf16(v):
    """The bf16 ulp at each value of ``v`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -120)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_plain_bf16_mode_matches_pallas(ext, agg):
    rng = np.random.RandomState(7)
    B, N, K, T, C = (3, 10, 9, 16, 8) if ext else (3, 12, 3, 4, 16)
    Nd = N if ext else 8
    nn = rng.randint(0, N, (Nd, K)).astype(np.int32)
    nn[0, 0] = N - 1  # every source row exists in the one-hot operator
    h = _bf16_values(rng.randn(B, 2 * N if ext else N, T, C)
                     .astype(np.float32))
    et = rng.randn(B, Nd, K, T).astype(np.float32)
    g = _bf16_values(rng.randn(B, Nd, C).astype(np.float32))
    ref_out, ref_am, ref_dh, ref_det = _pallas_bf16(h, nn, et, agg, ext, g)

    th = torch.from_numpy(h).to(torch.bfloat16)
    tnn, tet = torch.from_numpy(nn), torch.from_numpy(et)
    res = fused_mp.typed_gather_mix_agg(
        th, tnn, tet, agg, 3.0, want_argmax=agg == "max", ext=ext,
        want_lse=agg == "softmax")
    out, saved = res if agg in ("max", "softmax") else (res, None)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert (np.abs(got - ref_out) <= _ulp_bf16(ref_out)
            + 1e-5 * np.abs(ref_out).max()).all(), np.abs(got - ref_out).max()
    if agg == "max":
        hg = h[:, 0::2, None] + h[:, 1::2][:, nn] if ext else h[:, nn]
        msgs = np.einsum("bdktc,bdkt->bdkc", hg, _bf16_values(et))
        top2 = np.sort(msgs, axis=2)[:, :, -2:]
        clear = (top2[:, :, 1] - top2[:, :, 0]) > 2.0 ** -8 * np.abs(
            top2[:, :, 1])
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(saved.numpy()[clear], ref_am[clear])
    if agg == "softmax":
        assert saved.dtype == torch.float32
    table = GatherTable(nn, N)
    ptr, edge = ((table.ext_ptr, table.ext_edge) if ext
                 else (table.src_ptr, table.src_edge))
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        torch.from_numpy(g).to(torch.bfloat16), th, tnn, ptr, edge, tet,
        agg, 3.0, argmax=saved if agg == "max" else None,
        out=saved if agg == "softmax" else None, ext=ext)
    assert dh.dtype == torch.bfloat16 and det.dtype == torch.float32
    assert _rel(dh.float().numpy(), ref_dh) <= GRAD_REL_L2
    det_tol = (EXT_SOFTMAX_DET_REL_L2 if ext and agg == "softmax"
               else GRAD_REL_L2)
    assert _rel(det.numpy(), ref_det) <= det_tol


def test_bf16_plain_rounds_where_the_contract_says():
    """dh is one rounding of an f32 sum of bf16-rounded products, and the
    f32 mode keeps its bits: the plain versions of a bf16 h equal a hand
    computation, and an f32 h gives what it gave before (no rounding)."""
    rng = np.random.RandomState(3)
    B, N, Nd, K, T, C = 2, 5, 4, 3, 2, 4
    h = torch.from_numpy(rng.randn(B, N, T, C).astype(np.float32))
    nn = torch.from_numpy(rng.randint(0, N, (Nd, K)).astype(np.int32))
    et = torch.from_numpy(rng.randn(B, Nd, K, T).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, Nd, C).astype(np.float32))
    hb, gb = h.to(torch.bfloat16), g.to(torch.bfloat16)
    table = GatherTable(nn.numpy(), N)
    dh, det = fused_mp.typed_gather_mix_agg_bwd(
        gb, hb, nn, table.src_ptr, table.src_edge, et, "mean")
    dm = (gb.float() * (1.0 / K)).to(torch.bfloat16).float()
    etb = et.to(torch.bfloat16).float()
    want = torch.zeros(B, N, T, C)
    for d in range(Nd):
        for k in range(K):
            want[:, nn[d, k]] += (dm[:, d, None, :] * etb[:, d, k, :, None]
                                  ).to(torch.bfloat16).float()
    assert torch.equal(dh, want.to(torch.bfloat16))
    hg = hb.float()[:, nn.long()]
    want_det = (dm[:, :, None, None, :] * hg).to(torch.bfloat16).float() \
        .sum(dim=-1)
    torch.testing.assert_close(det, want_det, rtol=1e-6, atol=1e-6)
    # the f32 mode: no rounding anywhere
    dh32, _ = fused_mp.typed_gather_mix_agg_bwd(
        g, h, nn, table.src_ptr, table.src_edge, et, "mean")
    want32 = torch.zeros(B, N, T, C).index_add_(
        1, nn.long().reshape(-1),
        ((g[:, :, None, :] * (1.0 / K)).expand(B, Nd, K, C)[:, :, :, None]
         * et[..., None]).reshape(B, Nd * K, T, C))
    assert torch.equal(dh32, want32)


def test_all_ties_argmax_is_zero_in_bf16():
    """Every message of a row ties exactly: the first-win argmax is 0 in
    the bf16 mode too, in both extension modes."""
    B, N, K, T, C = 2, 6, 9, 2, 8
    row = torch.randn(1, 1, T, C).to(torch.bfloat16)
    et = torch.ones(B, N, K, T)
    nn = torch.zeros(N, K, dtype=torch.int32)
    for ext in (False, True):
        h = row.expand(B, 2 * N if ext else N, T, C).contiguous()
        _, am = fused_mp.typed_gather_mix_agg(h, nn, et, "max",
                                              want_argmax=True, ext=ext)
        assert am.max().item() == 0


@pytest.mark.parametrize("esz", [4, 2])
def test_planners_count_bytes_by_element_size(esz):
    """The bf16 slab of h takes half the bytes; the row padding keeps 16
    bytes below a 128-byte row of one type; the rest is unchanged."""
    rows, Nd, K, T = 120, 60, 9, 16
    for cs in (2, 4, 8, 16, 32, 64):
        row = fused_mp._row_stride(T, cs, esz)
        assert row == T * cs + (16 // esz if cs * esz < 128 else 0)
        frow = fused_mp._fwd_row_stride(T, cs, esz)
        assert frow >= T * cs and (cs % 4 or frow * esz % 16 == cs * esz % 16)
        assert fused_mp.fwd_bytes(rows, Nd, K, T, cs, esz) == (
            -(-rows * frow * esz // 16) * 16 + 4 * -(-Nd * K // 4) * 4)
    f32 = fused_mp.staged_bytes(rows, Nd, K, T, 64, "max")
    assert fused_mp.staged_bytes(rows, Nd, K, T, 64, "max", 4) == f32
    b16 = fused_mp.staged_bytes(rows, Nd, K, T, 64, "max", 2)
    # h halves (128-byte rows of one type: no padding either way) and g
    # halves; etype, argmax and the tables do not change
    assert f32 - b16 == 2 * rows * T * 64 + 2 * Nd * 64
    assert fused_mp.bwd_slab(32, rows, Nd, K, T, 64, "max", esz) > 0


def test_kept_backward_refuses_bf16():
    """On the card the kept backward route takes f32 only: asked for with
    a bf16 h, the wrapper raises before any launch (the check runs before
    the device is touched only for CUDA tensors, so a meta tensor stands
    in here)."""
    B, N, Nd, K, T, C = 2, 5, 3, 2, 4, 8
    h = torch.empty(B, N, T, C, dtype=torch.bfloat16, device="meta")
    with pytest.raises((TypeError, ValueError)):
        fused_mp.typed_gather_mix_agg_bwd(
            torch.empty(B, Nd, C, dtype=torch.bfloat16, device="meta"), h,
            torch.zeros(Nd, K, dtype=torch.int32, device="meta"),
            torch.zeros(N + 1, dtype=torch.int32, device="meta"),
            torch.zeros(Nd * K, dtype=torch.int32, device="meta"),
            torch.empty(B, Nd, K, T, device="meta"), "sum", slab=0)


def test_kernel_predicates_take_bf16():
    B, N, Nd, K, T, C = 2, 5, 3, 2, 4, 8
    h = torch.zeros(B, N, T, C, dtype=torch.bfloat16)
    nn = torch.zeros(Nd, K, dtype=torch.int32)
    et = torch.zeros(B, Nd, K, T)
    table = GatherTable(nn.numpy(), N)
    fused_mp.check_kernel_args(h, nn, et, "max", True)
    kw = dict(g=torch.zeros(B, Nd, C, dtype=torch.bfloat16), h=h,
              nn_idx=nn, src_ptr=table.src_ptr, src_edge=table.src_edge,
              etype=et, argmax=torch.zeros(B, Nd, C, dtype=torch.uint8),
              out=torch.zeros(B, Nd, C))
    fused_mp.check_bwd_args(aggregator="softmax", **kw)
    with pytest.raises(ValueError, match="g must be"):
        fused_mp.check_bwd_args(aggregator="max",
                                **{**kw, "g": torch.zeros(B, Nd, C)})
    with pytest.raises(TypeError):
        fused_mp.check_kernel_args(h, nn, et.to(torch.bfloat16), "max",
                                   False)
    with pytest.raises(TypeError):
        fused_mp.check_kernel_args(h.half(), nn, et, "max", False)


# --------------------------------------------------------------------------
# conv and model level


def _kernel_conv(x, nn_idx, etype, filters, nout, *,
                 extension=JExtension.NO_EXTENSION, aggregator="softmax",
                 gamma=3.0, bias=None, precision=None,
                 _xla=j_mp_conv.typed_mp_conv):
    """The JAX package's conv as its TPU runs it under the bf16 policy (the
    module docstring): ``fused_typed_mp``'s layout transforms around
    ``_fused`` with ``mm_dtype_name="bfloat16"``, out in x's dtype, for a
    bf16 x on a gather table; the JAX conv otherwise (f32, and the exact
    shortcuts of a broadcast or identity table, and a table that is not a
    trace-time constant, which the JAX package's kernel does not take
    either)."""
    idx = _concrete_idx(nn_idx)
    B, N, cin = x.shape
    trivial = idx is None or extension == JExtension.NO_EXTENSION and (
        N == 1 or (idx.size == N and np.array_equal(idx.ravel(),
                                                    np.arange(N))))
    if x.dtype != jnp.bfloat16 or trivial:
        return _xla(x, nn_idx, etype, filters, nout, extension=extension,
                    aggregator=aggregator, gamma=gamma, bias=bias)
    Nd, K = idx.shape
    T, C = etype.shape[-1], nout
    ext = extension != JExtension.NO_EXTENSION
    n_eff = 2 * N if ext else N

    def tmajor(w):
        return jnp.transpose(w.reshape(cin, C, T), (0, 2, 1)).reshape(
            cin, T * C)

    xf = x.astype(jnp.float32)
    if not ext:
        h = jnp.matmul(xf, tmajor(filters)).astype(jnp.bfloat16)
    else:
        w_self, w_nbr = filters[:cin], filters[cin:]
        if extension == JExtension.ORIG_WITH_DIFF:
            wa, sign = tmajor(w_self + w_nbr), -1.0
        else:
            wa, sign = tmajor(w_self), 1.0
        h = jnp.concatenate([
            jnp.matmul(xf, wa).astype(jnp.bfloat16),
            (sign * jnp.matmul(xf, tmajor(w_nbr))).astype(jnp.bfloat16)],
            axis=1)
    h5 = jnp.transpose(h.reshape(B, n_eff, T, C), (2, 1, 0, 3)).reshape(
        T, n_eff, B * C)
    et3 = jnp.transpose(etype.astype(jnp.float32), (3, 0, 2, 1)).reshape(
        T, B, K * Nd)
    oh = np.zeros((K * Nd, n_eff), np.float32)
    if not ext:
        oh[np.arange(K * Nd), idx.T.reshape(-1)] = 1.0
    else:
        oh[np.arange(K * Nd), np.tile(np.arange(Nd), K)] = 1.0
        oh[np.arange(K * Nd), N + idx.T.reshape(-1)] += 1.0
    out2 = j_fused._fused(
        h5, et3, jnp.asarray(oh, jnp.bfloat16),
        jnp.asarray(oh.T.copy(), jnp.bfloat16), C, aggregator, float(gamma),
        "bfloat16", Nd, K, B, B, "bfloat16")
    out = jnp.transpose(out2.reshape(Nd, B, C), (1, 0, 2))
    return out if bias is None else out + bias.astype(out.dtype)


@pytest.fixture
def jax_kernel_conv(monkeypatch):
    monkeypatch.setattr(j_mp_conv, "typed_mp_conv", _kernel_conv)


def _conv_dtypes(monkeypatch):
    """Record the dtype of x at every typed-mp conv of both packages."""
    seen = {"jax": [], "port": []}
    j_conv, t_conv = j_mp_conv.typed_mp_conv, t_mp_conv.typed_mp_conv

    def j_spy(x, *a, **kw):
        seen["jax"].append(str(x.dtype))
        return j_conv(x, *a, **kw)

    def t_spy(x, *a, **kw):
        seen["port"].append(str(x.dtype).replace("torch.", ""))
        return t_conv(x, *a, **kw)

    monkeypatch.setattr(j_mp_conv, "typed_mp_conv", j_spy)
    monkeypatch.setattr(t_mp_conv, "typed_mp_conv", t_spy)
    return seen


def _both(jax_fn, port_fn):
    """(JAX f32, JAX bf16, port f32, port bf16) results: each function run
    under its package's f32 policy and then its bf16 policy."""
    res = []
    for fn, ctx, bf16 in ((jax_fn, j_policy.compute_dtype, jnp.bfloat16),
                          (port_fn, t_policy.compute_dtype, torch.bfloat16)):
        for dtype in (None, bf16):
            with ctx(dtype):
                res.append([np.asarray(torch.as_tensor(np.asarray(
                    r, np.float32)) if not isinstance(r, torch.Tensor)
                    else r.detach().float(), np.float64) for r in fn()])
    return res


def _errors(res, what):
    jf, jb, tf, tb = res
    for i, (a, b, c, d) in enumerate(zip(jf, jb, tf, tb)):
        # the f32 results agree across packages
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} [{i}] f32")
        _held(_rel(d, c), _rel(b, a), f"{what} [{i}]")
        assert np.isfinite(d).all()


@pytest.mark.parametrize("ext,agg", [("none", "max"), ("diff", "max"),
                                     ("neighbor", "softmax"),
                                     ("diff", "sum")])
def test_mp_conv_bf16_matches_jax(jax_kernel_conv, ext, agg):
    """MPConv on a bf16 x (the input a conv gets under the policy) and on
    its f32 values, in both packages, the same flax variables."""
    rng = np.random.RandomState(11)
    B, N, cin, C, K, T = 4, 12, 16, 8, 3, 4
    nn = rng.randint(0, N, (N, K)).astype(np.int32)
    x = _bf16_values(rng.randn(B, N, cin).astype(np.float32))
    et = rng.randn(B, N, K, T).astype(np.float32)
    jext = {"none": JExtension.NO_EXTENSION,
            "diff": JExtension.ORIG_WITH_DIFF,
            "neighbor": JExtension.ORIG_WITH_NEIGHBOR}[ext]
    text = {"none": Extension.NO_EXTENSION,
            "diff": Extension.ORIG_WITH_DIFF,
            "neighbor": Extension.ORIG_WITH_NEIGHBOR}[ext]
    jmod = jm.MPConv(C, T, extension=jext, aggregator=agg)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   nn, jnp.asarray(et)))
    # filters at a trained model's scale (the init's U(+-0.01) leaves the
    # pre-BatchNorm activations nearly constant)
    variables["params"]["filters"] = rng.uniform(
        -0.3, 0.3, variables["params"]["filters"].shape).astype(np.float32)
    port = tm.load_flax_variables(tm.MPConv(cin, C, T, extension=text,
                                            aggregator=agg), variables)
    table = GatherTable(nn, N)

    def jax_fn():
        dt = j_policy.get_compute_dtype() or jnp.float32
        y, _ = jmod.apply(variables, jnp.asarray(x, dt), nn,
                          jnp.asarray(et, dt), mutable=["batch_stats"])
        return [y]

    def port_fn():
        dt = t_policy.get_compute_dtype() or torch.float32
        return [port(torch.from_numpy(x).to(dt), table,
                     torch.from_numpy(et).to(dt))]

    _errors(_both(jax_fn, port_fn), f"MPConv {ext} {agg}")


def _ldpc_setup(B=4, config=SMALL_LDPC):
    batches = list(ContinuousCodesSP(length=4 * B, seed=1).batches(B))
    model = jm.LDPCModel(**config)
    state, tx = j_ldpc.create_state(model, batches[0], seed=0, base_lr=1e-2)
    variables = {"params": _np_tree(state.params),
                 "batch_stats": _np_tree(state.batch_stats)}
    return batches, model, state, tx, variables


def test_ldpc_model_bf16_matches_jax(jax_kernel_conv, monkeypatch):
    batches, model, _, _, variables = _ldpc_setup()
    port = tm.load_flax_variables(tm.LDPCModel(**SMALL_LDPC), variables)
    batch = batches[1]
    inputs = j_ldpc._model_inputs(batch)
    seen = _conv_dtypes(monkeypatch)

    def jax_fn():
        floats, tables = _split(inputs)
        (logits, sb), _ = jax.jit(partial(
            model.apply, train=True, mutable=["batch_stats"], **tables))(
            variables, **floats)
        return [logits, sb]

    def port_fn():
        port.train()
        return list(port(**t_ldpc.model_inputs(port, batch, "cpu")))

    res = _both(jax_fn, port_fn)
    # every conv, in call order, under each policy: 4 layers x 2 directions
    # x 2 factor types
    assert len(seen["jax"]) == len(seen["port"]) == 2 * 16
    assert seen["port"] == seen["jax"]
    assert seen["port"][16:].count("bfloat16") > 8
    _errors(res, "LDPCModel")


def _hop_setup(B=8):
    args = Namespace(**HOP_ARGS, batch_size=B)
    jwl = j_syn.SynWorkload("hop", args)
    batches = list(j_batches(jwl.dataset, B, 4))
    variables = _seeded_variables(jwl, jwl.model_inputs(batches[0]), 0)
    return args, jwl, batches, variables


def test_hop_model_bf16_matches_jax(jax_kernel_conv, monkeypatch):
    args, jwl, batches, variables = _hop_setup()
    twl = t_syn.SynWorkload("hop", args)
    tm.load_flax_variables(twl.model, variables)
    inputs = jwl.model_inputs(batches[1])
    seen = _conv_dtypes(monkeypatch)

    def jax_fn():
        floats, tables = _split(inputs)
        logits, _ = jax.jit(partial(
            jwl.model.apply, train=True, mutable=["batch_stats"], **tables))(
            variables, **floats)
        return [logits]

    def port_fn():
        twl.model.train()
        return [twl.logits(twl.stage(batches[1], "cpu"))]

    res = _both(jax_fn, port_fn)
    assert len(seen["jax"]) == len(seen["port"]) == 2 * 4
    assert seen["port"] == seen["jax"]
    assert seen["port"][4:] == ["bfloat16"] * 4
    _errors(res, "SynHopFactorModel")


def _split(inputs):
    """(the float inputs, the integer tables): the tables stay trace-time
    constants, as the JAX trainers pass them, so that its kernel conv
    takes them."""
    tables = {k: v for k, v in inputs.items()
              if np.issubdtype(np.asarray(v).dtype, np.integer)}
    return {k: v for k, v in inputs.items() if k not in tables}, tables


def test_path_convs_take_the_bf16_mode_where_jax_does(jax_kernel_conv, monkeypatch):
    """At the reference widths, under the bf16 policy, x has the same dtype
    at every conv in both packages (the JAX side traced with
    ``jax.eval_shape``, which compiles nothing).  Of the 16 type-0 convs of
    an LDPC forward, 15 get a bf16 x; layer 6's v2f conv gets an f32 x,
    because the skip link from layer 2 adds the global-factor conv's f32
    shortcut output to the variables.  That conv runs the f32 mode, and
    autograd skips layer 7's v2f backward (it feeds no loss), so a train
    step launches 15 bf16 forwards and 14 bf16 backwards.  All 12 convs of
    a hop step get a bf16 x.  chip_smoke.py requires exactly these bf16
    launches on the card."""
    seen = _conv_dtypes(monkeypatch)
    B = 2
    batch = next(ContinuousCodesSP(length=B, seed=1).batches(B))
    jmodel = jm.LDPCModel()
    inputs, tables = _split(j_ldpc._model_inputs(batch))
    with j_policy.compute_dtype(jnp.bfloat16):
        variables = jax.eval_shape(partial(jmodel.init, train=False,
                                           **tables),
                                   jax.random.PRNGKey(0), **inputs)
        jax.eval_shape(partial(jmodel.apply, train=False, **tables),
                       variables, **inputs)
    port = tm.init_weights(tm.LDPCModel(), 0).eval()
    with t_policy.compute_dtype(torch.bfloat16), torch.inference_mode():
        fused_mp.reset_counts()
        port(**t_ldpc.model_inputs(port, batch, "cpu"))
    assert fused_mp.COUNTS["plain_calls"] == 16
    # per layer: f2v and v2f over the check tables (the kernel), then over
    # the global factor (shortcuts); flax's init traced the model once more
    assert seen["jax"][32:] == seen["port"] and len(seen["port"]) == 32
    kernel = [dt for i, dt in enumerate(seen["port"]) if i % 4 < 2]
    assert kernel == ["bfloat16"] * 13 + ["float32"] + ["bfloat16"] * 2

    seen["jax"].clear(), seen["port"].clear()
    args = t_syn.parse_args(["--seed", "0"], "hop")
    jwl = j_syn.SynWorkload("hop", args)
    data = next(j_batches(jwl.dataset, B, 1))
    inputs, tables = _split(jwl.model_inputs(data))
    with j_policy.compute_dtype(jnp.bfloat16):
        variables = jax.eval_shape(partial(jwl.model.init, train=False,
                                           **tables),
                                   jax.random.PRNGKey(0), **inputs)
        jax.eval_shape(partial(jwl.model.apply, train=False, **tables),
                       variables, **inputs)
    wl = t_syn.SynWorkload("hop", args)
    tm.init_weights(wl.model, 0)
    with t_policy.compute_dtype(torch.bfloat16), torch.inference_mode():
        fused_mp.reset_counts()
        wl.model.eval()
        wl.logits(wl.stage(data, "cpu"))
    assert fused_mp.EXT_COUNTS["plain_calls"] == 12
    assert seen["jax"][12:] == seen["port"] == ["bfloat16"] * 12


# --------------------------------------------------------------------------
# train steps


def _tap(tx, clip=None):
    """``tx`` behind a pass-through transform (after the clip, if any)
    that keeps each step's gradients as its state."""
    tap = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    return optax.chain(*([clip] if clip else []), tap, tx)


def _grads(model, from_values=False):
    """name -> f64 gradient of each parameter of ``model`` (zeros where
    it has none); with ``from_values``, the parameters' values instead."""
    return {n: (t.detach() if from_values else
                torch.zeros_like(t) if t.grad is None else t.grad)
            .numpy().astype(np.float64).ravel()
            for n, t in model.named_parameters()}


def _steps_held(what, jax_steps, port_model, load, port_step, j_state, n):
    """``n`` train steps of the JAX trainer in f32.  Before each, both
    packages run one step in f32 and in bf16 from the weights and running
    statistics the f32 trajectory reached; the loss and the whole gradient
    (one vector) of each bf16 step are held to the twice-plus-floor rule
    against its f32 step, the gradient without the tensors that are zero in
    exact arithmetic (NOISE_REL)."""
    for i in range(n):
        variables = {"params": _np_tree(j_state.params),
                     "batch_stats": _np_tree(j_state.batch_stats)}
        res = {}
        for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
            s, m = jax_steps[name](jax.tree.map(jnp.copy, j_state), i)
            grads = load({"params": _np_tree(s.opt_state[-2]
                                             if len(s.opt_state) == 3
                                             else s.opt_state[0]),
                          "batch_stats": variables["batch_stats"]})
            res[f"jax {name}"] = (float(m["loss"]),
                                  _grads(grads, from_values=True))
            if name == "f32":
                j_next = s
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            model = port_model(variables)
            with t_policy.compute_dtype(dtype):
                loss = port_step(model, i)
            for p in model.parameters():
                assert p.dtype == torch.float32
                assert p.grad is None or p.grad.dtype == torch.float32
            res[f"port {name}"] = (loss, _grads(model))
        (jl, jg), (jlb, jgb) = res["jax f32"], res["jax bf16"]
        (tl, tg), (tlb, tgb) = res["port f32"], res["port bf16"]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert np.isfinite(tlb)
        _held(abs(tlb - tl) / abs(tl), abs(jlb - jl) / abs(jl),
              f"{what} step {i}: loss", LOSS_FLOOR)
        top = max(np.abs(g).max() for g in jg.values())
        keep = sorted(k for k, g in jg.items()
                      if np.abs(g).max() > NOISE_REL * top)
        assert len(keep) > len(jg) // 2
        vec = {k: np.concatenate([d[n] for n in keep]) for k, d in (("jf", jg), ("jb", jgb), ("tf", tg), ("tb", tgb))}
        assert np.isfinite(vec["tb"]).all()
        _held(_rel(vec["tb"], vec["tf"]), _rel(vec["jb"], vec["jf"]),
              f"{what} step {i}: gradient")
        j_state = j_next


def test_three_ldpc_train_steps_bf16_match_jax(jax_kernel_conv):
    batches, model, state, tx, variables = _ldpc_setup(LDPC_TRAIN_B,
                                                       LDPC_TRAIN)
    tx = _tap(tx)
    state = state.replace(opt_state=tx.init(state.params))
    steps = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        with j_policy.compute_dtype(dtype):
            step = j_ldpc.make_train_step(model, tx)
            # trace under the policy: the first call compiles
            step(jax.tree.map(jnp.copy, state), batches[1])
        steps[name] = (lambda st, i, step=step: step(st, batches[1 + i]))

    def load(v):
        return tm.load_flax_variables(tm.LDPCModel(**LDPC_TRAIN), v)

    def port_step(model, i):
        opt = t_common.make_optimizer(model.parameters(), 1e-2)
        return float(t_ldpc.train_step(model, opt, batches[1 + i],
                                       "cpu")["loss"])

    _steps_held("LDPC", steps, load, load, port_step, state, 3)


def test_three_hop_train_steps_bf16_match_jax(jax_kernel_conv):
    args, jwl, batches, variables = _hop_setup()
    lr = 3e-3
    tx = _tap(optax.inject_hyperparams(optax.adam)(learning_rate=lr),
              clip=optax.clip_by_global_norm(1.0))
    state = j_syn.TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]),
                             gcnt=jnp.asarray(0, jnp.int32))
    steps = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        with j_policy.compute_dtype(dtype):
            step = j_syn.make_train_step(jwl, tx)
            step(jax.tree.map(jnp.copy, state), batches[1])
        steps[name] = (lambda st, i, step=step: step(st, batches[1 + i]))

    def load(v):
        return tm.load_flax_variables(t_syn.SynWorkload("hop", args).model,
                                      v)

    wl = t_syn.SynWorkload("hop", args)

    def port_step(model, i):
        wl.model = model
        opt = t_common.make_optimizer(model.parameters(), lr,
                                      weight_decay=0.0)
        return float(t_syn.train_step(wl, opt, batches[1 + i],
                                      "cpu")["loss"])

    _steps_held("hop", steps, load, load, port_step, state, 3)


# --------------------------------------------------------------------------
# the CLIs


def test_ldpc_decode_cli_bf16_on_the_cpu(tmp_path, capsys):
    fused_mp.reset_counts()
    t_ldpc.main(["--device", "cpu", "--bf16", "--batch-size", "10",
                 "--eval-per-cell", "1",
                 "--test-path", str(tmp_path / "eval.npz")])
    assert fused_mp.COUNTS["plain_calls"] == 3 * 16  # 3 batches of 10
    ber = float(capsys.readouterr().out.splitlines()[0])
    assert 0.0 <= ber <= 1.0
    assert t_policy.get_compute_dtype() is None


def test_ldpc_train_cli_bf16_on_the_cpu(tmp_path):
    t_ldpc.main(["--train", "--device", "cpu", "--bf16", "--n-epochs", "1",
                 "--steps-per-epoch", "2", "--batch-size", "2",
                 "--work-dir", str(tmp_path)])
    (run,) = os.listdir(tmp_path)
    ckpt = torch.load(os.path.join(tmp_path, run, "ldpc_final.ckpt"),
                      weights_only=True)
    assert ckpt["gcnt"] == 2
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in ckpt["model"].values())
    assert t_policy.get_compute_dtype() is None


def test_syn_hop_cli_bf16_on_the_cpu(tmp_path):
    acc, lp_acc = t_syn.main("hop", [
        "--device", "cpu", "--bf16", "--chain-length", "12", "--hop-order",
        "5", "--train-epoches", "1", "--train-size", "8", "--test-size",
        "4", "--batch-size", "4", "--seed", "1", "--work-dir",
        str(tmp_path)])
    assert 0.0 <= acc <= 1.0 and 0.0 <= lp_acc <= 1.0
    (run,) = os.listdir(tmp_path)
    ckpt = torch.load(os.path.join(tmp_path, run, "latest.ckpt"),
                      weights_only=True)
    assert ckpt["gcnt"] == 2
    assert all(v.dtype == torch.float32 for k, v in ckpt["model"].items()
               if not k.endswith("num_batches_tracked"))
