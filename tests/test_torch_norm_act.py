"""The norms' ``activation`` argument and the rule under which they take the
norm kernels (``ops/norm_act.py``), on the CPU.

* Every module that applies an activation right after a norm now passes
  it to the norm; its output, its running statistics and its gradients
  are bit-identical to the norm followed by the activation, as the
  modules composed them before, in training and in eval.
* The rule: only an eval BatchNorm or an instance norm without ``seg``, on
  an f32 contiguous card input for which no graph is recorded (neither
  for it nor for the BatchNorm's parameters), launches a kernel; the CPU,
  a recorded graph, bf16 or f64, ``seg``, a training BatchNorm and a
  non-contiguous input each run in plain PyTorch and count a plain call.
  The card is pretended here (``Tensor.is_cuda`` patched, the kernels'
  wrappers replaced by counters): the kernels themselves run in
  ``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fgnn_tpu_torch import models as tm
from fgnn_tpu_torch.models import norm as tnorm
from fgnn_tpu_torch.models.containers import IIDBlock
from fgnn_tpu_torch.models.factor_mpnn import _FinalMerge, _PointwiseFallback
from fgnn_tpu_torch.models.ldpc_model import SigmaBRegressor
from fgnn_tpu_torch.models.mp_conv import GConvResidual, MPConv, MPConvResidual
from fgnn_tpu_torch.ops import GatherTable, fused_mp, norm_act
from fgnn_tpu_torch.ops.segment import segment_bins
from fgnn_tpu_torch.ops.typed_mp import typed_mp_conv

B, N, K, T = 3, 10, 3, 2


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def _off_init(module, seed):
    """Seeded weights, and every BatchNorm's scale, shift and running
    statistics moved off their init."""
    tm.init_weights(module, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnorm.BatchNorm):
                C = m.weight.numel()
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.running_mean.copy_(torch.randn(C, generator=gen) * 0.3)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return module


def _graph(seed):
    rng = np.random.RandomState(seed)
    table = GatherTable(rng.randint(0, N, (N, K)), N)
    etype = torch.from_numpy(rng.randn(B, N, K, T).astype(np.float32))
    return table, etype


def _x(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


# each case: (module, inputs, the module's computation as it was composed
# before the norms took the activation)
def _mpconv():
    m = MPConv(6, 8, T)
    table, et = _graph(0)

    def before(m, x, table, et):
        y = typed_mp_conv(x, table, et, m.filters, m.nout,
                          extension=m.extension, aggregator=m.aggregator,
                          gamma=m.gamma, bias=m.bias)
        return torch.relu(m.bn(y))

    return m, (_x(1, B, N, 6), table, et), before


def _mpconv_residual():
    m = MPConvResidual(8, 4, T)
    table, et = _graph(2)

    def before(m, x, table, et):
        h = _leaky(m.bn1(m.conv1(x)))
        h = m.mp_conv(h, table, et)
        return _leaky(m.bn2(m.conv2(h))) + x

    return m, (_x(3, B, N, 8), table, et), before


def _gconv_residual():
    m = GConvResidual(8, 4, T)
    table, et = _graph(4)

    def before(m, x, table, et):
        h = torch.relu(m.bn1(m.conv1(x)))
        h = m.mp_conv(h, table, et)
        return torch.relu(m.bn2(m.conv2(h))) + x

    return m, (_x(5, B, N, 8), table, et), before


def _iid_map_bn():
    return (tm.IIDMapBN(5, 8), (_x(6, B, N, 5),),
            lambda m, x: torch.relu(m.bn(m.conv(x))))


def _iid_map_in():
    return (tm.IIDMapIN(5, 8), (_x(7, B, N, 5),),
            lambda m, x: torch.relu(tnorm.instance_norm(m.conv(x))))


def _iid_block():
    return (IIDBlock(5, 8), (_x(8, B, N, 5),),
            lambda m, x: torch.relu(m.bn(m.conv(x))))


def _pointwise():
    return (_PointwiseFallback(5, 8), (_x(9, B, N, 5),),
            lambda m, x: torch.relu(tnorm.instance_norm(m.conv(x))))


def _pointwise_seg():
    seg = segment_bins(np.array([0, 0, 1, 2, 1, -1, 2, 2, 0, -1]), 3)

    def before(m, x, seg):
        return torch.relu(tnorm.instance_norm(m.conv(x), seg=seg))

    return _PointwiseFallback(5, 8), (_x(10, 10, 5), seg), before


def _final_merge():
    def before(m, x):
        h = _leaky(m.bn(m.conv1(x)))
        return m.conv3(_leaky(m.conv2(h)))

    return _FinalMerge(6, 3), (_x(11, B, N, 6),), before


def _sigma_b():
    def before(m, h):
        h = torch.relu(m.bn(m.fc1(h)))
        return torch.relu(m.fc3(torch.relu(m.fc2(h))))

    return SigmaBRegressor(16), (_x(12, 7, 16),), before


def _factor_nn_head():
    """The LDPC model's FactorNN: its final head, the input of
    ``final_conv2``, against the instance norm and ReLU of
    ``final_conv1``'s output."""
    model = tm.LDPCModel(dim_mapping_list=(8, 8, 16), skip_link={})
    seen = {}
    model.main.final_conv1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("y", out))
    model.main.final_conv2.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("h", args[0]))
    rng = np.random.RandomState(13)
    inputs = tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                   for s in ((2, 96, 2), (2, 48, 6), (2, 96, 3, 7),
                             (2, 48, 6, 7)))

    def run(m, *args):
        seen.clear()
        m(*args)
        return seen["h"]

    def before(m, *args):
        seen.clear()
        m(*args)
        return torch.relu(tnorm.instance_norm(seen["y"]))

    return model, inputs, before, run


CASES = {"MPConv": _mpconv, "MPConvResidual": _mpconv_residual,
         "GConvResidual": _gconv_residual, "IIDMapBN": _iid_map_bn,
         "IIDMapIN": _iid_map_in, "IIDBlock": _iid_block,
         "PointwiseFallback": _pointwise,
         "PointwiseFallback_seg": _pointwise_seg,
         "FinalMerge": _final_merge, "SigmaBRegressor": _sigma_b,
         "FactorNN_head": _factor_nn_head}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_activation_argument_keeps_the_bits(name, train):
    case = CASES[name]()
    module, inputs, before = case[:3]
    run = case[3] if len(case) > 3 else (lambda m, *a: m(*a))
    module = _off_init(module, 20).train(train)
    old = copy.deepcopy(module)
    got = run(module, *inputs)
    want = before(old, *inputs)
    assert torch.equal(got, want)
    for (k, b), b_old in zip(module.named_buffers(), old.buffers()):
        assert b is None or torch.equal(b, b_old), k
    got.square().sum().backward()
    want.square().sum().backward()
    for (k, p), p_old in zip(module.named_parameters(), old.parameters()):
        assert (p.grad is None) == (p_old.grad is None), k
        assert p.grad is None or torch.equal(p.grad, p_old.grad), k


@pytest.mark.parametrize("activation", [None, "relu", "leaky_relu"])
def test_norms_apply_the_activation_after_the_norm(activation):
    plain = {None: lambda t: t, "relu": torch.relu, "leaky_relu": _leaky}
    x = _x(14, B, N, 8) * 2 - 0.5
    bn = _off_init(tnorm.BatchNorm(8), 3).eval()
    assert torch.equal(bn(x, activation=activation),
                       plain[activation](bn(x)))
    assert torch.equal(tnorm.instance_norm(x, activation=activation),
                       plain[activation](tnorm.instance_norm(x)))


def test_an_unknown_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        tnorm.BatchNorm(4)(torch.zeros(2, 4), activation="gelu")
    with pytest.raises(ValueError, match="activation"):
        tnorm.instance_norm(torch.zeros(2, 3, 4), activation="tanh")


# ------------------------------------------------------------ engagement
@pytest.fixture
def card(monkeypatch):
    """Pretend every tensor lies on the card, and count the launches the
    norms ask for in place of running the kernels."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)

    def launched(x, *args, **kwargs):
        fused_mp.NORM_ACT_COUNTS["kernel_launches"] += 1
        return torch.zeros_like(x)

    monkeypatch.setattr(norm_act, "bn_act", launched)
    monkeypatch.setattr(norm_act, "in_act", launched)


def _eval_bn(x):
    return _off_init(tnorm.BatchNorm(x.shape[-1]), 5).eval()(
        x, activation="relu")




def _train_bn(x):
    return _off_init(tnorm.BatchNorm(x.shape[-1]), 5).train()(x)


def _in(x):
    return tnorm.instance_norm(x, activation="leaky_relu")


def _in_seg(x):
    seg = segment_bins(np.arange(x.shape[0] * x.shape[1]) % 3 - 1, 2)
    return tnorm.instance_norm(x.reshape(-1, x.shape[-1]), seg=seg)


def _grad(x):
    return x.requires_grad_()


# case: (norm, input transform, pretend the card, record a graph, launches
# a kernel)
ENGAGE = {
    "eval_bn": (_eval_bn, None, True, False, True),
    "instance_norm": (_in, None, True, False, True),
    "eval_bn_cpu": (_eval_bn, None, False, False, False),
    "instance_norm_cpu": (_in, None, False, False, False),
    "eval_bn_grad": (_eval_bn, _grad, True, True, False),
    "eval_bn_parameter_grad": (_eval_bn, None, True, True, False),
    "instance_norm_grad": (_in, _grad, True, True, False),
    "eval_bn_bf16": (_eval_bn, lambda x: x.bfloat16(), True, False, False),
    "instance_norm_bf16": (_in, lambda x: x.bfloat16(), True, False, False),
    "train_bn": (_train_bn, None, True, False, False),
    "instance_norm_seg": (_in_seg, None, True, False, False),
    "eval_bn_noncontiguous": (_eval_bn, lambda x: x.transpose(0, 1), True,
                              False, False),
    "instance_norm_f64": (_in, lambda x: x.double(), True, False, False),
}


@pytest.mark.parametrize("name", sorted(ENGAGE))
def test_engagement_rule(name, request):
    norm, prep, on_card, graph, launches = ENGAGE[name]
    if on_card:
        request.getfixturevalue("card")
    x = _x(15, B, N, 8)
    x = x if prep is None else prep(x)
    fused_mp.reset_counts()
    with torch.set_grad_enabled(graph):
        norm(x)
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": int(launches),
                                        "plain_calls": int(not launches)}


def test_no_graph_recorded_engages_under_no_grad(card):
    """A tensor that requires grad, and the module's parameters, launch
    where no graph is recorded: under no_grad and inference_mode."""
    x = _x(16, B, N, 8).requires_grad_()
    fused_mp.reset_counts()
    with torch.no_grad():
        _eval_bn(x)
        _in(x)
    with torch.inference_mode():
        _eval_bn(_x(16, B, N, 8))
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 3,
                                        "plain_calls": 0}


def test_decode_forward_counts_every_norm_once():
    """108 norms in the reference LDPC decoder's forward: 83 BatchNorms
    and 25 instance norms, each one plain call on the CPU."""
    model = tm.init_weights(tm.LDPCModel(), 0).eval()
    rng = np.random.RandomState(17)
    inputs = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((1, 96, 2), (1, 48, 6), (1, 96, 3, 7),
                        (1, 48, 6, 7))]
    fused_mp.reset_counts()
    with torch.inference_mode():
        model(*inputs)
    assert fused_mp.NORM_ACT_COUNTS == {"kernel_launches": 0,
                                        "plain_calls": 108}
