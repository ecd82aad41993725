"""The port's entry points (``fgnn_tpu_torch.entry``) against
``__graft_entry__.py``, on the CPU: the example arguments bit for bit,
the model's parameters by the flax tree's paths, ``fn`` against the
decoder's own forward, the refusal to fall back to the CPU, and the dry
run on four gloo ranks against one process."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fgnn_tpu.models import LDPCModel as JLDPCModel
from fgnn_tpu.train.ldpc import _model_inputs
from fgnn_tpu_torch import entry as tentry
from fgnn_tpu_torch.models import LDPCModel, init_weights, \
    load_flax_variables
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.ops.segment import CooGraph
from fgnn_tpu_torch.train import ldpc as t_ldpc
from fgnn_tpu_torch.train.common import make_optimizer

no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the refusal without CUDA")


def _jax_args():
    inputs = _model_inputs(graft._example_batch(8))
    return [np.asarray(inputs[k]) for k in tentry.ARG_NAMES]


def test_entry_args_equal_the_jax_entrys():
    fn, args = tentry.entry(device="cpu")
    assert len(args) == 6
    for name, got, want in zip(tentry.ARG_NAMES, args, _jax_args()):
        assert got.device.type == "cpu"
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_entry_model_loads_the_jax_tree_and_decodes_as_the_trainer():
    fn, args = tentry.entry(device="cpu")
    assert not fn.model.training
    inputs = _model_inputs(graft._example_batch(8))
    shapes = jax.eval_shape(partial(JLDPCModel().init, train=False),
                            jax.random.PRNGKey(0), **inputs)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda a: rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        + (1.0 if len(a.shape) == 1 else 0.0), dict(shapes))
    load_flax_variables(fn.model, tree)  # strict: every leaf, every tensor
    fused_mp.reset_counts()
    logits, sigma_b = fn(*args)
    assert logits.shape == (8, 48) and sigma_b.shape == (8, 1)
    assert fused_mp.COUNTS["plain_calls"] == 16
    assert not logits.requires_grad
    want = t_ldpc.decode_logits(fn.model, tentry.example_batch(8), "cpu")
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    bad = list(args)
    bad[3] = torch.flip(bad[3], (0,))
    with pytest.raises(ValueError, match="nn_idx_v2f"):
        fn(*bad)


def test_entry_main_runs_on_the_cpu(capsys):
    tentry.main(["--device", "cpu"])
    assert "entry ok: ((8, 48), (8, 1))" in capsys.readouterr().out


@no_cuda
def test_without_cuda_the_entry_points_raise():
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.dryrun_multichip(2)


def test_dryrun_on_four_gloo_ranks(capsys):
    res = tentry.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, "
                           "'model': 2} loss=")
    nums = dict(kv.split("=") for kv in line.split("} ", 1)[1].split())
    assert sorted(nums) == ["acc", "halo_loss", "loss"]
    assert all(np.isfinite(float(v)) for v in nums.values())
    assert res["backend"] == "gloo" and len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["counts"]["fwd"]["plain_calls"] == 16
        assert r["counts"]["bwd"]["plain_calls"] == 15
    # one process's step on the same weights and the whole 16-row batch
    model = init_weights(LDPCModel(), 0)
    one = t_ldpc.train_step(model, make_optimizer(model.parameters(),
                                                  t_ldpc.BASE_LR),
                            tentry.example_batch(16), "cpu")
    assert abs(res["loss"] - float(one["loss"])) <= 1e-4 * float(
        one["loss"])
    assert abs(res["acc"] - float(one["acc"])) <= 1e-6
    # the halo conv against the same conv on one rank over the COO conv
    src, dst, n, et, x = tentry.halo_case(4)
    with torch.no_grad():
        out = tentry.halo_conv()(torch.from_numpy(x),
                                 CooGraph(src, dst, num_nodes=n),
                                 torch.from_numpy(et))
    ref = float((out.double() ** 2).sum())
    assert abs(res["halo_loss"] - ref) <= 1e-5 * ref
    assert float(nums["halo_loss"]) == pytest.approx(ref, rel=1e-4)
