"""The port's utils (``fgnn_tpu_torch.utils``) against the JAX package's,
on the CPU: the five tests of ``tests/test_utils.py`` on the port's
versions, ``str2bool`` word for word, ``nan_debug`` (an op's NaN, a kernel
wrapper's plain version, the backward, the mode off after the block) and
``trace`` with an ``annotate`` range."""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

from fgnn_tpu.utils import types as jtypes
from fgnn_tpu_torch.ops import fused_mp
from fgnn_tpu_torch.utils import (
    MetricsWriter,
    StepTimer,
    annotate,
    check_finite,
    deterministic,
    device_memory_stats,
    nan_debug,
    str2bool,
    trace,
)
from fgnn_tpu_torch.utils import types as ttypes
from fgnn_tpu_torch.utils.debug import nan_checks_on


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.add_scalar("train/loss", 0.5, 1)
    w.add_scalar("train/loss", 0.25, 2)
    w.close()
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["value"] for l in lines] == [0.5, 0.25]
    assert lines[0]["tag"] == "train/loss"


def test_step_timer():
    t = StepTimer()
    for _ in range(5):
        t.step(n_edges=100, n_samples=2)
    s = t.snapshot()
    assert s["edges_per_s"] > 0
    assert abs(s["edges_per_s"] / s["samples_per_s"] - 50) < 1e-6
    t.reset()
    assert t.snapshot()["steps_per_s"] == 0


def test_check_finite_flags_bad_leaf():
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    check_finite(good)  # no raise
    bad = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, np.nan])},
           "d": [torch.ones(1), torch.tensor([np.inf])]}
    with pytest.raises(FloatingPointError) as e:
        check_finite(bad, "grads")
    assert "['b']['c']" in str(e.value) and "['d'][1]" in str(e.value)
    assert "['a']" not in str(e.value) and "grads" in str(e.value)


def test_check_finite_names_a_state_dict_key():
    sd = torch.nn.Linear(3, 2).state_dict()
    check_finite(sd)
    sd["bias"][1] = float("nan")
    with pytest.raises(FloatingPointError, match="'bias'"):
        check_finite(sd, "state")


def test_deterministic_seeds():
    g1 = deterministic(7)
    a = np.random.rand(3)
    t1 = torch.rand(3, generator=g1)
    g2 = deterministic(7)
    b = np.random.rand(3)
    t2 = torch.rand(3, generator=g2)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(t1, t2)
    assert g1.initial_seed() == g2.initial_seed() == 7


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict)  # empty on the CPU
    if not torch.cuda.is_available():
        assert stats == {}


@pytest.mark.parametrize("word", sorted(jtypes._BOOL_WORDS) + [
    " Yes ", "TRUE", "F", "maybe", "", "2"])
def test_str2bool_matches_jax(word):
    assert ttypes._BOOL_WORDS == jtypes._BOOL_WORDS
    try:
        want = jtypes.str2bool(word)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            str2bool(word)
        return
    assert str2bool(word) is want


def test_nan_debug_raises_on_an_op_and_restores():
    x = torch.tensor([0.0, 1.0])
    assert not nan_checks_on()
    with nan_debug():
        assert nan_checks_on()
        y = x + 1.0  # clean ops pass
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        with nan_debug(False):
            assert not nan_checks_on()
            z = x / x
        assert nan_checks_on()
    assert not nan_checks_on()
    assert torch.isnan(z[0]) and y[1] == 2.0
    _ = x / x  # no check after the block
    with nan_debug(False):
        assert not nan_checks_on()


def _plain_conv_inputs():
    rng = np.random.RandomState(0)
    h = torch.tensor(rng.randn(2, 5, 2, 3).astype(np.float32),
                     requires_grad=True)
    idx = torch.tensor(rng.randint(0, 5, (4, 3)).astype(np.int32))
    et = torch.tensor(rng.randn(2, 4, 3, 2).astype(np.float32))
    return h, idx, et


def test_nan_debug_sees_the_kernel_wrappers_plain_version():
    from fgnn_tpu_torch.ops.typed_mp import GatherTable

    h, idx, et = _plain_conv_inputs()
    table = GatherTable(idx.numpy(), 5)
    bad = h.detach().clone()
    bad[0, 1, 0, 2] = float("nan")
    with nan_debug():
        out = fused_mp.typed_mp_fwd(h, table, et, "softmax")
        out.sum().backward()  # a clean forward and backward pass
        fused_mp.reset_counts()
        with pytest.raises(FloatingPointError):
            fused_mp.typed_gather_mix_agg(bad, table.idx, et, "sum")
        assert fused_mp.COUNTS["plain_calls"] == 1
        # the backward: a NaN cotangent raises inside the plain backward
        out = fused_mp.typed_mp_fwd(h, table, et, "max")
        with pytest.raises(FloatingPointError):
            out.backward(torch.full_like(out, float("nan")))


def test_trace_writes_an_annotated_trace(tmp_path):
    x = torch.randn(8, 8)
    with trace(str(tmp_path)):
        with annotate("fgnn_entry"):
            (x @ x).sum()
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        text = f.read()
    assert "fgnn_entry" in text and "aten::mm" in text
