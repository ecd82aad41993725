"""The port's numpy data layer (fgnn_tpu_torch.data) against the JAX
package's (fgnn_tpu.data): same seeds, bit-identical outputs."""

import os

import numpy as np
import pytest

from fgnn_tpu.data import alist as j_alist
from fgnn_tpu.data import ldpc_channel as j_channel
from fgnn_tpu.data import ldpc_datasets as j_ds
from fgnn_tpu.data import ldpc_graph as j_graph
from fgnn_tpu_torch.data import alist as t_alist
from fgnn_tpu_torch.data import ldpc_channel as t_channel
from fgnn_tpu_torch.data import ldpc_datasets as t_ds
from fgnn_tpu_torch.data import ldpc_graph as t_graph


def _assert_batches_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_read_alist_and_generator_match():
    ja = j_alist.read_alist(j_alist.default_paths()["alist"])
    ta = t_alist.read_alist(t_alist.default_paths()["alist"])
    assert (ta.N, ta.M) == (ja.N, ja.M) == (96, 48)
    assert ta.col_items == ja.col_items
    assert ta.row_items == ja.row_items
    np.testing.assert_array_equal(
        t_alist.read_mod2mat(t_alist.default_paths()["G"]),
        j_alist.read_mod2mat(j_alist.default_paths()["G"]))


def test_structure_tables_and_features_match():
    js, ts = j_graph.default_structure(), t_graph.default_structure()
    for f in ("n_vars", "n_checks", "var_deg", "check_deg"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.factors, js.factors)
    np.testing.assert_array_equal(ts.var_checks, js.var_checks)
    y = np.random.RandomState(3).randn(96)
    for a, b in zip(ts.bipartite_features(y), js.bipartite_features(y)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sigma_b", [0.0, 3.0])
def test_encode_channel_posteriors_match(sigma_b):
    s = np.random.RandomState(4).randint(0, 2, 48)
    np.testing.assert_array_equal(t_channel.encode(s), j_channel.encode(s))
    cw = j_channel.encode(s)
    y_t = t_channel.channel(cw, 2.0, sigma_b, rng=np.random.RandomState(5))
    y_j = j_channel.channel(cw, 2.0, sigma_b, rng=np.random.RandomState(5))
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(t_channel.posteriors(y_t, 2.0),
                                  j_channel.posteriors(y_j, 2.0))


def test_gen_sample_matches():
    yt, ct = t_ds.gen_sample(1, 2, rng=np.random.RandomState(6))
    yj, cj = j_ds.gen_sample(1, 2, rng=np.random.RandomState(6))
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("snr", [None, 2])
def test_continuous_codes_batches_bit_identical(snr):
    tb = t_ds.ContinuousCodesSP(length=16, snr=snr, seed=0).batches(8)
    jb = j_ds.ContinuousCodesSP(length=16, snr=snr, seed=0).batches(8)
    n = 0
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
        n += 1
    assert n == 2


def test_eval_set_and_codes_bit_identical(tmp_path):
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_ds.generate_eval_set(tp, n_per_cell=2, with_bp_error=False)
    j_ds.generate_eval_set(jp, n_per_cell=2, with_bp_error=False)
    with np.load(tp) as ft, np.load(jp) as fj:
        assert sorted(ft.files) == sorted(fj.files)
        for k in ft.files:
            assert ft[k].dtype == fj[k].dtype, k
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    tc, jc = t_ds.Codes(tp), j_ds.Codes(jp)
    assert len(tc) == len(jc) == 60
    n = 0
    for a, b in zip(tc.batches(7), jc.batches(7)):
        _assert_batches_equal(a, b)
        n += 1
    assert n == 60 // 7


def test_eval_set_with_bp_baseline_raises(tmp_path):
    path = str(tmp_path / "bp.npz")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_ds.generate_eval_set(path, n_per_cell=2, with_bp_error=True)
    assert not os.path.exists(path)
