"""The port's numpy data layer (fgnn_tpu_torch.data) against the JAX
package's (fgnn_tpu.data): same seeds, bit-identical outputs."""

import pickle

import numpy as np
import pytest
import torch

from fgnn_tpu.data import alist as j_alist
from fgnn_tpu.data import generate as j_generate
from fgnn_tpu.data import ldpc_channel as j_channel
from fgnn_tpu.data import ldpc_datasets as j_ds
from fgnn_tpu.data import ldpc_graph as j_graph
from fgnn_tpu.data import reference_io as j_refio
from fgnn_tpu_torch.data import alist as t_alist
from fgnn_tpu_torch.data import generate as t_generate
from fgnn_tpu_torch.data import ldpc_channel as t_channel
from fgnn_tpu_torch.data import ldpc_datasets as t_ds
from fgnn_tpu_torch.data import ldpc_graph as t_graph
from fgnn_tpu_torch.data import reference_io as t_refio


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


def test_eval_set_with_bp_baseline_matches_jax(tmp_path):
    """The default grid carries the sum-product matrix: every array equal
    to the JAX writer's for the same seed and size."""
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_err = t_ds.generate_eval_set(tp, n_per_cell=4, seed=3)
    j_err = j_ds.generate_eval_set(jp, n_per_cell=4, seed=3)
    np.testing.assert_array_equal(t_err, j_err)
    assert t_err.any()
    with np.load(tp) as ft, np.load(jp) as fj:
        assert sorted(ft.files) == sorted(fj.files)
        for k in ft.files:
            assert ft[k].dtype == fj[k].dtype, k
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


@pytest.mark.parametrize("snr", [None, 3])
def test_continuous_codes_sample_matches_jax(snr):
    """``sample()``, the rows the worker pool stacks, as the JAX dataset's:
    keys, dtypes and values, from the same RNG."""
    t = t_ds.ContinuousCodesSP(length=8, snr=snr, seed=5)
    j = j_ds.ContinuousCodesSP(length=8, snr=snr, seed=5)
    for _ in range(3):
        a, b = t.sample(), j.sample()
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _same_npz(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("pgm_type", ["raw", "pws", "hops"])
def test_rpgm_writer_cli_matches_jax(tmp_path, pgm_type):
    argv = ["rpgm", "--type", pgm_type, "--size", "10", "--chain-length",
            "12", "--hop-cap", "3", "--hop-order", "5", "--workers", "3",
            "--seed", "2", "--out"]
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_generate.main(argv + [tp])
    j_generate.main(argv + [jp])
    _same_npz(tp, jp)


def test_ldpc_writer_cli_matches_jax(tmp_path, capsys):
    tp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    t_generate.main(["ldpc", "--n-per-cell", "3", "--seed", "4", "--out", tp])
    t_out = capsys.readouterr().out
    j_generate.main(["ldpc", "--n-per-cell", "3", "--seed", "4", "--out", jp])
    assert t_out == capsys.readouterr().out
    assert "sum-product baseline" in t_out
    _same_npz(tp, jp)


@pytest.mark.parametrize("size", [None, 13])
def test_npz_rpgm_reader_matches_jax(tmp_path, size):
    path = str(tmp_path / "hops.npz")
    t_generate.generate_rpgm(path, "hops", 20, chain_length=12,
                             hop_order=5, workers=2, seed=1)
    t, j = t_generate.NpzRPGMData(path, size), j_generate.NpzRPGMData(
        path, size)
    assert len(t) == len(j) == (size or 20)
    for shuffle, seed in ((True, 3), (True, 4), (False, 0)):
        got = list(t.batches(4, shuffle=shuffle, seed=seed))
        want = list(j.batches(4, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) == len(t) // 4
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)


def _reference_stream(path, pgm_type, n, rng, L=12, H=5):
    """A pickle-per-sample stream in the reference's channel-first
    layout."""
    with open(path, "wb") as f:
        for _ in range(n):
            nf = rng.rand(2, L).astype(np.float32)
            assign = rng.randint(0, 2, (L,)).astype(np.int64)
            assign1 = rng.randint(0, 2, (L,)).astype(np.int64)
            pw = rng.rand(4, L, 1).astype(np.float32)
            hop = rng.rand(H, L, 1).astype(np.float32)
            item = {"raw": (nf, assign, assign1),
                    "pws": (nf, pw, assign, assign1),
                    "hops": (nf, pw, hop, assign, assign1)}[pgm_type]
            pickle.dump(item, f)


@pytest.mark.parametrize("pgm_type", ["raw", "pws", "hops"])
def test_reference_rpgm_roundtrip_matches_jax(tmp_path, rng, pgm_type):
    src = str(tmp_path / "ref.dat")
    _reference_stream(src, pgm_type, 7, rng)
    got = t_refio.read_reference_rpgm(src, pgm_type)
    _assert_batches_equal(got, j_refio.read_reference_rpgm(src, pgm_type))
    assert got["node_feature"].shape == (7, 12, 2)
    _assert_batches_equal(t_refio.read_reference_rpgm(src, pgm_type, 3),
                          {k: v[:3] for k, v in got.items()})
    out = str(tmp_path / "conv.npz")
    t_refio.main(["rpgm", src, "--type", pgm_type, "--out", out])
    batch = next(t_generate.NpzRPGMData(out).batches(4, shuffle=False))
    _assert_batches_equal(batch, {k: v[:4] for k, v in got.items()})
    with pytest.raises(ValueError, match="unknown pgm_type"):
        t_refio.read_reference_rpgm(src, "bad")


def test_reference_ldpc_pt_roundtrip_matches_jax(tmp_path, rng):
    n = 5
    d = {
        "noizy_sg": torch.tensor(rng.randn(n, 96).astype(np.float32)),
        "gts": torch.tensor(rng.randint(0, 2, (n, 96))),
        "snr_dbs": torch.tensor(np.repeat(
            rng.choice([0.0, 2.0], n)[:, None], 96, 1).astype(np.float32)),
        "sigma_b": torch.tensor(rng.rand(n).astype(np.float32)),
    }
    src = str(tmp_path / "test.pt")
    torch.save(d, src)
    got = t_refio.read_reference_ldpc_pt(src)
    _assert_batches_equal(got, j_refio.read_reference_ldpc_pt(src))
    out = str(tmp_path / "codes.npz")
    t_refio.main(["ldpc", src, "--out", out])
    batch = next(t_ds.Codes(out).batches(4))
    np.testing.assert_array_equal(batch["node_feature"][:, :, 0],
                                  d["noizy_sg"].numpy()[:4])
    np.testing.assert_array_equal(batch["label"], d["gts"].numpy()[:4])
    np.testing.assert_array_equal(batch["snr_db"],
                                  d["snr_dbs"].numpy()[:4, 0])
