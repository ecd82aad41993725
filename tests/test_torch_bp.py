"""The port's sum-product decoders against the JAX package's, on the CPU.

* ``data.bp_ref`` (numpy, f64) and ``data.ldpc_cpp`` (C++, f64): the same
  decisions, flags, iteration counts and posteriors, to the bit;
* ``ops.bp.bp_decode_batch`` (torch, f32) against
  ``fgnn_tpu.ops.bp.bp_decode_batch`` (XLA, f32) on seeded batches of 64
  words over four (snr, sigma_b) cells, at 50 and 100 loops: ``success``
  and ``iters`` equal on every word, ``x`` on every word both solve and
  ``q1`` within Q1_ATOL there (the two round a few divisions differently,
  by one f32 ulp);
* the eval grid's sum-product matrix and ``gen_sample``'s error rate.

The C++ tests build the library with g++ and skip where there is none.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgnn_tpu.data import bp_ref as j_bp_ref
from fgnn_tpu.data import ldpc_cpp as j_cpp
from fgnn_tpu.data import ldpc_datasets as j_ds
from fgnn_tpu.ops import bp as j_bp
from fgnn_tpu_torch.data import bp_ref as t_bp_ref
from fgnn_tpu_torch.data import ldpc_cpp as t_cpp
from fgnn_tpu_torch.data import ldpc_datasets as t_ds
from fgnn_tpu_torch.data.ldpc_channel import (
    channel,
    encode,
    load_generator,
    posteriors,
)
from fgnn_tpu_torch.ops import bp as t_bp

CELLS = [(0, 0), (1, 3), (2, 5), (4, 1)]
WORDS = 64
Q1_ATOL = 1e-5


def _biases(snr, sigma_b, n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        cw = encode(rng.randint(0, 2, 48), 48, 48)
        out.append(posteriors(channel(cw, snr, sigma_b, 0.05, rng), snr))
    return np.stack(out)


@pytest.fixture
def cpp():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++)")
    assert t_cpp.available() and j_cpp.available()


def test_decode_graph_matches_jax():
    t, j = t_ds.decode_graph(), j_ds.decode_graph()
    assert (t.N, t.M) == (j.N, j.M) == (96, 48)
    for k in ("row_cols", "row_mask", "col_rows", "col_mask", "col_slot",
              "H"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                      err_msg=k)
    jg = j_bp.BPGraphArrays.from_ref(j)
    tg = t_bp.BPGraphArrays.from_ref(t)
    for k in ("row_cols", "row_mask", "col_rows", "col_mask", "col_slot",
              "inv_n", "inv_u"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)


@pytest.mark.parametrize("snr,sigma_b", CELLS)
def test_bp_ref_matches_jax(snr, sigma_b):
    g_t, g_j = t_ds.decode_graph(), j_ds.decode_graph()
    for bias in _biases(snr, sigma_b, 6, seed=snr * 10 + sigma_b):
        xt, okt, itt, qt = t_bp_ref.bp_decode(g_t, bias, max_loops=50)
        xj, okj, itj, qj = j_bp_ref.bp_decode(g_j, bias, max_loops=50)
        np.testing.assert_array_equal(xt, xj)
        assert (okt, itt) == (okj, itj)
        np.testing.assert_array_equal(qt, qj)
        kt = t_bp_ref.decode_posteriors(g_t, bias, max_loops=50)
        kj = j_bp_ref.decode_posteriors(g_j, bias, max_loops=50)
        np.testing.assert_array_equal(kt[0], kj[0])
        assert kt[1:] == kj[1:]


@pytest.mark.parametrize("snr,sigma_b", CELLS)
def test_cpp_decoder_matches_jax_and_numpy(cpp, snr, sigma_b):
    g = t_ds.decode_graph()
    bias = _biases(snr, sigma_b, 16, seed=100 + snr * 10 + sigma_b)
    xt, okt, itt = t_cpp.bp_decode_batch(g, bias, max_loops=50)
    xj, okj, itj = j_cpp.bp_decode_batch(j_ds.decode_graph(), bias,
                                         max_loops=50)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(itt, itj)
    for b in range(len(bias)):
        x, ok, it, _ = t_bp_ref.bp_decode(g, bias[b], max_loops=50)
        np.testing.assert_array_equal(xt[b], x, err_msg=f"word {b}")
        assert (okt[b], itt[b]) == (ok, it), b


def test_cpp_encode_matches_jax(cpp):
    G = load_generator()
    s = np.random.RandomState(5).randint(0, 2, (7, G.shape[1]))
    t = t_cpp.encode_batch(G, s)
    np.testing.assert_array_equal(t, j_cpp.encode_batch(G, s))
    np.testing.assert_array_equal(t, encode(s.ravel()).reshape(7, 96)[:, 48:])


@pytest.mark.parametrize("max_loops", [50, 100])
@pytest.mark.parametrize("snr,sigma_b", CELLS)
def test_bp_decode_batch_matches_jax(snr, sigma_b, max_loops):
    bias = _biases(snr, sigma_b, WORDS, seed=7 + snr * 10 + sigma_b) \
        .astype(np.float32)
    jx, jok, jit, jq = (np.asarray(a) for a in j_bp.bp_decode_batch(
        j_bp.BPGraphArrays.from_ref(j_ds.decode_graph()), jnp.asarray(bias),
        max_loops=max_loops, return_posterior=True))
    graph = t_bp.BPGraphArrays.from_ref(t_ds.decode_graph())
    tx, tok, tit, tq = (a.numpy() for a in t_bp.bp_decode_batch(
        graph, torch.from_numpy(bias), max_loops=max_loops,
        return_posterior=True))
    assert tx.dtype == np.int32 and tit.dtype == np.int32
    assert tq.dtype == np.float32 and tok.dtype == np.bool_
    bad = np.flatnonzero((tok != jok) | (tit != jit))
    assert not bad.size, f"success or iters differ on words {bad}"
    both = tok & jok
    bad = np.flatnonzero((tx != jx).any(-1) & both)
    assert not bad.size, f"decisions differ on solved words {bad}"
    err = np.abs(tq - jq).max(-1)
    bad = np.flatnonzero((err > Q1_ATOL) & both)
    assert not bad.size, f"q1 differs on solved words {bad}: {err[bad]}"
    # without the posterior: the same decisions
    x2, ok2, it2 = t_bp.bp_decode_batch(graph, torch.from_numpy(bias),
                                        max_loops=max_loops)
    np.testing.assert_array_equal(x2.numpy(), tx)
    np.testing.assert_array_equal(ok2.numpy(), tok)


def test_bp_decode_batch_solves_clean_words_and_freezes():
    """At 10 dB every word decodes in a few loops; a word's outputs after
    convergence do not move with more loops."""
    bias = torch.from_numpy(_biases(10, 0, 8, seed=3).astype(np.float32))
    graph = t_bp.BPGraphArrays.from_ref(t_ds.decode_graph())
    x5, ok5, it5, q5 = t_bp.bp_decode_batch(graph, bias, 5, True)
    x9, ok9, it9, q9 = t_bp.bp_decode_batch(graph, bias, 9, True)
    assert ok5.all() and (it5 <= 5).all()
    assert torch.equal(x5, x9) and torch.equal(it5, it9)
    assert torch.equal(q5, q9)
    with pytest.raises(ValueError, match="graph on"):
        t_bp.bp_decode_batch(t_bp.BPGraphArrays.from_ref(
            t_ds.decode_graph(), "meta"), bias, 1)


def test_gen_sample_with_bp_error_matches_jax():
    for seed in range(3):
        t = t_ds.gen_sample(2, 3, rng=np.random.RandomState(seed),
                            with_bp_error=True)
        j = j_ds.gen_sample(2, 3, rng=np.random.RandomState(seed),
                            with_bp_error=True)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]


def test_numpy_fallback_gives_the_cpp_matrix(cpp, tmp_path, monkeypatch):
    """Without the native library the baseline decodes with bp_ref: the
    same matrix, and the counts say which decoder ran."""
    for k in t_ds.BP_DECODED:
        monkeypatch.setitem(t_ds.BP_DECODED, k, 0)
    native = t_ds.generate_eval_set(str(tmp_path / "a.npz"), n_per_cell=2,
                                    snrs=(1, 3), sigma_bs=(0, 4))
    assert t_ds.BP_DECODED == {"cpp": 8, "numpy": 0}
    monkeypatch.setattr(t_cpp, "available", lambda: False)
    fallback = t_ds.generate_eval_set(str(tmp_path / "b.npz"), n_per_cell=2,
                                      snrs=(1, 3), sigma_bs=(0, 4))
    assert t_ds.BP_DECODED == {"cpp": 8, "numpy": 8}
    np.testing.assert_array_equal(native, fallback)
