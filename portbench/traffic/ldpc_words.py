"""Received words of the MacKay 96.3.963 code under AWGN and burst noise.

A frozen copy of the port's channel and feature code (its data layer's
``alist``, ``ldpc_channel``, ``ldpc_graph`` and ``ContinuousCodesSP``),
with the benchmark's own copy of the code files under
``codes/96.3.963``: for one seed it gives the port's words bit for bit
(``tests/test_bench_traffic.py``), and later changes to the program do not
move it.

Each word: sigma_b drawn from ``sigma_b``, the SNR from ``snr_db``, 48
uniform source bits, the codeword [s ; t] with t = G s mod 2, BPSK at
amplitude 10^(snr/20) plus unit AWGN plus, with probability
``burst_prob`` per bit where sigma_b > 0, burst noise of deviation
10^(snr/20) sigma_b; in the order of the port's ``ContinuousCodesSP``.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .. import workers

K_INFO = 48
N_CODE = 96
CODES = os.path.join(os.path.dirname(__file__), "codes", "96.3.963")


def read_alist(path: str):
    """(column items, row items) of a MacKay alist file, 0-based."""
    with open(path) as f:
        it = iter(f.read().split())
    n, m = int(next(it)), int(next(it))
    max_cd, max_rd = int(next(it)), int(next(it))
    col_deg = [int(next(it)) for _ in range(n)]
    row_deg = [int(next(it)) for _ in range(m)]
    cols = [[e - 1 for e in (int(next(it)) for _ in range(max_cd)) if e > 0]
            for _ in range(n)]
    rows = [[e - 1 for e in (int(next(it)) for _ in range(max_rd)) if e > 0]
            for _ in range(m)]
    if [len(c) for c in cols] != col_deg or [len(r) for r in rows] != row_deg:
        raise ValueError(f"{path}: degrees do not match the entries")
    return cols, rows


def read_mod2mat(path: str) -> np.ndarray:
    """A Radford Neal binary mod2 matrix as dense uint8 (rows, cols)."""
    with open(path, "rb") as f:
        raw = f.read()
    n_rows, n_cols = np.frombuffer(raw[:8], dtype="<i4")
    n_words = (n_rows + 31) // 32
    words = np.frombuffer(raw[8:], dtype="<u8").reshape(n_cols, n_words)
    out = np.zeros((n_rows, n_cols), dtype=np.uint8)
    for i in range(n_rows):
        w, b = divmod(i, 32)
        out[i] = (words[:, w] >> np.uint64(b)) & np.uint64(1)
    return out


@functools.lru_cache(maxsize=None)
def code_tables():
    """(var_checks (96, 3), factors (48, 6), G (48, 48)) of the code."""
    cols, rows = read_alist(os.path.join(CODES, "96.3.963"))
    g = read_mod2mat(os.path.join(CODES, "G"))
    return (np.asarray(cols, np.int64), np.asarray(rows, np.int64), g)


def encode(s: np.ndarray) -> np.ndarray:
    """The codeword [s ; G s mod 2] of 48 source bits."""
    g = code_tables()[2]
    s = np.asarray(s, np.int64)
    return np.concatenate([s, (s @ g.T) % 2])


def channel(t, snr_db, sigma_b, burst_prob, rng) -> np.ndarray:
    gcx = float(10.0 ** (snr_db / 20.0))
    t = np.asarray(t, dtype=np.float64)
    y = 2.0 * gcx * (t - 0.5) + rng.randn(t.size)
    if sigma_b >= 1e-20:
        burst = rng.rand(t.size) < burst_prob
        y = y + burst * rng.randn(t.size) * (gcx * sigma_b)
    return y


def features(ys: np.ndarray, snrs: np.ndarray) -> dict:
    """The decoder's inputs of received words (B, 96): the port's
    ``batch_to_features``, tables tiled per word."""
    var_checks, factors, _ = code_tables()
    ys = np.asarray(ys, np.float32)
    B = ys.shape[0]
    snr = np.asarray(snrs, np.float32).reshape(B, 1)
    hop = ys[:, factors]
    ef_f2v = np.concatenate(
        [hop[:, var_checks],
         np.broadcast_to(ys[:, :, None, None], (B, N_CODE, 3, 1))],
        axis=3).astype(np.float32)
    ef_v2f = np.concatenate(
        [np.broadcast_to(hop[:, :, None, :], (B, K_INFO, 6, 6)),
         hop[..., None]], axis=3).astype(np.float32)
    node = np.stack([ys, np.broadcast_to(snr, ys.shape)], axis=-1)

    def tile(a):
        return np.broadcast_to(a[None], (B,) + a.shape).copy()

    return {
        "node_feature": node.astype(np.float32),
        "hop_feature": hop.astype(np.float32),
        "nn_idx_f2v": tile(var_checks.astype(np.int32)),
        "nn_idx_v2f": tile(factors.astype(np.int32)),
        "efeature_f2v": ef_f2v,
        "efeature_v2f": ef_v2f,
    }


def words(seed: int, n: int, snr_db, sigma_b, burst_prob: float) -> dict:
    """n words from ``RandomState(seed)``, in ``ContinuousCodesSP``'s draw
    order: features, the codeword as ``label``, sigma_b and snr_db."""
    return with_features(draw(seed, n, snr_db, sigma_b, burst_prob))


def with_features(raw: dict) -> dict:
    out = features(raw["y"], raw["snr_db"])
    out.update(label=raw["label"], sigma_b=raw["sigma_b"],
               snr_db=raw["snr_db"])
    return out


def draw(seed: int, n: int, snr_db, sigma_b, burst_prob: float) -> dict:
    """The received words (y), codewords, sigma_b and snr_db of n words."""
    rng = np.random.RandomState(seed)
    ys, labels, sbs, snrs = [], [], [], []
    for _ in range(n):
        sb = rng.choice(tuple(sigma_b))
        snr = rng.choice(tuple(snr_db))
        cw = encode(rng.randint(0, 2, K_INFO))
        ys.append(channel(cw, snr, sb, burst_prob, rng))
        labels.append(cw)
        sbs.append(sb)
        snrs.append(snr)
    return {"y": np.stack(ys), "label": np.stack(labels).astype(np.int32),
            "sigma_b": np.asarray(sbs, np.float32),
            "snr_db": np.asarray(snrs, np.float32)}


def _chunk(args):
    return draw(*args)


def make_pool(mix: dict, seed: int, batch: int, n_workers: int) -> list:
    """``mix["pool_batches"]`` distinct batches of ``batch`` words, each
    drawn in chunks of ``mix["chunk"]`` words with seeds of their own
    (drawn from ``seed``), so the pool does not depend on the workers; the
    features are made here, a batch at a time."""
    chunk = int(mix["chunk"])
    if batch % chunk:
        chunk = batch
    per = batch // chunk
    n = int(mix["pool_batches"]) * per
    seeds = workers.sub_seeds(seed, "ldpc_words", n)
    jobs = [(s, chunk, mix["snr_db"], mix["sigma_b"], mix["burst_prob"])
            for s in seeds]
    parts = workers.map_jobs(_chunk, jobs, n_workers)
    return [with_features(workers.concat(parts[i * per:(i + 1) * per]))
            for i in range(len(parts) // per)]
