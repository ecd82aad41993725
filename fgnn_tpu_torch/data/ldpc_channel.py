"""LDPC encode + AWGN/burst channel + bit posteriors (host-side numpy).

Counterpart of ``fgnn_tpu/data/ldpc_channel.py``:

  * ``encode``: block-encode a bit stream with the dense GF(2) generator
    matrix; emits [s ; t] per K-bit block (t = G s mod 2), zero-padding
    the final partial block.
  * ``channel``: BPSK at amplitude gcx = 10^(snr_db/20), unit AWGN, plus
    burst noise N(0, (gcx*sigma_b)^2) added per sample with probability
    ``burst_prob`` when sigma_b > 0.
  * ``posteriors``: P(bit=1|y) = 1/(1+exp(-2*gcx*y)).

The random draws happen in the same order as the JAX package's, so one
``np.random.RandomState`` seed gives bit-identical words in both.
"""

from __future__ import annotations

import functools

import numpy as np

from .alist import default_paths, read_mod2mat


@functools.lru_cache(maxsize=None)
def load_generator(path: str | None = None) -> np.ndarray:
    g = read_mod2mat(path or default_paths()["G"])
    g.setflags(write=False)
    return g


def encode(source_bits: np.ndarray, K: int = 48, N: int = 48,
           g_path: str | None = None, include_source: bool = True) -> np.ndarray:
    """Block-encode a flat bit stream; returns [s ; t] per block."""
    G = load_generator(g_path)
    if G.shape != (N, K):
        raise ValueError(f"generator is {G.shape}, expected {(N, K)}")
    s = np.asarray(source_bits, dtype=np.int64).ravel()
    nblocks = -(-s.size // K)
    padded = np.zeros(nblocks * K, dtype=np.int64)
    padded[: s.size] = s
    blocks = padded.reshape(nblocks, K)
    t = (blocks @ G.T) % 2
    out = np.concatenate([blocks, t], axis=1) if include_source else t
    return out.reshape(-1)


def snr_amplitude(snr_db: float) -> float:
    return float(10.0 ** (snr_db / 20.0))


def channel(t: np.ndarray, snr_db: float, sigma_b: float,
            burst_prob: float = 0.05, rng: np.random.RandomState | None = None
            ) -> np.ndarray:
    """BPSK + AWGN + bursty noise."""
    rng = rng or np.random
    gcx = snr_amplitude(snr_db)
    t = np.asarray(t, dtype=np.float64)
    y = 2.0 * gcx * (t - 0.5) + rng.randn(t.size)
    if sigma_b >= 1e-20:
        burst = rng.rand(t.size) < burst_prob
        y = y + burst * rng.randn(t.size) * (gcx * sigma_b)
    return y


def posteriors(y: np.ndarray, snr_db: float) -> np.ndarray:
    """Bit posteriors P(x=1|y) under the nominal (non-burst) channel."""
    gcx = snr_amplitude(snr_db)
    return 1.0 / (1.0 + np.exp(-2.0 * gcx * np.asarray(y, np.float64)))
