"""LDPC sample synthesis and datasets (host-side, numpy).

Counterpart of ``fgnn_tpu/data/ldpc_datasets.py``: datasets yield whole
numpy batches (dict of arrays in the (B, N, C) layout).  For one seed the
batches and eval sets are bit-identical to the JAX package's: the
``np.random.RandomState`` calls happen in the same order.

The classical sum-product baseline (``with_bp_error=True``) is not part of
the port yet; it raises (ROADMAP, port queue item 3).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .ldpc_channel import channel, encode
from .ldpc_graph import LDPCStructure, default_structure

K_INFO = 48  # information bits per block
N_CODE = 96  # transmitted bits per block

_NO_BP = ("the sum-product baseline (with_bp_error=True) is not ported yet: "
          "ROADMAP.md, port queue item 3 (ops/bp.py)")


def gen_sample(snr_db: float, sigma_b: float, *, burst_prob: float = 0.05,
               rng: Optional[np.random.RandomState] = None):
    """One received word: returns (y (96,), codeword (96,) = [s ; t])."""
    rng = rng or np.random.RandomState()
    s = rng.randint(0, 2, K_INFO)
    codeword = encode(s, K_INFO, K_INFO)
    y = channel(codeword, snr_db, sigma_b, burst_prob, rng)
    return y, codeword


def batch_to_features(ys: np.ndarray, snr_dbs: np.ndarray,
                      structure: Optional[LDPCStructure] = None):
    """Model inputs for a batch of received words (pure indexing).

    ys: (B, 96) received words; snr_dbs: (B,).
    """
    st = structure or default_structure()
    ys = np.asarray(ys, np.float32)
    B = ys.shape[0]
    snr = np.asarray(snr_dbs, np.float32).reshape(B, 1)
    hop = ys[:, st.factors]                                   # (B, 48, 6)
    ef_f2v = np.concatenate(
        [hop[:, st.var_checks],                               # (B, 96, 3, 6)
         np.broadcast_to(ys[:, :, None, None], (B, N_CODE, st.var_deg, 1))],
        axis=3).astype(np.float32)                            # (B, 96, 3, 7)
    ef_v2f = np.concatenate(
        [np.broadcast_to(hop[:, :, None, :],
                         (B, K_INFO, st.check_deg, st.check_deg)),
         hop[..., None]], axis=3).astype(np.float32)          # (B, 48, 6, 7)
    node = np.stack([ys, np.broadcast_to(snr, ys.shape)], axis=-1)

    def tile(a):
        return np.broadcast_to(a[None], (B,) + a.shape).copy()

    return {
        "node_feature": node.astype(np.float32),
        "hop_feature": hop.astype(np.float32),
        "nn_idx_f2v": tile(st.var_checks.astype(np.int32)),
        "nn_idx_v2f": tile(st.factors.astype(np.int32)),
        "efeature_f2v": ef_f2v,
        "efeature_v2f": ef_v2f,
    }


@dataclass
class ContinuousCodesSP:
    """On-the-fly bipartite LDPC batches: sigma_b ~ U{0..5}, snr ~ U{0..4}
    (or fixed), 10k samples per epoch by default."""

    length: int = 10000
    snr: Optional[int] = None
    sigma_b_choices: tuple = (0, 1, 2, 3, 4, 5)
    snr_choices: tuple = (0, 1, 2, 3, 4)
    burst_prob: float = 0.05
    seed: Optional[int] = None

    def __post_init__(self):
        self.structure = default_structure()
        self.rng = np.random.RandomState(self.seed)

    def __len__(self):
        return self.length

    def batches(self, batch_size: int) -> Iterator[dict]:
        for _ in range(self.length // batch_size):
            ys, labels, sbs, snrs = [], [], [], []
            for _ in range(batch_size):
                sigma_b = self.rng.choice(self.sigma_b_choices)
                snr_db = (self.snr if self.snr is not None
                          else self.rng.choice(self.snr_choices))
                y, codeword = gen_sample(snr_db, sigma_b,
                                         burst_prob=self.burst_prob,
                                         rng=self.rng)
                ys.append(y)
                labels.append(codeword)
                sbs.append(sigma_b)
                snrs.append(snr_db)
            feats = batch_to_features(np.stack(ys),
                                      np.asarray(snrs, np.float32),
                                      self.structure)
            feats["label"] = np.stack(labels).astype(np.int32)
            feats["sigma_b"] = np.asarray(sbs, np.float32)
            feats["snr_db"] = np.asarray(snrs, np.float32)
            yield feats


def generate_eval_set(path: str, n_per_cell: int = 1000,
                      snrs=(0, 1, 2, 3, 4), sigma_bs=(0, 1, 2, 3, 4, 5),
                      burst_prob: float = 0.05, seed: int = 0,
                      with_bp_error: bool = False):
    """Write the evaluation grid: n_per_cell words per (snr, sigma_b) cell,
    stored as one .npz.  ``bp_err_matrix`` is all zeros: the sum-product
    baseline is not ported yet, and ``with_bp_error=True`` raises."""
    if with_bp_error:
        raise NotImplementedError(_NO_BP)
    rng = np.random.RandomState(seed)
    ys, gts, snr_arr, sb_arr = [], [], [], []
    for snr_db in snrs:
        for sb in sigma_bs:
            s = rng.randint(0, 2, (n_per_cell, K_INFO))
            cw = np.stack([encode(sk, K_INFO, K_INFO) for sk in s])
            y = np.stack([
                channel(cw[k], snr_db, sb, burst_prob, rng)
                for k in range(n_per_cell)])
            ys.append(y)
            gts.append(cw)
            snr_arr.append(np.full(n_per_cell, snr_db, np.float32))
            sb_arr.append(np.full(n_per_cell, sb, np.float32))
    err_mean = np.zeros((len(snrs), len(sigma_bs)))
    data = {
        "noisy_sg": np.concatenate(ys).astype(np.float32),
        "gts": np.concatenate(gts).astype(np.int32),
        "snr_dbs": np.concatenate(snr_arr),
        "sigma_b": np.concatenate(sb_arr),
        "bp_err_matrix": err_mean,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **data)
    return err_mean


@dataclass
class Codes:
    """Pre-generated eval dataset reader, batched."""

    path: str

    def __post_init__(self):
        with np.load(self.path) as f:
            self.data = dict(f)
        self.structure = default_structure()

    def __len__(self):
        return len(self.data["noisy_sg"])

    def batches(self, batch_size: int) -> Iterator[dict]:
        n = len(self)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = slice(start, start + batch_size)
            feats = batch_to_features(self.data["noisy_sg"][idx],
                                      self.data["snr_dbs"][idx],
                                      self.structure)
            feats["label"] = self.data["gts"][idx].astype(np.int32)
            feats["sigma_b"] = self.data["sigma_b"][idx].astype(np.float32)
            feats["snr_db"] = self.data["snr_dbs"][idx].astype(np.float32)
            yield feats
