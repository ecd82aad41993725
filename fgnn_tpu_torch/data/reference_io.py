"""Readers of the reference framework's dataset files (counterpart of
``fgnn_tpu/data/reference_io.py``).

* **RPGM pickle streams**: one pickled tuple per sample, concatenated in
  one file, channel-first:

    raw:  (node_feature (2, L), assign (L,), assign1 (L,))
    pws:  (node_feature (2, L), pws (4, L, 1), assign, assign1)
    hops: (node_feature (2, L), pws (4, L, 1), efeature_hop (h, L, 1),
           assign, assign1)

  (the pairwise slot holds the raw to-right potentials, the values the
  port's generators store as the zero-padded ``pws (L, 4)`` array).

* **LDPC eval dicts**: a ``torch.save`` of a dict with keys ``noizy_sg``
  (sic) or ``noisy_sg``, ``gts``, ``snr_dbs``, ``sigma_b``.

Both convert to the channels-last .npz layouts that
``data.generate.NpzRPGMData`` and ``data.ldpc_datasets.Codes`` read;
``python -m fgnn_tpu_torch.data.reference_io`` is the conversion CLI.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np

__all__ = [
    "read_reference_rpgm",
    "convert_reference_rpgm",
    "read_reference_ldpc_pt",
    "convert_reference_ldpc_pt",
]


def _iter_pickles(path: str, size: Optional[int] = None):
    n = 0
    with open(path, "rb") as f:
        while size is None or n < size:
            try:
                yield pickle.load(f)
            except EOFError:
                return
            n += 1


def read_reference_rpgm(path: str, pgm_type: str,
                        size: Optional[int] = None) -> dict:
    """A pickle-stream RPGM dataset in the port's .npz layout:
    ``node_feature (N, L, 2)``, ``label``/``lp_label (N, L)``, plus
    ``pws (N, L, 4)`` (pws, hops) and ``efeature_hop (N, L, h)`` (hops)."""
    nfs, pws, hops, labels, lps = [], [], [], [], []
    for item in _iter_pickles(path, size):
        if pgm_type == "raw":
            nf, assign, assign1 = item
        elif pgm_type == "pws":
            nf, pw, assign, assign1 = item
            pws.append(np.asarray(pw, np.float32).squeeze(-1).T)  # (L, 4)
        elif pgm_type == "hops":
            nf, pw, hop, assign, assign1 = item
            pws.append(np.asarray(pw, np.float32).squeeze(-1).T)
            hops.append(np.asarray(hop, np.float32).squeeze(-1).T)  # (L, h)
        else:
            raise ValueError(f"unknown pgm_type {pgm_type!r}")
        nfs.append(np.asarray(nf, np.float32).T)                  # (L, 2)
        labels.append(np.asarray(assign, np.int64))
        lps.append(np.asarray(assign1, np.int64))
    if not nfs:
        raise ValueError(f"no samples found in {path}")
    out = {
        "node_feature": np.stack(nfs),
        "label": np.stack(labels),
        "lp_label": np.stack(lps),
    }
    if pws:
        out["pws"] = np.stack(pws)
    if hops:
        out["efeature_hop"] = np.stack(hops)
    return out


def convert_reference_rpgm(path: str, pgm_type: str, out: str,
                           size: Optional[int] = None) -> dict:
    """Pickle stream -> .npz that ``NpzRPGMData`` reads (the synthetic
    trainers' ``--train-path``/``--test-path``)."""
    data = read_reference_rpgm(path, pgm_type, size)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **data)
    return data


def read_reference_ldpc_pt(path: str) -> dict:
    """A reference LDPC eval dict (``torch.save``) in the port's eval-npz
    keys: ``noisy_sg (N, 96)``, ``gts (N, 96)``, ``snr_dbs (N,)`` (a
    per-bit ``(N, 96)`` collapsed to one value a word) and
    ``sigma_b (N,)``."""
    import torch

    d = torch.load(path, map_location="cpu", weights_only=False)
    noisy = d["noizy_sg"] if "noizy_sg" in d else d["noisy_sg"]

    def _np(x):
        if isinstance(x, (list, tuple)):
            return np.stack([_np(v) for v in x])
        return x.numpy() if hasattr(x, "numpy") else np.asarray(x)

    noisy = _np(noisy).astype(np.float32).reshape(len(noisy), -1)
    gts = _np(d["gts"]).astype(np.int32).reshape(len(noisy), -1)
    snr = _np(d["snr_dbs"]).astype(np.float32).reshape(len(noisy), -1)[:, 0]
    sigma_b = _np(d["sigma_b"]).astype(np.float32).reshape(-1)
    return {"noisy_sg": noisy, "gts": gts, "snr_dbs": snr,
            "sigma_b": sigma_b}


def convert_reference_ldpc_pt(path: str, out: str) -> dict:
    """Reference .pt eval dict -> .npz that ``Codes`` reads."""
    data = read_reference_ldpc_pt(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **data)
    return data


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert reference-framework dataset files to the "
                    "fgnn_tpu_torch .npz layouts")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("rpgm", help="pickle stream -> NpzRPGMData npz")
    pr.add_argument("path")
    pr.add_argument("--type", choices=["raw", "pws", "hops"], required=True)
    pr.add_argument("--size", type=int, default=None)
    pr.add_argument("--out", required=True)
    pl = sub.add_parser("ldpc", help="torch .pt eval dict -> Codes npz")
    pl.add_argument("path")
    pl.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "rpgm":
        d = convert_reference_rpgm(args.path, args.type, args.out, args.size)
    else:
        d = convert_reference_ldpc_pt(args.path, args.out)
    n = len(next(iter(d.values())))
    print(f"wrote {n} samples to {args.out} ({sorted(d)})")


if __name__ == "__main__":
    main()
