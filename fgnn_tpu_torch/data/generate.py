"""Dataset writer CLIs and the reader of written RPGM datasets
(counterpart of ``fgnn_tpu/data/generate.py``).

  * RPGM: ``python -m fgnn_tpu_torch.data.generate rpgm --type hops
    --size 900000 --out synthetic_data/hops_train.npz``: worker processes
    over the exact DP and LP oracles write one compressed .npz;
  * LDPC eval grid: ``python -m fgnn_tpu_torch.data.generate ldpc --out
    dataset/ldpc_valid.npz``: 5 SNR x 6 sigma_b x n words, with the
    classical sum-product decoder's error matrix, which it prints.

For one seed and size both files are the JAX package's writers' to the
bit.  ``NpzRPGMData`` reads an RPGM file back in batches (the synthetic
trainers' ``--train-path`` and ``--test-path``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _rpgm_worker(args):
    which, seed, count, kw = args
    from . import rpgm

    cls = {"raw": rpgm.RandomPGM, "pws": rpgm.RandomPGMPw,
           "hops": rpgm.RandomPGMHop}[which]
    ds = cls(seed=seed, **kw)
    items = [ds.sample() for _ in range(count)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def generate_rpgm(out: str, pgm_type: str, size: int, chain_length: int = 30,
                  hop_cap: int = 5, hop_order: int = 9, workers: int = 0,
                  seed: int = 0) -> dict:
    """Write ``size`` samples of ``pgm_type`` (raw, pws or hops) to
    ``out``: worker w draws its share from seed ``seed + w + 1``."""
    workers = workers or (os.cpu_count() or 8)
    kw: dict = {"chain_length": chain_length, "hop_order": hop_order}
    if pgm_type == "raw":
        kw["cap"] = hop_cap
    elif pgm_type == "pws":
        kw.update(cap=hop_cap, ret_efeature=False)
    elif pgm_type == "hops":
        kw["ret_efeature_pw"] = False
    else:
        raise ValueError(f"unknown pgm_type {pgm_type!r}")

    per = -(-size // workers)
    jobs = [(pgm_type, seed + w + 1, min(per, size - w * per), kw)
            for w in range(workers) if size - w * per > 0]
    t0 = time.time()
    from .loader import worker_context

    with worker_context().Pool(len(jobs)) as pool:
        parts = pool.map(_rpgm_worker, jobs)
    data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"wrote {size} {pgm_type} samples to {out} "
          f"in {time.time() - t0:.1f}s ({len(jobs)} workers)")
    return data


class NpzRPGMData:
    """Reader of a written RPGM dataset, in batched dicts."""

    def __init__(self, path: str, size: int | None = None):
        with np.load(path) as f:
            self.data = dict(f)
        n = len(self.data["node_feature"])
        self.size = min(size or n, n)

    def __len__(self):
        return self.size

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0):
        """Every whole batch of the first ``size`` samples, in an order
        shuffled by ``seed`` (or in file order)."""
        idx = np.arange(self.size)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        for s in range(0, self.size - batch_size + 1, batch_size):
            sel = idx[s: s + batch_size]
            yield {k: v[sel] for k, v in self.data.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="fgnn_tpu_torch dataset writers")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("rpgm")
    pr.add_argument("--type", choices=["raw", "pws", "hops"], default="hops")
    pr.add_argument("--size", type=int, default=90000)
    pr.add_argument("--chain-length", type=int, default=30)
    pr.add_argument("--hop-cap", type=int, default=5)
    pr.add_argument("--hop-order", type=int, default=9)
    pr.add_argument("--workers", type=int, default=0)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", required=True)
    pl = sub.add_parser("ldpc")
    pl.add_argument("--n-per-cell", type=int, default=1000)
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.cmd == "rpgm":
        generate_rpgm(args.out, args.type, args.size, args.chain_length,
                      args.hop_cap, args.hop_order, args.workers, args.seed)
    else:
        from .ldpc_datasets import generate_eval_set

        err = generate_eval_set(args.out, n_per_cell=args.n_per_cell,
                                seed=args.seed)
        print("sum-product baseline error matrix (rows snr 0-4, cols "
              "sigma_b 0-5):")
        print(np.array_str(err, precision=4, suppress_small=True))


if __name__ == "__main__":
    main()
