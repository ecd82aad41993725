"""LDPC neural-decoder evaluation: the decode half of
``fgnn_tpu/train/ldpc.py``.

Decodes the MacKay 96.3.963 code under AWGN + burst noise and reports the
5 SNR x 6 sigma_b bit-error matrix over a pre-generated evaluation grid.

    python -m fgnn_tpu_torch.train.ldpc --model-path model.pt \\
        --test-path dataset/ldpc_valid.npz

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--model-path`` is a
port checkpoint, a ``torch.save`` of ``LDPCModel.state_dict()`` (for
example after ``models.load_flax_variables``); without it the decoder runs
a seeded random init.  Training, ``--bf16``, ``--bp-features``, ``--mesh``
and ``--workers`` are not ported yet (ROADMAP.md, port queue).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..data import Codes, generate_eval_set
from ..models import LDPCModel, init_weights

N_INFO = 48
SNRS = (0, 1, 2, 3, 4)
SIGMA_BS = (0, 1, 2, 3, 4, 5)
_INPUTS = ("node_feature", "hop_feature", "efeature_f2v", "efeature_v2f")

log = logging.getLogger(__name__)


def check_tables(model: LDPCModel, batch: dict) -> None:
    """Raise unless the batch's (host) tables are the model's code tables:
    a batch built for another parity-check matrix must not be decoded on
    this one's graph."""
    st = model.structure
    for key, ref in (("nn_idx_f2v", st.var_checks),
                     ("nn_idx_v2f", st.factors)):
        got = np.asarray(batch[key])
        if got.shape[-2:] != ref.shape or not np.array_equal(
                got, np.broadcast_to(ref, got.shape)):
            raise ValueError(f"batch {key} differs from the decoder's "
                             f"{ref.shape} table of its code structure")


def model_inputs(model: LDPCModel, batch: dict, device) -> dict:
    """Check the tables on the host, then copy the features to ``device``."""
    check_tables(model, batch)
    return {k: torch.as_tensor(batch[k]).to(device) for k in _INPUTS}


def decode_logits(model: LDPCModel, batch: dict, device) -> torch.Tensor:
    """Info-bit logits (B, 48) of one numpy batch, left on ``device``."""
    if model.training:
        raise ValueError("decoding uses the running statistics: call "
                         "model.eval() first")
    with torch.inference_mode():
        logits, _ = model(**model_inputs(model, batch, device))
    return logits


def decode_step(model: LDPCModel, batch: dict, device) -> torch.Tensor:
    """Hard decisions (B, 48) int32: bit 1 where the logit is >= 0."""
    return (decode_logits(model, batch, device) >= 0).to(torch.int32)


def load_checkpoint(path: str, model: LDPCModel) -> LDPCModel:
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        raise ValueError(
            f"{path} is not a port checkpoint (a torch.save of the model's "
            "state dict); JAX pickle checkpoints are ROADMAP.md, port queue "
            "item 7") from e
    model.load_state_dict(state)
    return model


def build_model(args) -> LDPCModel:
    model = LDPCModel(aggregator=args.aggregator)
    if args.model_path:
        return load_checkpoint(args.model_path, model)
    log.warning("no --model-path: decoding with random weights (seed %d)",
                args.seed)
    return init_weights(model, args.seed)


def evaluate(args, model: LDPCModel = None, *, device=None):
    """The BER matrix over ``args.test_path`` (generated there, without
    the sum-product baseline, when missing).  Returns (ber_total, err)."""
    dev = resolve_device(device)
    if not os.path.exists(args.test_path):
        log.info("generating eval set at %s", args.test_path)
        generate_eval_set(args.test_path, n_per_cell=args.eval_per_cell,
                          with_bp_error=False)
    ds = Codes(args.test_path)
    if model is None:
        model = build_model(args)
    model = model.to(dev).eval()

    # every batch is queued on the device first; one copy back at the end
    preds, hosts = [], []
    for batch in ds.batches(args.batch_size):
        preds.append(decode_step(model, batch, dev))
        hosts.append({k: batch[k] for k in ("label", "snr_db", "sigma_b")})
    preds = torch.stack(preds).cpu().numpy() if preds else []

    acc_cnt = np.zeros((len(SNRS), len(SIGMA_BS)))
    acc_tot = np.zeros((len(SNRS), len(SIGMA_BS)))
    correct = total = 0
    for pred, hb in zip(preds, hosts):
        label = hb["label"][:, :N_INFO]
        for i, s in enumerate(SNRS):
            for j, b in enumerate(SIGMA_BS):
                sel = ((np.abs(hb["snr_db"] - s) < 1e-3)
                       & (hb["sigma_b"].astype(int) == b))
                acc_cnt[i, j] += np.sum(pred[sel, :N_INFO] == label[sel])
                acc_tot[i, j] += sel.sum() * N_INFO
        correct += np.sum(pred[:, :N_INFO] == label)
        total += label.size
    ber_total = 1.0 - correct / max(total, 1)
    err = 1.0 - np.divide(acc_cnt, np.maximum(acc_tot, 1))
    print(ber_total)
    print(np.array_str(err, precision=4, suppress_small=True))
    with np.load(args.test_path) as f:
        bp = f["bp_err_matrix"] if "bp_err_matrix" in f else None
    if bp is not None and bp.any():
        print("sum-product baseline:")
        print(np.array_str(bp, precision=4, suppress_small=True))
    return ber_total, err


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fgnn_tpu_torch LDPC decoder")
    p.add_argument("--model-path", "--model_path", type=str, default="",
                   help="port checkpoint (torch.save of the state dict); "
                        "empty = seeded random init")
    p.add_argument("--test-path", "--test_path", type=str,
                   default="dataset/ldpc_valid.npz")
    p.add_argument("--batch-size", "--batch_size", type=int, default=32)
    p.add_argument("--aggregator", type=str, default="max")
    p.add_argument("--eval-per-cell", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log.info("%s", args)
    evaluate(args, device=args.device)


if __name__ == "__main__":
    main()
