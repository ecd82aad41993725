"""Training and evaluation of the Error Correction Code Transformer
(``models/ecct.py``) on the MacKay 96.3.963 code under AWGN.

The recipe of the ECCT paper (arXiv:2203.14966): words of 48 uniform
source bits encoded by the code's generator (``data.ldpc_channel``), BPSK
plus unit AWGN at an Eb/N0 drawn per word from 2..7 dB (at rate 1/2 the
channel's ``snr_db`` is Eb/N0), the received word scaled to unit amplitude,
the BCE of the logits against the bits the channel flipped, Adam at lr
1e-4 decayed along a cosine to 5e-7 over the epochs (``Schedules.cosine``),
1000 batches of 128 words an epoch.  Evaluation prints the bit error rate
(over all 96 bits, as the paper counts) and the frame error rate at Eb/N0
4, 5 and 6 dB.

    python -m fgnn_tpu_torch.train.ecct --train --work-dir runs
    python -m fgnn_tpu_torch.train.ecct --model-path runs/<run>/ecct_final.ckpt

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--model-path`` names
a checkpoint to resume from when training (when it exists) and the model to
evaluate otherwise (a trainer checkpoint or a bare state dict; without one,
a seeded random init).  Each epoch writes ``ecct_latest.ckpt``, the end
``ecct_final.ckpt``, in the run's directory.

The steps (``stage_batch``, ``train_step``, ``decode_step``) are the ones
the benchmark's ECCT family runs, with the step's phase spans of
``train.ldpc``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data import device_prefetch, parity_check
from ..data.ldpc_channel import encode, snr_amplitude
from ..data.loader import to_device
from ..models import ECCT, init_weights
from ..utils.logging import MetricsWriter, init_logger
from ..utils.profiling import annotate
from .common import (
    Schedules,
    is_train_checkpoint,
    load_checkpoint,
    make_optimizer,
    mean_metrics,
    read_checkpoint,
    save_checkpoint,
    set_lr,
)

N_BITS, N_INFO = 96, 48
BASE_LR, MIN_LR = 1e-4, 5e-7
TRAIN_SNRS = (2, 3, 4, 5, 6, 7)
EVAL_SNRS = (4, 5, 6)

log = logging.getLogger(__name__)


def words(rng: np.random.RandomState, n: int, snrs) -> dict:
    """n received words: a uniform 48-bit source encoded to [s ; G s mod
    2], BPSK at amplitude 10^(snr/20) with the SNR drawn per word from
    ``snrs``, plus unit AWGN.  {y (n, 96) f32, label (n, 96) int32 (the
    codeword), snr_db (n,) f32}."""
    snr = rng.choice(np.asarray(snrs, np.float64), size=n)
    cw = encode(rng.randint(0, 2, n * N_INFO)).reshape(n, N_BITS)
    amp = np.asarray([snr_amplitude(s) for s in snr])[:, None]
    y = 2.0 * amp * (cw - 0.5) + rng.randn(n, N_BITS)
    return {"y": y.astype(np.float32), "label": cw.astype(np.int32),
            "snr_db": snr.astype(np.float32)}


def new_model(d_model: int = 128, n_layers: int = 6,
              heads: int = 8) -> ECCT:
    """ECCT of the code the words are encoded in (``parity_check``: the
    full-rank form of 96.3.963), its weights not yet drawn."""
    return ECCT(N_BITS, parity_check(), d_model, n_layers, heads)


def stage_batch(batch: dict, device) -> dict:
    """The model's input on ``device``: on the host, the received words at
    unit amplitude y / 10^(snr_db / 20) (f32) and, where the batch holds
    the sent codewords (``label``), the flips 1[(y > 0) != label] (uint8);
    then the copies, non-blocking from pinned memory on CUDA."""
    with annotate("stage"):
        y = torch.as_tensor(batch["y"], dtype=torch.float32)
        snr = torch.as_tensor(batch["snr_db"], dtype=torch.float32)
        out = {"y": y / torch.pow(10.0, snr / 20.0)[:, None]}
        if "label" in batch:
            out["flips"] = ((out["y"] > 0)
                            != (torch.as_tensor(batch["label"]) != 0)).to(
                torch.uint8)
        return to_device(out, device, non_blocking=True)


def _staged(batch: dict, device) -> dict:
    return batch if "flips" in batch else stage_batch(batch, device)


def train_step(model: ECCT, optimizer: torch.optim.Optimizer, batch: dict,
               device) -> dict:
    """One Adam step on one batch (a host batch, or one ``stage_batch``
    put on ``device``).  Returns {loss (the BCE), acc (the share of bits
    decided right)} as device scalars and leaves the gradients in the
    parameters' ``.grad``.  A ``step`` span holds ``stage`` (a host batch),
    ``forward``, ``loss``, ``backward``, ``optimizer`` and ``metrics``."""
    with annotate("step"):
        batch = _staged(batch, device)
        model.train()
        with annotate("forward"):
            logits = model(batch["y"])
        with annotate("loss"):
            flips = batch["flips"]
            loss = F.binary_cross_entropy_with_logits(
                logits.float(), flips.float())
        with annotate("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with annotate("optimizer"):
            optimizer.step()
        with annotate("metrics"):
            with torch.no_grad():
                acc = ((logits > 0) == (flips != 0)).float().mean()
        return {"loss": loss.detach(), "acc": acc}


def decode_step(model: ECCT, batch: dict, device) -> torch.Tensor:
    """The decoded words (B, 96) int32, b XOR 1[logit > 0], left on
    ``device``, in a ``decode`` span holding ``stage`` and ``forward``."""
    with annotate("decode"), torch.inference_mode():
        y = _staged(batch, device)["y"]
        with annotate("forward"):
            logits = model(y)
        return ((y > 0) ^ (logits > 0)).to(torch.int32)


def evaluate(model: ECCT, device, n_words: int, batch_size: int,
             seed: int = 1) -> dict:
    """{snr: (BER, FER)} at each of ``EVAL_SNRS`` over ``n_words`` words
    of that Eb/N0, drawn from ``seed``."""
    model = model.to(device).eval()
    out = {}
    for snr in EVAL_SNRS:
        rng = np.random.RandomState([seed, snr])
        bit_err = frame_err = done = 0
        while done < n_words:
            b = words(rng, min(batch_size, n_words - done), (snr,))
            dec = decode_step(model, b, device).cpu().numpy()
            wrong = dec != b["label"]
            bit_err += int(wrong.sum())
            frame_err += int(wrong.any(axis=1).sum())
            done += len(dec)
        out[snr] = (bit_err / (done * N_BITS), frame_err / done)
    return out


def train(args, model: ECCT, writer: MetricsWriter, model_dir: str,
          device) -> ECCT:
    """``args.n_epochs`` epochs of ``args.steps_per_epoch`` Adam steps,
    resuming from ``args.model_path`` where that checkpoint exists; each
    epoch's words are drawn from (seed, epoch), so a resumed run sees the
    words of an uninterrupted one, and staged on ``device`` from a
    prefetch thread."""
    model = model.to(device)
    optimizer = make_optimizer(model.parameters(), BASE_LR, weight_decay=0.0)
    sched = Schedules.cosine(args.n_epochs, MIN_LR / BASE_LR)
    start_epoch, gcnt = 0, 0
    if args.model_path and os.path.exists(args.model_path):
        start_epoch, gcnt = load_checkpoint(args.model_path, model,
                                            optimizer)
    for epoch in range(start_epoch, args.n_epochs):
        set_lr(optimizer, BASE_LR * sched(epoch))
        rng = np.random.RandomState([args.seed, epoch])
        t0 = time.time()
        source = (words(rng, args.batch_size, TRAIN_SNRS)
                  for _ in range(args.steps_per_epoch))
        pending = []
        with device_prefetch(source, device, put=lambda b: stage_batch(
                b, device)) as staged:
            for i, batch in enumerate(staged, start=1):
                pending.append(train_step(model, optimizer, batch, device))
                gcnt += 1
                if i % 100 == 0 or i == args.steps_per_epoch:
                    mm = mean_metrics(pending, None)
                    pending = []
                    for k in ("loss", "acc"):
                        writer.add_scalar(f"ecct_train/{k}", mm[k], gcnt)
                    log.info("epoch=%d step=%d loss=%.5f acc=%.5f", epoch,
                             gcnt, mm["loss"], mm["acc"])
        log.info("epoch %d done in %.1fs", epoch, time.time() - t0)
        save_checkpoint(os.path.join(model_dir, "ecct_latest.ckpt"), model,
                        optimizer, epoch + 1, gcnt)
    save_checkpoint(os.path.join(model_dir, "ecct_final.ckpt"), model,
                    optimizer, args.n_epochs, gcnt)
    return model


def report(ber: dict, writer=None, step: int = 0) -> None:
    for snr, (b, f) in ber.items():
        log.info("Eb/N0 %d dB: BER %.3e (-ln %.2f) FER %.3e", snr, b,
                 -np.log(max(b, 1e-300)), f)
        print(f"{snr} {b:.6e} {f:.6e}")
        if writer is not None:
            writer.add_scalar(f"ecct_eval/ber_{snr}db", b, step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fgnn_tpu_torch ECCT trainer "
                                            "and decoder")
    p.add_argument("--train", action="store_true", default=False)
    p.add_argument("--n-epochs", type=int, default=1000)
    p.add_argument("--steps-per-epoch", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--eval-words", type=int, default=100000,
                   help="words decoded at each Eb/N0 of the evaluation")
    p.add_argument("--model-path", type=str, default="",
                   help="training: the checkpoint to resume from when it "
                        "exists; evaluation: the model (empty = seeded "
                        "random init)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--work-dir", type=str, default="runs")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = init_weights(new_model(), args.seed)
    if not args.train:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s [%(levelname)s] %(message)s")
        if args.model_path:
            payload = read_checkpoint(args.model_path)
            model.load_state_dict(payload["model"] if is_train_checkpoint(
                payload) else payload)
        else:
            log.warning("no --model-path: decoding with random weights "
                        "(seed %d)", args.seed)
        report(evaluate(model, dev, args.eval_words, args.batch_size))
        return
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    work = os.path.join(args.work_dir, f"ecct_at_{stamp}")
    init_logger(os.path.join(work, "logs"), "train", print_log=True)
    log.info("%s", args)
    with MetricsWriter(os.path.join(work, "tf_logs")) as writer:
        model = train(args, model, writer, work, dev)
        report(evaluate(model, dev, args.eval_words, args.batch_size),
               writer, args.n_epochs)


if __name__ == "__main__":
    main()
