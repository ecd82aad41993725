"""CLI: MAP inference with learned pairwise and budget (hop) factors
(counterpart of ``fgnn_tpu/train/syn_hop_factor.py``).

    python -m fgnn_tpu_torch.train.syn_hop_factor [--device cpu] [flags]
"""

from . import synthetic


def main(argv=None):
    return synthetic.main("hop", argv)


if __name__ == "__main__":
    main()
