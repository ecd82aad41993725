"""CLI: MAP inference with fixed pairwise and budget potentials
(counterpart of ``fgnn_tpu/train/syn_fixed_pw_hop.py``).

    python -m fgnn_tpu_torch.train.syn_fixed_pw_hop [--device cpu] [flags]
"""

from . import synthetic


def main(argv=None):
    return synthetic.main("fixed", argv)


if __name__ == "__main__":
    main()
