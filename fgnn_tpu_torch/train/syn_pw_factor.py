"""CLI: MAP inference with learned pairwise factors
(counterpart of ``fgnn_tpu/train/syn_pw_factor.py``).

    python -m fgnn_tpu_torch.train.syn_pw_factor [--device cpu] [flags]
"""

from . import synthetic


def main(argv=None):
    return synthetic.main("pw", argv)


if __name__ == "__main__":
    main()
