"""Entry points of the port: ``python -m fgnn_tpu_torch.train.ldpc``."""
