"""Entry points of the port: ``python -m fgnn_tpu_torch.train.ldpc``, and
``syn_hop_factor``, ``syn_pw_factor``, ``syn_fixed_pw_hop``."""
