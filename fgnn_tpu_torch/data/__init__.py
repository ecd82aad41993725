from .alist import AlistMatrix, default_paths, read_alist, read_mod2mat
from .ldpc_channel import channel, encode, posteriors, snr_amplitude
from .ldpc_datasets import (
    Codes,
    ContinuousCodesSP,
    batch_to_features,
    gen_sample,
    generate_eval_set,
)
from .ldpc_graph import LDPCStructure, default_structure

__all__ = [
    "AlistMatrix", "read_alist", "read_mod2mat", "default_paths",
    "encode", "channel", "posteriors", "snr_amplitude",
    "LDPCStructure", "default_structure",
    "ContinuousCodesSP", "Codes", "batch_to_features", "gen_sample",
    "generate_eval_set",
]
