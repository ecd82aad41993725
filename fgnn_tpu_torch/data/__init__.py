from .alist import AlistMatrix, default_paths, read_alist, read_mod2mat
from .bp_ref import BPGraph, bp_decode, decode_posteriors
from .ldpc_channel import channel, encode, posteriors, snr_amplitude
from .ldpc_datasets import (
    Codes,
    ContinuousCodesJoint,
    ContinuousCodesSP,
    batch_to_features,
    decode_graph,
    gen_sample,
    generate_eval_set,
    sample_to_features,
)
from .ldpc_graph import (
    LDPCStructure,
    code_mask,
    default_structure,
    parity_check,
    syndrome,
)
from .rpgm import (
    BucketedHopData,
    MixedLengthHopData,
    RandomPGM,
    RandomPGMHop,
    RandomPGMNoHop,
    RandomPGMPw,
    RandomPGMPwNoHop,
    batches,
)
from .loader import PoolBatcher, Prefetcher, device_prefetch, prefetch
from .rpgm_oracle import (
    brute_force_chain_budget,
    lp_relaxation_chain_budget,
    map_chain_budget,
)
from . import ldpc_cpp
from .tables import (
    chain_knn_table,
    global_factor_table,
    high_factor_table,
    pw_factor_table,
)

__all__ = [
    "AlistMatrix", "read_alist", "read_mod2mat", "default_paths",
    "encode", "channel", "posteriors", "snr_amplitude",
    "BPGraph", "bp_decode", "decode_posteriors", "decode_graph",
    "Prefetcher", "prefetch", "device_prefetch", "PoolBatcher",
    "LDPCStructure", "default_structure", "parity_check", "code_mask",
    "syndrome",
    "ContinuousCodesSP", "ContinuousCodesJoint", "Codes",
    "batch_to_features", "sample_to_features", "gen_sample",
    "generate_eval_set",
    "RandomPGM", "RandomPGMNoHop", "RandomPGMPw", "RandomPGMPwNoHop",
    "RandomPGMHop", "MixedLengthHopData", "BucketedHopData", "batches",
    "chain_knn_table", "pw_factor_table", "high_factor_table",
    "global_factor_table", "map_chain_budget", "brute_force_chain_budget",
    "lp_relaxation_chain_budget", "ldpc_cpp",
]
