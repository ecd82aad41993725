from .norm import BatchNorm, Dense, init_weights, instance_norm, leaky_relu
from .base import IIDMap, IIDMapBN, IIDMapIN, MLP
from .mp_conv import MPConv, MPConvResidual
from .factor_nn import FactorNN
from .ldpc_model import LDPCModel, SigmaBRegressor
from .from_jax import load_flax_variables

__all__ = [
    "BatchNorm", "Dense", "init_weights", "instance_norm", "leaky_relu",
    "IIDMap", "IIDMapBN", "IIDMapIN", "MLP", "MPConv", "MPConvResidual",
    "FactorNN", "LDPCModel", "SigmaBRegressor", "load_flax_variables",
]
