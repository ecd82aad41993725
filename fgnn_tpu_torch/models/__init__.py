from .norm import BatchNorm, Dense, init_weights, instance_norm, leaky_relu
from .base import IIDMap, IIDMapBN, IIDMapIN, MLP
from .mp_conv import MPConv, MPConvResidual
from .containers import (
    GlobalPooling,
    IIDBlock,
    MPEnsemble,
    MPSequential,
    ParallelNet,
)
from .factor_nn import FactorNN
from .factor_mpnn import FactorMPNN
from .ldpc_model import LDPCModel, SigmaBRegressor
from .synthetic import (
    SynFixedModel,
    SynHopFactorModel,
    SynHopFactorModelCoo,
    SynPwFactorModel,
)
from .from_jax import load_flax_variables
from .torch_import import (
    import_factor_nn,
    import_ldpc_model,
    import_mlp,
    load_reference_state_dict,
)

__all__ = [
    "BatchNorm", "Dense", "init_weights", "instance_norm", "leaky_relu",
    "IIDMap", "IIDMapBN", "IIDMapIN", "MLP", "MPConv", "MPConvResidual",
    "FactorNN", "LDPCModel", "SigmaBRegressor", "load_flax_variables",
    "IIDBlock", "MPSequential", "ParallelNet", "MPEnsemble",
    "GlobalPooling", "FactorMPNN", "SynFixedModel",
    "SynPwFactorModel", "SynHopFactorModel", "SynHopFactorModelCoo",
    "import_factor_nn", "import_mlp", "import_ldpc_model",
    "load_reference_state_dict",
]
