from .norm import (
    BatchNorm,
    Dense,
    InstanceNorm,
    init_weights,
    instance_norm,
    leaky_relu,
)
from .base import (
    MLP,
    Flatten,
    IIDMap,
    IIDMapBN,
    IIDMapIN,
    Identity,
    MaxPoolNodes,
    MessagePassing,
)
from .mp_conv import GConvResidual, MPConv, MPConvResidual
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
from .ecct import ECCT
from .synthetic import (
    SynFixedModel,
    SynHopFactorModel,
    SynHopFactorModelCoo,
    SynPwFactorModel,
)
from .from_jax import load_flax_variables
from .knn import (
    get_edge_feature,
    get_nn_node_feature,
    knn_graph,
    pairwise_distance,
)
from .torch_import import (
    import_factor_nn,
    import_ldpc_model,
    import_mlp,
    load_reference_state_dict,
)

__all__ = [
    "BatchNorm", "Dense", "InstanceNorm", "init_weights", "instance_norm",
    "leaky_relu", "IIDMap", "IIDMapBN", "IIDMapIN", "MLP", "MaxPoolNodes",
    "Flatten", "Identity", "MessagePassing", "MPConv", "MPConvResidual",
    "GConvResidual",
    "FactorNN", "LDPCModel", "SigmaBRegressor", "ECCT",
    "load_flax_variables",
    "IIDBlock", "MPSequential", "ParallelNet", "MPEnsemble",
    "GlobalPooling", "FactorMPNN", "SynFixedModel",
    "SynPwFactorModel", "SynHopFactorModel", "SynHopFactorModelCoo",
    "import_factor_nn", "import_mlp", "import_ldpc_model",
    "load_reference_state_dict",
    "pairwise_distance", "knn_graph", "get_nn_node_feature",
    "get_edge_feature",
]
