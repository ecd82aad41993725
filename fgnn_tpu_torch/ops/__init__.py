from .segment import (
    CooGraph,
    Segments,
    segment_logsumexp,
    segment_max,
    segment_mean,
    segment_sum,
    typed_mp_conv_coo,
)
from .typed_mp import (
    Extension,
    GatherTable,
    aggregate,
    gather_nodes,
    typed_mp_conv,
)

__all__ = ["Extension", "GatherTable", "aggregate", "gather_nodes",
           "typed_mp_conv",
           "CooGraph", "Segments", "segment_sum", "segment_max",
           "segment_mean", "segment_logsumexp", "typed_mp_conv_coo"]
