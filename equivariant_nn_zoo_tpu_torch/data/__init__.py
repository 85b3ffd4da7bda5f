from .data import Data
from .batch import Batch
from .graph_batch import GraphBatch
from .compute_edge import (
    EdgeRandom,
    chain_criteria_device,
    computeEdgeIndex,
    computeEdgeIndexDevice,
    computeEdgeVector,
    radius_graph_fixed,
)
from .dataset import CondensedDataset
from .dataloader import (
    Collater,
    DataLoader,
    estimate_capacities,
    getDataIters,
    shard_paths,
)

__all__ = ["Data", "Batch", "GraphBatch", "EdgeRandom",
           "chain_criteria_device", "computeEdgeIndex",
           "computeEdgeIndexDevice", "computeEdgeVector",
           "radius_graph_fixed", "CondensedDataset", "Collater", "DataLoader",
           "estimate_capacities", "getDataIters", "shard_paths"]
