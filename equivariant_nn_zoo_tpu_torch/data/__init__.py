from .data import Data
from .batch import Batch
from .graph_batch import GraphBatch
from .compute_edge import computeEdgeIndex, computeEdgeVector
from .dataset import CondensedDataset
from .dataloader import (
    Collater,
    DataLoader,
    estimate_capacities,
    getDataIters,
    shard_paths,
)

__all__ = ["Data", "Batch", "GraphBatch", "computeEdgeIndex",
           "computeEdgeVector", "CondensedDataset", "Collater", "DataLoader",
           "estimate_capacities", "getDataIters", "shard_paths"]
