from .data import Data
from .batch import Batch
from .graph_batch import GraphBatch
from .compute_edge import computeEdgeIndex, computeEdgeVector

__all__ = ["Data", "Batch", "GraphBatch", "computeEdgeIndex",
           "computeEdgeVector"]
