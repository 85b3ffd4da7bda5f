"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper holds a plain PyTorch version of its kernel, used for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.  Kernels are
built from ``csrc/`` at first use, never at import.
"""

from .full_conv import FullConv
from .pairwise_tp import PairwiseTP
from .species_sc import SpeciesScalarFCTP
from .uvu_conv import UVUConv

__all__ = ["FullConv", "PairwiseTP", "SpeciesScalarFCTP", "UVUConv"]
