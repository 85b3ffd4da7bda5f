from .module import Module
from .sequential import SequentialGraphNetwork
from .mlp import FullyConnectedNet
from .embedding import (
    BesselBasis,
    Broadcast,
    OneHotEncoding,
    RadialBasisEncoding,
    RelativePositionEncoding,
    SphericalEncoding,
    symmetric_cutoff,
)
from .pointwise import (
    Concat,
    LayerNormalization,
    PointwiseLinear,
    ResBlock,
    Split,
    TensorProductExpansion,
)
from .scaling import PerTypeScaleShift
from .output import (
    GradientOutput,
    Pairwise,
    Pooling,
    TensorProductContraction,
)
from .message_passing import FactorizedConvolution, MessagePassing

__all__ = [
    "Module",
    "SequentialGraphNetwork",
    "FullyConnectedNet",
    "BesselBasis",
    "Broadcast",
    "OneHotEncoding",
    "RadialBasisEncoding",
    "RelativePositionEncoding",
    "SphericalEncoding",
    "symmetric_cutoff",
    "PointwiseLinear",
    "LayerNormalization",
    "Concat",
    "Split",
    "TensorProductExpansion",
    "ResBlock",
    "PerTypeScaleShift",
    "Pooling",
    "GradientOutput",
    "Pairwise",
    "TensorProductContraction",
    "FactorizedConvolution",
    "MessagePassing",
]
