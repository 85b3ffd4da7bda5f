from .module import Module
from .sequential import SequentialGraphNetwork
from .mlp import FullyConnectedNet
from .embedding import (
    BesselBasis,
    Broadcast,
    OneHotEncoding,
    RadialBasisEncoding,
    SphericalEncoding,
)
from .pointwise import (
    Concat,
    PointwiseLinear,
    ResBlock,
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
    "SphericalEncoding",
    "PointwiseLinear",
    "Concat",
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
