from .module import Module
from .sequential import SequentialGraphNetwork
from .mlp import FullyConnectedNet
from .embedding import (
    BesselBasis,
    OneHotEncoding,
    RadialBasisEncoding,
    SphericalEncoding,
)
from .pointwise import PointwiseLinear, TensorProductExpansion
from .scaling import PerTypeScaleShift
from .output import GradientOutput, Pooling
from .message_passing import FactorizedConvolution, MessagePassing

__all__ = [
    "Module",
    "SequentialGraphNetwork",
    "FullyConnectedNet",
    "BesselBasis",
    "OneHotEncoding",
    "RadialBasisEncoding",
    "SphericalEncoding",
    "PointwiseLinear",
    "TensorProductExpansion",
    "PerTypeScaleShift",
    "Pooling",
    "GradientOutput",
    "FactorizedConvolution",
    "MessagePassing",
]
