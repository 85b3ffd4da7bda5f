from .irreps import Irrep, Irreps, MulIrrep, irreps_dim, tp_path_exists
from .wigner import irrep_d, irreps_d, rand_matrix, wigner_3j, wigner_d
from .spherical_harmonics import SphericalHarmonics, spherical_harmonics
from .tensor_product import Instruction, Linear, TensorProduct, fully_connected_tp
from .gate import Gate, activations, normalize2mom, resolve_activation
from .segment import segment_mean, segment_sum

__all__ = [
    "Irrep",
    "Irreps",
    "MulIrrep",
    "irreps_dim",
    "tp_path_exists",
    "irrep_d",
    "irreps_d",
    "rand_matrix",
    "wigner_3j",
    "wigner_d",
    "SphericalHarmonics",
    "spherical_harmonics",
    "Instruction",
    "Linear",
    "TensorProduct",
    "fully_connected_tp",
    "Gate",
    "activations",
    "normalize2mom",
    "resolve_activation",
    "segment_mean",
    "segment_sum",
]
