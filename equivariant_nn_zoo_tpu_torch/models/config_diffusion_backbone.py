"""VP-SDE score model over a protein's four backbone atoms (CA, C, O, N),
as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/config_diffusion_backbone.py``:
``config_diffusion_CA``'s model and settings with all four atoms kept by
the crop and diffused, chained shift scalers that express N and C relative
to CA and O relative to C (before the CA mean shift and the scale; the
inverse undoes them in the opposite order), and the backbone vectors mixed
into the node features after ``layer3`` (``concat3``).
"""

from ..utils.utils import getScaler
from .config_diffusion_CA import STD, protein_config


def get_config(spec=None, num_layers=None):
    return protein_config(
        spec, {"CA": 3, "C": 3, "O": 3, "N": 3},
        getScaler([
            ("O", ("shift", "C", -1)),
            ("C", ("shift", "CA", -1)),
            ("N", ("shift", "CA", -1)),
            ("CA", ("shift", "mean")),
            (["CA", "C", "N", "O"], ("scale", 1 / STD)),
        ]),
        getScaler([
            (["C", "CA", "N", "O"], ("scale", STD)),
            ("C", ("shift", "CA")),
            ("N", ("shift", "CA")),
            ("O", ("shift", "C")),
        ]),
        keep_atoms=("CA", "C", "O", "N"), backbone=True,
        num_layers=num_layers)
