"""The model zoo under the import path ``configs`` as well as ``models``:
the same names as ``equivariant_nn_zoo_tpu/configs/__init__.py``."""

from ..models import (  # noqa: F401
    CONFIG_REGISTRY,
    config_diffusion,
    config_diffusion_CA,
    config_diffusion_backbone,
    config_dipole,
    config_energy,
    config_energy_force,
    config_hamiltonian,
    get_config,
    layer_configs,
    register_config,
)
