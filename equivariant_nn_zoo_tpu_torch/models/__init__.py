"""Named workload configs of the port (``config_energy``,
``config_energy_force``, ``config_dipole``, ``config_hamiltonian``,
``config_diffusion``, ``config_diffusion_CA`` and
``config_diffusion_backbone``) and the function that builds a model from a
seeded generator."""

import torch

from ..utils.params import init_parameters
from ..utils.utils import build
from .config_diffusion import get_config as config_diffusion
from .config_diffusion_CA import get_config as config_diffusion_CA
from .config_diffusion_backbone import get_config as config_diffusion_backbone
from .config_dipole import get_config as config_dipole
from .config_energy import get_config as config_energy
from .config_energy_force import get_config as config_energy_force
from .config_hamiltonian import get_config as config_hamiltonian

CONFIG_REGISTRY = {"config_energy": config_energy,
                   "config_energy_force": config_energy_force,
                   "config_dipole": config_dipole,
                   "config_hamiltonian": config_hamiltonian,
                   "config_diffusion": config_diffusion,
                   "config_diffusion_CA": config_diffusion_CA,
                   "config_diffusion_backbone": config_diffusion_backbone}


def get_config(name: str, spec=None):
    """The named config; ``spec`` selects a variant of the configs that
    have them (``config_diffusion``: ``""`` or ``"nll"``; ``config_dipole``:
``"profiling"``)."""
    if name not in CONFIG_REGISTRY:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(CONFIG_REGISTRY)}")
    if spec is None:
        return CONFIG_REGISTRY[name]()
    return CONFIG_REGISTRY[name](spec)


def build_model(model_config: dict, device="cuda",
                generator: torch.Generator = None) -> torch.nn.Module:
    """Build the model of ``model_config``, fill its parameters from
    ``generator`` (a CPU generator; seed 0 when omitted) and move it to
    ``device``.  The same seed gives the same weights on every device."""
    model = build(model_config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(device)
