"""Named workload configs of the port (``config_energy`` and
``config_energy_force``) and the function that builds a model from a seeded
generator."""

import torch

from ..utils.params import init_parameters
from ..utils.utils import build
from .config_energy import get_config as config_energy
from .config_energy_force import get_config as config_energy_force

CONFIG_REGISTRY = {"config_energy": config_energy,
                   "config_energy_force": config_energy_force}


def get_config(name: str):
    if name not in CONFIG_REGISTRY:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(CONFIG_REGISTRY)}")
    return CONFIG_REGISTRY[name]()


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
