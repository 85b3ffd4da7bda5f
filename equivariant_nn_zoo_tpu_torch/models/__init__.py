"""Named workload configs of the port (``config_energy``,
``config_energy_force``, ``config_dipole``, ``config_hamiltonian``,
``config_diffusion``, ``config_diffusion_CA`` and
``config_diffusion_backbone``), ``register_config`` for more of them, and
the function that builds a model from a seeded generator."""

import torch

from ..ops.cuda.build import set_kernels
from ..utils.params import init_parameters
from ..utils.utils import build
from .config_diffusion import get_config as config_diffusion
from .config_diffusion_CA import get_config as config_diffusion_CA
from .config_diffusion_backbone import get_config as config_diffusion_backbone
from .config_dipole import get_config as config_dipole
from .config_energy import get_config as config_energy
from .config_energy_force import get_config as config_energy_force
from .config_hamiltonian import get_config as config_hamiltonian
from .layer_configs import withComputeDtype

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


def register_config(name: str, fn):
    """Make ``get_config(name, spec)`` call ``fn(spec)`` (``fn()`` without a
    spec); a name already taken is replaced."""
    CONFIG_REGISTRY[name] = fn


def build_model(model_config: dict, device="cuda",
                generator: torch.Generator = None,
                kernels: bool = True) -> torch.nn.Module:
    """Build the model of ``model_config``, fill its parameters from
    ``generator`` (a CPU generator; seed 0 when omitted) and move it to
    ``device``.  The same seed gives the same weights on every device.
    ``kernels=False``: every kernel wrapper of the model takes its plain
    PyTorch version on CUDA tensors too (``ops.cuda.build.set_kernels``),
    the whole model's path without the hand-written kernels.
    ``model_config["compute_dtype"]`` (``"float32"`` or ``"bfloat16"``)
    reaches every layer that takes it (``layer_configs.withComputeDtype``;
    without the key each layer keeps its own, float32 by default); a layer
    whose kernels have no bfloat16 variant refuses bfloat16 here."""
    if "compute_dtype" in model_config:
        model_config = withComputeDtype(model_config,
                                        model_config["compute_dtype"])
    model = build(model_config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    set_kernels(model, kernels)
    return model.to(device)
