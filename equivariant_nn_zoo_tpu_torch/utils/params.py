"""Parameters: declaration, seeded initialisation, and loading JAX trees.

Every module of the port declares its parameters under the same nested
names and shapes as the JAX package's ``Module.init`` pytree
(``equivariant_nn_zoo_tpu/nn/module.py:102-126``), so
``model.state_dict()`` keys are the pytree paths joined with ``.`` — for
example ``layer3.conv.fc.w3`` or ``layer3.conv.tp.linear.w2_3`` — and a
JAX-initialised or JAX-trained tree loads unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ParamModule(torch.nn.Module):
    """``torch.nn.Module`` whose parameters carry an init spec:
    ``"normal"`` (N(0, 1)), ``"zeros"``, ``"ones"`` or a constant array."""

    def __init__(self):
        super().__init__()
        self._inits: Dict[str, object] = {}

    def declare(self, name: str, shape, init="normal") -> torch.nn.Parameter:
        p = torch.nn.Parameter(torch.empty(tuple(shape), dtype=torch.float32))
        self.register_parameter(name, p)
        self._inits[name] = init
        return p


@torch.no_grad()
def init_parameters(module: torch.nn.Module,
                    generator: torch.Generator) -> torch.nn.Module:
    """Fill every declared parameter from ``generator`` (a CPU generator),
    in sorted order of the full parameter names, so one seed gives the same
    weights whatever device the module lives on."""
    owners = {}
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{pname}" if mod_name else pname
            owners[full] = (getattr(mod, "_inits", {}).get(pname, "normal"), p)
    for full in sorted(owners):
        init, p = owners[full]
        if isinstance(init, str) and init == "normal":
            val = torch.randn(p.shape, generator=generator)
        elif isinstance(init, str) and init == "zeros":
            val = torch.zeros(p.shape)
        elif isinstance(init, str) and init == "ones":
            val = torch.ones(p.shape)
        elif isinstance(init, str):
            raise ValueError(f"unknown init {init!r} for {full}")
        else:
            val = torch.as_tensor(np.asarray(init, np.float32)).broadcast_to(
                p.shape)
        p.copy_(val)
    return module


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter pytree (nested dicts of numpy-convertible
    leaves) into a ``state_dict``: keys are the dict paths joined by ``.``,
    values float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}.{key}" if prefix else str(key), node[key])
            return
        out[prefix] = torch.tensor(np.array(node, dtype=np.float32))

    walk("", tree)
    return out


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter pytree into ``model``.  Raises unless the tree
    and the model's parameters match one to one, name for name and shape
    for shape."""
    state = params_from_jax(tree)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(
            f"JAX tree does not match the model: missing {missing[:8]}, "
            f"unexpected {extra[:8]}"
        )
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: JAX shape {tuple(value.shape)} != "
                f"model shape {tuple(own[name].shape)}"
            )
        own[name].copy_(value)
    return model
