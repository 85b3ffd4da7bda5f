from .params import (
    ParamModule,
    init_parameters,
    load_jax_params,
    params_from_jax,
)
from .utils import (
    build,
    default_type_names,
    insertAfter,
    keyMap,
    pruneArgs,
)

__all__ = [
    "ParamModule",
    "init_parameters",
    "load_jax_params",
    "params_from_jax",
    "build",
    "default_type_names",
    "insertAfter",
    "keyMap",
    "pruneArgs",
]
