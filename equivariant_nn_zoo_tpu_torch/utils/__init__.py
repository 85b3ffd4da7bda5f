from .params import (
    ParamModule,
    init_parameters,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from .saveload import (
    atomic_write,
    atomic_write_group,
    finish_all_writes,
    load_file,
    restore_checkpoint,
    save_checkpoint,
    save_file,
    saveMol,
    saveProtein,
)
from .statistics import bincount, solver
from .utils import (
    build,
    default_type_names,
    getScaler,
    insertAfter,
    keyMap,
    pruneArgs,
    replace,
)

__all__ = [
    "ParamModule",
    "init_parameters",
    "load_jax_params",
    "params_from_jax",
    "params_to_jax",
    "atomic_write",
    "atomic_write_group",
    "finish_all_writes",
    "load_file",
    "restore_checkpoint",
    "save_checkpoint",
    "save_file",
    "saveMol",
    "saveProtein",
    "bincount",
    "solver",
    "build",
    "default_type_names",
    "getScaler",
    "insertAfter",
    "keyMap",
    "pruneArgs",
    "replace",
]
