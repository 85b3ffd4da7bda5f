"""Reflection build, kwarg pruning, key mapping, layer-list insertion,
type names.

PyTorch-package copy of the framework-neutral helpers in
``equivariant_nn_zoo_tpu/utils/utils.py``; configs here are plain dicts.
"""

from __future__ import annotations

import inspect
from typing import Dict


def build(node: Dict, **kwargs):
    """Instantiate a layer/module from its config node {"module": cls, ...}
    plus ``kwargs``, passing the callee only the arguments it takes."""
    kwargs.update(**node)
    func = kwargs.pop("module")
    return func(**pruneArgs(func, **kwargs))


def pruneArgs(_func, **kwargs):
    """Keep the kwargs the callee's signature takes (all of them when it
    takes ``**kwargs``)."""
    arg_spec = inspect.getfullargspec(
        _func.__init__ if inspect.isclass(_func) else _func)
    if arg_spec.varkw:
        return kwargs
    pnames = inspect.signature(_func).parameters
    return {key: kwargs[key] for key in kwargs if key in pnames}


def keyMap(dic: Dict, key_mapping: Dict) -> Dict:
    """Rename dict keys (one-to-one or one-to-many)."""
    result = {}
    for key, value in dic.items():
        if key in key_mapping:
            new_key = key_mapping[key]
            if isinstance(new_key, str):
                result[new_key] = value
            else:
                for item in new_key:
                    result[item] = value
        else:
            result[key] = value
    return result


def insertAfter(lst, key, item):
    """Insert a ``(name, node)`` layer entry after the layer named ``key``."""
    for i, layer in enumerate(lst):
        if layer[0] == key:
            return lst[: i + 1] + [item] + lst[i + 1:]
    raise ValueError(f"Key {key} not found.")


ATOMIC_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt",
    "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]


def default_type_names(num_types: int = None):
    """Element symbols in atomic-number order (index 0 is a placeholder)."""
    names = ATOMIC_SYMBOLS
    return names[:num_types] if num_types else list(names)
