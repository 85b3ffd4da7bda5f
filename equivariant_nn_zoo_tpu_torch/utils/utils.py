"""Reflection build, kwarg pruning, key mapping, layer-list insertion and
replacement, the diffusion configs' scalers, parameter counts, type names.

PyTorch-package copy of the framework-neutral helpers in
``equivariant_nn_zoo_tpu/utils/utils.py``; configs here are plain dicts.
"""

from __future__ import annotations

import inspect
from typing import Dict

import numpy as np


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


def replace(lst, key, item):
    """Replace the ``(name, node)`` layer entry named ``key`` by ``item``."""
    for i, layer in enumerate(lst):
        if layer[0] == key:
            return lst[:i] + [item] + lst[i + 1:]
    raise ValueError(f"Key {key} not found.")


def getScaler(operations):
    """A batch normaliser of the diffusion configs: a list of ``(key or
    keys, op)``, applied in order, where op is ``("scale", factor)``,
    ``("shift", "mean")`` (subtract each graph's mean over its nodes) or
    ``("shift", other, sign=1)`` (add ``sign * batch[other]``).

    On a host ``Batch`` it works in numpy; on a ``GraphBatch`` in PyTorch
    on the batch's device, mask-aware (padded rows stay zero) and with no
    read back to the host."""

    def scaler(batch):
        from ..data.graph_batch import GraphBatch

        if isinstance(batch, GraphBatch):
            return _device_scale(batch, operations)
        batch = batch.clone()
        node_segment = batch.nodeSegment()
        for key, op in operations:
            if op[0] == "scale":
                keys = key if isinstance(key, (tuple, list)) else [key]
                for k in keys:
                    batch[k] = batch[k] * op[1]
            elif op[0] == "shift":
                if op[1] == "mean":
                    n_nodes = batch["_n_nodes"].reshape(-1, 1)
                    sums = np.zeros((len(n_nodes), batch[key].shape[1]))
                    np.add.at(sums, node_segment, batch[key])
                    center = sums / n_nodes
                    batch[key] = batch[key] - center[node_segment]
                elif op[1] in batch:
                    sign = op[2] if len(op) == 3 else 1
                    batch[key] = batch[key] + sign * batch[op[1]]
                else:
                    raise ValueError(f"unknown shift target {op[1]!r}")
            else:
                raise ValueError(f"unknown scaler op {op[0]!r}")
        return batch

    return scaler


def _device_scale(batch, operations):
    """``getScaler``'s operations on a ``GraphBatch``: per-graph means over
    the live nodes (segment sums by ``_node_segment``), the results masked
    by ``_node_mask``."""
    updates = {}

    def cur(k):
        return updates.get(k, batch[k])

    for key, op in operations:
        if op[0] == "scale":
            keys = key if isinstance(key, (tuple, list)) else [key]
            for k in keys:
                updates[k] = cur(k) * op[1]
        elif op[0] == "shift":
            if op[1] == "mean":
                seg, mask = batch["_node_segment"], batch["_node_mask"]
                g = batch["_graph_mask"].shape[0]
                x = cur(key) * mask
                sums = x.new_zeros((g + 1, x.shape[1])).index_add(
                    0, seg, x)[:-1]
                counts = mask.new_zeros(g + 1).index_add(
                    0, seg, mask[:, 0])[:-1]
                center = sums / counts.clamp(min=1.0)[:, None]
                centered = cur(key) - center[seg.clamp(0, g - 1)]
                updates[key] = centered * mask
            elif op[1] in updates or op[1] in batch.keys():
                sign = op[2] if len(op) == 3 else 1
                updates[key] = cur(key) + sign * cur(op[1])
            else:
                raise ValueError(f"unknown shift target {op[1]!r}")
        else:
            raise ValueError(f"unknown scaler op {op[0]!r}")
    return batch.replace(**updates)



def countParameters(params) -> int:
    """Total number of parameters of a module, or of a tree (dicts, lists
    and tuples) of tensors or arrays such as the JAX parameter tree."""
    if hasattr(params, "parameters"):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(countParameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(countParameters(v) for v in params)
    return int(np.prod(np.shape(params)))


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
