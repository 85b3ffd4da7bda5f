"""Base class of the graph layers: irreps declaration and key mapping.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/nn/module.py``.  A layer is
a ``torch.nn.Module`` that owns its parameters (under the JAX pytree's
names, see ``utils/params.py``) and maps ``(data, attrs) -> (data, attrs)``
over plain dicts.  Each layer declares canonical field names with irreps
and optional custom data keys; ``SequentialGraphNetwork`` induces a DAG
from the key matching, exactly as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..ops.irreps import Irreps
from ..utils.params import ParamModule
from ..utils.utils import keyMap


class Module(ParamModule):
    """Static config + parameter declarations + key mapping."""

    def __init__(self):
        super().__init__()
        self.irreps_in: Dict[str, object] = {}
        self.irreps_out: Dict[str, object] = {}
        self.input_key_mapping: Dict[str, str] = {}
        self.output_key_mapping: Dict[str, str] = {}

    def init_irreps(self, output_keys=(), **kwargs):
        if isinstance(output_keys, str):
            output_keys = [output_keys]
        for key, value in kwargs.items():
            if value is None:
                continue
            if isinstance(value, (str, Irreps, int)):
                irreps, custom_key = value, key
            elif isinstance(value, (list, tuple)):
                assert len(value) == 2, f"bad irreps spec for {key}: {value}"
                irreps, custom_key = value
            else:
                continue
            if key in output_keys:
                self.irreps_out[key] = irreps
                self.output_key_mapping[key] = custom_key
            else:
                self.irreps_in[key] = irreps
                self.input_key_mapping[custom_key] = key

    def inputKeyMap(self, d: Dict) -> Dict:
        return keyMap(d, self.input_key_mapping)

    def outputKeyMap(self, d: Dict) -> Dict:
        return keyMap(d, self.output_key_mapping)

    def forward(self, data: Dict, attrs: Dict):
        raise NotImplementedError


class Lambda(Module):
    """A pure function ``(data, attrs) -> (data, attrs)`` as a layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, data: Dict, attrs: Dict):
        return self.fn(data, attrs)
