"""Metrics: mae / rmse per key, with PerSpecies / PerAtom variants, masked
running accumulation and flattening for logs.

PyTorch counterpart of ``RunningStats`` and ``Metrics`` in
``equivariant_nn_zoo_tpu/run/metrics.py``.  Per-batch partial sums stay on
the device and are summed on the host only at result time.
"""

from __future__ import annotations

import json
from copy import deepcopy
from hashlib import sha1
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .loss import find_loss_function

metrics_to_reduction = {"mae": "mean", "mean": "mean", "rmse": "rms"}


class RunningStats:
    """Masked running mean / rms over batches, optionally binned by
    species."""

    def __init__(self, reduction: str = "mean", accumulate_bins=None):
        if reduction not in ("mean", "rms"):
            raise ValueError(f"reduction {reduction!r}")
        self.reduction = reduction
        self.bins = accumulate_bins
        self.reset()

    def reset(self):
        self._sums = []
        self._counts = []

    def accumulate_batch(self, values, weights, accumulate_by=None):
        """values / weights ``[N, ...]``; accumulate_by ``[N]`` int bins or
        None.  Returns the batch's own value (mean, or per-bin sums)."""
        values = values.detach()
        weights = weights.detach()
        if self.reduction == "rms":
            values = values * values
        filled = weights * torch.ones_like(values)
        if accumulate_by is None:
            s = (values * weights).sum()
            c = filled.sum()
            disp = s / torch.clamp(c, min=1.0)
        else:
            s = values.new_zeros(self.bins).index_add(
                0, accumulate_by, (values * weights).reshape(
                    values.shape[0], -1).sum(1))
            c = values.new_zeros(self.bins).index_add(
                0, accumulate_by, filled.reshape(values.shape[0], -1).sum(1))
            disp = s
        self._sums.append(s)
        self._counts.append(c)
        return disp

    def current_result(self):
        if not self._sums:
            return np.float32(0.0)
        s = torch.stack(self._sums).sum(0).cpu().double().numpy()
        c = torch.stack(self._counts).sum(0).cpu().double().numpy()
        out = s / np.maximum(c, 1.0)
        if self.reduction == "rms":
            out = np.sqrt(out)
        return out.astype(np.float32)


class Metrics:
    """``components``: a list of ``key``, ``(key, reduction)`` or ``(key,
    reduction, params)``, or a dict ``{key: [reductions]}``; ``__call__``
    accumulates a batch, ``current_result`` and ``flatten_metrics`` read
    them out."""

    NUM_TYPES = 200

    def __init__(self, components: Sequence[
            Union[Tuple[str, str], Tuple[str, str, dict]]]):
        self.running_stats = {}
        self.params = {}
        self.funcs = {}
        if hasattr(components, "items"):
            flat = []
            for key, reductions in components.items():
                for r in reductions:
                    flat.append((key, r) if isinstance(r, str) else (key, *r))
            components = flat
        for component in components:
            key, reduction, params = Metrics.parse(component)
            params["PerSpecies"] = params.get("PerSpecies", False)
            params["PerAtom"] = params.get("PerAtom", False)
            param_hash = Metrics.hash_component(component)
            functional = params.get("functional", "L1Loss")
            if key not in self.running_stats:
                self.running_stats[key] = {}
                self.funcs[key] = find_loss_function(functional, {})
                self.params[key] = {}
            self.params[key][param_hash] = (reduction, params)
            self.running_stats[key][param_hash] = RunningStats(
                reduction=metrics_to_reduction.get(reduction, reduction),
                accumulate_bins=self.NUM_TYPES if params["PerSpecies"]
                else None,
            )

    @staticmethod
    def hash_component(component):
        buffer = json.dumps(_plain(component), sort_keys=True).encode()
        return sha1(buffer).hexdigest()

    @staticmethod
    def parse(component):
        reduction, params = "mae", {}
        if isinstance(component, str):
            key = component
        elif len(component) == 1:
            key = component[0]
        elif len(component) == 2:
            key, reduction = component
        elif len(component) == 3:
            key, reduction, _params = component
            params = {k: deepcopy(v) for k, v in _params.items()}
        else:
            raise ValueError(f"tuple should have a max length of 3 but "
                             f"{len(component)} is given")
        return key, reduction, params

    def __call__(self, pred: dict, ref: dict):
        out = {}
        with torch.no_grad():
            for key, func in self.funcs.items():
                if hasattr(func, "raw"):
                    error, weights = func.raw(pred, ref, key)
                else:
                    error = func(pred=pred, ref=ref, key=key, mean=False)
                    weights = torch.ones_like(error)
                for param_hash, (_, params) in self.params[key].items():
                    accumulate_by = None
                    if params["PerSpecies"]:
                        accumulate_by = pred["atom_types"].reshape(-1).long()
                    error_n = error
                    if params["PerAtom"]:
                        N = ref["_n_nodes"].reshape(
                            error.shape[:-1] + (1,)).to(error.dtype)
                        error_n = error / torch.clamp(N, min=1.0)
                    out[(key, param_hash)] = self.running_stats[key][
                        param_hash].accumulate_batch(error_n, weights,
                                                     accumulate_by)
        return out

    def reset(self):
        for stats in self.running_stats.values():
            for stat in stats.values():
                stat.reset()

    def current_result(self):
        return {
            (key, h): stat.current_result()
            for key, stats in self.running_stats.items()
            for h, stat in stats.items()
        }

    def flatten_metrics(self, metrics, type_names=None):
        """``{name: float}`` for logs: ``<key>[/N]_<reduction>``, and per
        species ``<type>_<key>_<reduction>`` plus their mean ``psavg_*``."""
        flat_dict = {}
        skip_keys = []
        for (key, param_hash), value in metrics.items():
            reduction, params = self.params[key][param_hash]
            suffix = "/N" if params["PerAtom"] else ""
            item_name = f"{key}{suffix}_{reduction}"
            value = np.asarray(value)
            if params["PerSpecies"]:
                names = type_names or [str(i) for i in range(len(value))]
                present = value != 0
                for id_ele, v in enumerate(value.flatten()):
                    if id_ele < len(names) and present.flatten()[id_ele]:
                        flat_dict[f"{names[id_ele]}_{item_name}"] = float(v)
                nz = value[present] if present.any() else value
                flat_dict[f"psavg_{item_name}"] = float(np.mean(nz))
            elif value.ndim == 0:
                flat_dict[item_name] = float(value)
            else:
                for idx, v in enumerate(value.flatten()):
                    flat_dict[f"{item_name}_{idx}"] = float(v)
        return flat_dict, skip_keys


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    return x if isinstance(x, (str, int, float, bool, type(None))) else str(x)
