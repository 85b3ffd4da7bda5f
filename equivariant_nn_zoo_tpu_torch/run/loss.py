"""Loss system: reflection by name, per-atom / per-species wrappers, NaN
masking, coefficient-weighted multi-key totals, running stats.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/run/loss.py``.  Every
reduction is a masked mean over the batch's ``_graph_mask`` /
``_node_mask`` / ``_edge_mask``, so padding never reaches the loss.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Union

import torch


def _elementwise(func_name: str, pred, ref):
    if func_name == "MSELoss":
        return (pred - ref) ** 2
    if func_name == "L1Loss":
        return torch.abs(pred - ref)
    if func_name == "HuberLoss":
        d = pred - ref
        a = torch.abs(d)
        return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)
    raise NotImplementedError(f"loss function {func_name!r}")


def _mask_for(key: str, ref: Dict):
    """The padding mask whose leading shape matches the key's."""
    if key not in ref:
        return None
    lead = ref[key].shape[:-1]
    for mk in ("_graph_mask", "_node_mask", "_edge_mask"):
        if mk in ref and ref[mk].shape[:-1] == lead:
            return ref[mk]
    return None


class SimpleLoss:
    def __init__(self, func_name: str, params: dict = {}):
        params = dict(params)
        self.ignore_nan = params.pop("ignore_nan", False)
        self.func_name = func_name

    def raw(self, pred, ref, key):
        p, r = pred[key], ref[key]
        if self.ignore_nan:
            not_nan = torch.isfinite(r).to(p.dtype)
            loss = _elementwise(self.func_name, p, torch.nan_to_num(r)) \
                * not_nan
        else:
            not_nan = torch.ones_like(p)
            loss = _elementwise(self.func_name, p, r)
        mask = _mask_for(key, ref)
        if mask is not None:
            loss = loss * mask
            not_nan = not_nan * mask
        return loss, not_nan

    def __call__(self, pred: dict, ref: dict, key: str, mean: bool = True):
        loss, not_nan = self.raw(pred, ref, key)
        if mean:
            return loss.sum() / torch.clamp(not_nan.sum(), min=1.0)
        return loss


class PerAtomLoss(SimpleLoss):
    """Graph-level loss normalized by atom count (squared for MSE)."""

    def __call__(self, pred: dict, ref: dict, key: str, mean: bool = True):
        loss, not_nan = self.raw(pred, ref, key)
        N = ref["_n_nodes"].reshape(loss.shape[:-1] + (1,)).to(loss.dtype)
        N = torch.clamp(N, min=1.0)
        loss = loss / N
        if self.func_name == "MSELoss":
            loss = loss / N
        if mean:
            return loss.sum() / torch.clamp(not_nan.sum(), min=1.0)
        return loss


class PerSpeciesLoss(SimpleLoss):
    """Average within each species, then across species (species ids
    bucketed into a fixed 200-bin count)."""

    NUM_TYPES = 200

    def __call__(self, pred: dict, ref: dict, key: str, mean: bool = True):
        if not mean:
            raise NotImplementedError("PerSpeciesLoss requires mean=True")
        loss, not_nan = self.raw(pred, ref, key)
        per_atom = loss.reshape(loss.shape[0], -1).sum(1)
        weight = not_nan.reshape(not_nan.shape[0], -1).amax(1)
        spe = pred["atom_types"].reshape(-1).long()
        sums = per_atom.new_zeros(self.NUM_TYPES).index_add(0, spe, per_atom)
        counts = weight.new_zeros(self.NUM_TYPES).index_add(0, spe, weight)
        present = (counts > 0).to(loss.dtype)
        per_species = sums / torch.clamp(counts, min=1.0)
        return (per_species * present).sum() / torch.clamp(present.sum(),
                                                           min=1.0)


def find_loss_function(name, params):
    """Prefix dispatch: ``PerSpecies*`` / ``PerAtom*`` wrappers."""
    wrapper_list = dict(perspecies=PerSpeciesLoss, peratom=PerAtomLoss)
    if isinstance(name, str):
        for key in wrapper_list:
            if name.lower().startswith(key):
                return wrapper_list[key](name[len(key):], params)
        return SimpleLoss(name, params)
    if inspect.isclass(name):
        return name(params) if params else name()
    if callable(name):
        return name
    raise NotImplementedError(f"{name} Loss is not implemented")


class Loss:
    """Coefficient-weighted multi-key loss (the JAX package's grammar:
    ``{key: coeff | func | [coeff, func, params] | [func, params]}``, a
    key or a list of keys)."""

    def __init__(self, coeffs: Union[dict, str, List[str]],
                 coeff_schedule: str = "constant"):
        self.coeff_schedule = coeff_schedule
        self.coeffs = {}
        self.funcs = {}
        self.keys = []
        mseloss = find_loss_function("MSELoss", {})
        if isinstance(coeffs, str):
            self.coeffs[coeffs] = 1.0
            self.funcs[coeffs] = mseloss
        elif isinstance(coeffs, (list, tuple)):
            for key in coeffs:
                self.coeffs[key] = 1.0
                self.funcs[key] = mseloss
        elif hasattr(coeffs, "items"):
            for key, value in coeffs.items():
                coeff, func, func_params = 1.0, "MSELoss", {}
                if isinstance(value, (float, int)):
                    coeff = value
                elif isinstance(value, str) or callable(value):
                    func = value
                elif isinstance(value, (list, tuple)):
                    if isinstance(value[0], (float, int)):
                        coeff = value[0]
                        if len(value) > 1:
                            func = value[1]
                        if len(value) > 2:
                            func_params = value[2]
                    else:
                        func = value[0]
                        if len(value) > 1:
                            func_params = value[1]
                else:
                    raise NotImplementedError(
                        f"expected float, list or tuple, got {type(value)}")
                self.coeffs[key] = coeff
                self.funcs[key] = find_loss_function(func, func_params)
        else:
            raise NotImplementedError(
                f"loss_coeffs can only be str, list and dict; got "
                f"{type(coeffs)}")
        for key, coeff in self.coeffs.items():
            self.coeffs[key] = float(coeff)
            self.keys.append(key)

    def __call__(self, pred: dict, ref: dict):
        loss = 0.0
        contrib = {}
        for key in self.coeffs:
            _loss = self.funcs[key](pred=pred, ref=ref, key=key, mean=True)
            contrib[key] = _loss
            loss = loss + self.coeffs[key] * _loss
        return loss, contrib


class RunningScalar:
    """Running mean of scalar tensors; they stay on their device until
    ``current_result`` so a training loop never waits on them."""

    def __init__(self):
        self.values = []

    def accumulate(self, value):
        self.values.append(value.detach() if torch.is_tensor(value)
                           else torch.tensor(float(value)))
        return value

    def reset(self):
        self.values = []

    def current_result(self):
        if not self.values:
            return 0.0
        return float(torch.stack([v.float().reshape(()) for v in
                                  self.values]).mean())


class LossStat:
    """Accumulate the total and per-key loss values across batches."""

    def __init__(self, loss_instance=None):
        self.loss_stat = {"total": RunningScalar()}
        self.ignore_nan = {}
        if loss_instance is not None:
            for key, func in loss_instance.funcs.items():
                self.ignore_nan[key] = getattr(func, "ignore_nan", False)

    def __call__(self, loss, loss_contrib):
        results = {}
        self.loss_stat["total"].accumulate(loss)
        results["loss"] = loss
        for k, v in loss_contrib.items():
            if k not in self.loss_stat:
                self.loss_stat[k] = RunningScalar()
            self.loss_stat[k].accumulate(v)
            results["loss_" + k] = v
        return results

    def reset(self):
        for v in self.loss_stat.values():
            v.reset()

    def current_result(self):
        results = {
            "loss_" + k: v.current_result()
            for k, v in self.loss_stat.items()
            if k != "total"
        }
        results["loss"] = self.loss_stat["total"].current_result()
        return results
