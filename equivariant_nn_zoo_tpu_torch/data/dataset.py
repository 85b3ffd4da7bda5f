"""CondensedDataset — HDF5-backed dataset with key mapping, preprocessing,
equivariance-test fixtures and statistics.

A numpy-only copy of ``equivariant_nn_zoo_tpu/data/dataset.py`` on the
port's ``Batch``, irreps, Wigner matrices and statistics.  ``h5py`` is
imported only where a file is read, so an in-memory dataset (``data=`` and
``attrs=``) needs none.

Reference parity: e3_layers/data/dataset.py (C3 in SURVEY.md §2): path may be
a file, a directory, ``dir:regex`` or a list of paths; per-item preprocess
functions of arity 1 (Data) or 2 (tensors, attrs); statistics modes
count / rms / mean_std / per-node-* / per-<key>-* (GP solver).
"""

from __future__ import annotations

import logging
import os
import re
from inspect import signature

import numpy as np

from .batch import Batch
from ..ops.irreps import Irreps
from ..ops.wigner import irreps_d, rand_matrix
from ..utils.statistics import bincount, solver
from ..utils.utils import default_type_names, keyMap


class CondensedDataset(Batch):
    def __init__(self, path=None, data={}, attrs={}, key_map={}, type_names=None,
                 preprocess=[], cache_preprocessed: bool = False, **kwargs):
        if path is not None:
            data, attrs = CondensedDataset.load(path)
            if isinstance(data, list):
                data = Batch.from_data_list(data, attrs).data
        super().__init__(attrs, **data)
        self.data = keyMap(self.data, key_map)
        self.attrs = keyMap(self.attrs, key_map)
        self.attrs = {k: (v[0], v[1]) for k, v in self.attrs.items()}
        if type_names is None:
            type_names = default_type_names()
        self.type_names = list(type_names)
        self.preprocess = preprocess
        # opt-in memoization of preprocessed items: a huge host-pipeline win
        # for DETERMINISTIC preprocess (e.g. radius graphs on static QM9
        # coordinates — epoch >= 2 costs nothing), but it would freeze
        # random augmentation (protein crop / stochastic long-range edges),
        # so it must be enabled explicitly per workload.
        self.cache_preprocessed = bool(cache_preprocessed)
        self._item_cache = {}
        self.kwargs = kwargs

    @staticmethod
    def load(path):
        """Reference parity: dataset.py:48-102."""
        import h5py

        def loadFile(file):
            logging.info(f"Loading {file}")
            data, attrs = {}, {}
            with h5py.File(file, "r") as f:
                for key in f.keys():
                    item = np.asarray(f[key][:])
                    if item.dtype == np.int32:
                        item = item.astype(np.int64)
                    elif item.dtype == np.float64:
                        item = item.astype(np.float32)
                    data[key] = item
                for key in f.attrs.keys():
                    value = f.attrs[key]
                    if isinstance(value, np.ndarray):
                        value = tuple(
                            v.decode() if isinstance(v, bytes) else str(v)
                            for v in value
                        )
                    attrs[key] = value
            return data, attrs

        if isinstance(path, str):
            parts = path.split(":")
            if len(parts) == 2:
                path, regexp = parts
                regexp = re.compile(regexp)
            else:
                path = parts[0]
                regexp = None
            if os.path.isdir(path):
                data, attrs = [], {}
                for root, dirs, files in os.walk(path):
                    for file in sorted(files):
                        file = os.path.join(root, file)
                        if regexp is not None and regexp.match(file) is None:
                            continue
                        _data, _attrs = loadFile(file)
                        data.append(_data)
                        attrs.update(_attrs)
            else:
                data, attrs = loadFile(path)
        else:  # a list of paths
            data, attrs = [], {}
            for item in path:
                x, y = CondensedDataset.load(item)
                if isinstance(x, list):
                    data += x
                else:
                    data.append(x)
                attrs.update(y)
        if len(data) == 0:
            logging.warning(f"No dataset file is found in {path}.")
        return data, attrs

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.data[idx]
        if isinstance(idx, (int, np.integer)):
            if self.cache_preprocessed and int(idx) in self._item_cache:
                return self._item_cache[int(idx)]
            data = self.get(int(idx)).clone()
            for func in self.preprocess:
                sig = signature(func)
                required = [
                    p for p in sig.parameters.values()
                    if p.default is p.empty
                    and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                ]
                if len(required) == 1:
                    data = func(data)
                else:
                    tensors, attrs = func(data.data, data.attrs)
                    data.data.update(tensors)
                    data.attrs = attrs
            if self.cache_preprocessed:
                self._item_cache[int(idx)] = data
            return data
        return self.index_select(idx)

    def index_select(self, idx):
        batch = super().index_select(idx)
        return CondensedDataset(
            type_names=self.type_names, preprocess=self.preprocess,
            cache_preprocessed=self.cache_preprocessed,
            data=batch.data, attrs=batch.attrs,
        )

    def equivarianceTest(self, size, idx=0):
        """Fill the dataset with ``size`` random rotations of one sample and
        store the rotation matrices under ``_rotation_matrix``.

        Reference parity: dataset.py:123-137.
        """
        rng = np.random.default_rng(0)
        matrices = np.stack([rand_matrix(rng) for _ in range(size)])
        self.length = size
        self.attrs["_rotation_matrix"] = ("graph", 9)
        out = []
        for i in range(size):
            s = self.get(idx).clone()
            for key in s.keys():
                if key in s.attrs:
                    transform = s.attrs[key][1]
                    if isinstance(transform, (str, Irreps)) and not (
                        isinstance(transform, str) and str(transform).isdigit()
                    ):
                        irreps = Irreps(transform)
                        D = irreps_d(irreps, matrices[i]).astype(np.float32)
                        s.data[key] = np.asarray(s[key], np.float32) @ D.T
            out.append(s)
        rebuilt = Batch.from_data_list(out, dict(self.attrs))
        self.data = rebuilt.data
        self.data["_rotation_matrix"] = matrices.reshape(size, 9).astype(np.float32)
        for a in ("node_cumsum", "edge_cumsum"):
            if hasattr(self, a):
                delattr(self, a)
        self.computeCumsums()

    # -- statistics (reference dataset.py:139-302) --------------------------

    def statistics(self, fields, stride: int = 1, unbiased: bool = True):
        n_samples = len(self) // stride
        lst = [self[i * stride] for i in range(n_samples)]
        data_transformed = Batch.from_data_list(lst)
        out = []
        for field in fields:
            key = field.split("-")[0]
            ana_mode = field[len(key) + 1 :]
            arr = np.asarray(data_transformed[key])
            is_per = self.attrs[key][0]
            ddof = 1 if unbiased else 0
            if ana_mode == "count":
                uniq, counts = np.unique(arr.flatten(), return_counts=True)
                out.append((uniq, counts))
            elif ana_mode == "rms":
                out.append((np.sqrt(np.mean(arr * arr)),))
            elif ana_mode == "mean_std":
                out.append((arr.mean(axis=0), arr.std(axis=0, ddof=ddof)))
            elif ana_mode.startswith("per-node-"):
                if is_per != "graph":
                    raise ValueError(
                        f"`{ana_mode}` requires a per-graph field, got {field}"
                    )
                mode = ana_mode[len("per-node-") :]
                N = np.asarray(data_transformed["_n_nodes"]).reshape(-1, 1)
                arr_n = arr / N
                if mode == "mean_std":
                    out.append(
                        (arr_n.mean(axis=0), arr_n.std(axis=0, ddof=ddof))
                    )
                elif mode == "rms":
                    out.append((np.sqrt(np.mean(arr_n**2)),))
                else:
                    raise NotImplementedError(mode)
            elif ana_mode.startswith("per-"):
                _, skey, mode = ana_mode.split("-")
                atom_types = np.asarray(data_transformed[skey]).reshape(-1)
                batch = data_transformed.nodeSegment()
                N = bincount(atom_types, batch, minlength=len(self.type_names))
                N = N[(N > 0).any(axis=1)]
                if is_per == "graph":
                    if mode != "mean_std":
                        raise NotImplementedError(mode)
                    out.append(solver(N.astype(np.float64), arr))
                elif is_per == "node":
                    n_types = N.shape[1]
                    sums = np.zeros((n_types, arr.shape[1]))
                    np.add.at(sums, atom_types, arr)
                    counts = np.bincount(atom_types, minlength=n_types)[:, None]
                    counts_safe = np.maximum(counts, 1)
                    mean = sums / counts_safe
                    if mode == "mean_std":
                        sq = np.zeros_like(sums)
                        np.add.at(sq, atom_types, arr**2)
                        var = sq / counts_safe - mean**2
                        if ddof:
                            var = var * counts_safe / np.maximum(
                                counts_safe - 1, 1
                            )
                        out.append((mean, np.sqrt(np.clip(var, 0, None))))
                    elif mode == "rms":
                        sq = np.zeros_like(sums)
                        np.add.at(sq, atom_types, arr**2)
                        ms = (sq / counts_safe).mean(axis=tuple(range(1, sums.ndim)))
                        out.append((np.sqrt(ms),))
                    else:
                        raise NotImplementedError(mode)
                else:
                    raise NotImplementedError(is_per)
            else:
                raise NotImplementedError(f"statistics mode {ana_mode}")
        return out
