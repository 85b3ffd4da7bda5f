"""Dataset conversion: QM9 npz -> condensed HDF5, padded HDF5 -> condensed
HDF5, and dataset statistics (among them the per-species fit that gives
``config_energy``'s energy shifts).

PyTorch package's counterpart of ``examples/convert_datasets.py``, on this
package's ``Batch`` and ``CondensedDataset``.  A host script: it runs no
kernel and needs ``h5py``, which the machine with the card lacks, so it runs
where the data are prepared and its files are copied over.

Usage:

    python -m equivariant_nn_zoo_tpu_torch.examples.convert_datasets \\
        qm9 INPUT.npz OUT.hdf5
    python -m equivariant_nn_zoo_tpu_torch.examples.convert_datasets \\
        padded INPUT.hdf5 OUT.hdf5
    python -m equivariant_nn_zoo_tpu_torch.examples.convert_datasets \\
        stats DATASET.hdf5 field-mode [...]
"""

from __future__ import annotations

import sys

import numpy as np

from ..data.batch import Batch
from ..data.dataset import CondensedDataset


def convert_qm9(npz_path, out_path):
    """QM9 npz (padded R/Z arrays per molecule) -> condensed HDF5: drop the
    padding atoms (Z == 0), concatenate, and annotate irreps."""
    f = np.load(npz_path, allow_pickle=True)
    R, Z, U0 = f["R"], f["Z"], f["U0"] if "U0" in f else f["U"]
    items = []
    for i in range(len(Z)):
        z = np.asarray(Z[i]).reshape(-1)
        mask = z > 0
        items.append({
            "R": np.asarray(R[i]).reshape(-1, 3)[mask].astype(np.float32),
            "Z": z[mask].reshape(-1, 1).astype(np.int64),
            "U0": np.asarray(U0[i]).reshape(1, 1).astype(np.float32),
            "_n_nodes": int(mask.sum()),
        })
    attrs = {
        "R": ("node", "1x1o"),
        "Z": ("node", "1x0e"),
        "U0": ("graph", "1x0e"),
        "_n_nodes": ("graph", "1x0e"),
    }
    batch = Batch.from_data_list(items, attrs)
    batch.dumpHDF5(out_path)
    print(f"wrote {len(batch)} molecules to {out_path}")


def convert_padded_hdf5(in_path, out_path, pad_key="Z", pad_value=0):
    """Padded per-molecule HDF5 -> condensed HDF5 (the rows of ``pad_key``
    equal to ``pad_value`` are padding)."""
    import h5py

    with h5py.File(in_path) as f:
        arrays = {k: np.asarray(f[k]) for k in f.keys()}
        attrs = {k: tuple(v) for k, v in f.attrs.items()}
    n_mol = len(arrays[pad_key])
    items = []
    for i in range(n_mol):
        mask = np.asarray(arrays[pad_key][i]).reshape(-1) != pad_value
        item = {}
        for k, v in arrays.items():
            vi = np.asarray(v[i])
            item[k] = vi[mask] if vi.shape[:1] == mask.shape else vi
        item["_n_nodes"] = int(mask.sum())
        items.append(item)
    Batch.from_data_list(items, attrs).dumpHDF5(out_path)
    print(f"wrote {n_mol} graphs to {out_path}")


def statistics(path, fields, stride=1):
    """The statistics of ``fields`` (e.g. ``['U0-per-Z-mean_std']``, the
    per-species energy shifts of ``config_energy``)."""
    ds = CondensedDataset(path=path)
    out = ds.statistics(fields, stride=stride)
    for field, res in zip(fields, out):
        print(field, "->")
        for r in res:
            print(np.asarray(r))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else None
    if cmd == "qm9":
        convert_qm9(argv[1], argv[2])
    elif cmd == "padded":
        convert_padded_hdf5(argv[1], argv[2])
    elif cmd == "stats":
        statistics(argv[1], argv[2:])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
