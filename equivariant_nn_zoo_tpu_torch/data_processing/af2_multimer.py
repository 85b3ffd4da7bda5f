"""AF2-multimer label features -> HDF5 converter: backbone atom positions
(N, CA, C, CB, O), species (the amino-acid type), chain ids and a mask per
multimer.

The port's counterpart of the repository's ``data_processing/
af2_multimer.py``, on the port's ``Batch`` and its own HDF5 writer
(``data/hdf5.py``), so it runs where ``h5py`` is absent.  It reads a
directory of per-chain ``.npz``/``.pkl`` label files carrying
``all_atom_positions [n_res, 37, 3]``, ``all_atom_mask [n_res, 37]`` and
``aatype_index [n_res]`` (the AF2 label schema), applies each chain's
assembly operator (4x4, or a 3x3 rotation and a translation) where the
mapping gives one, and writes the keys ``config_diffusion_CA`` and
``config_diffusion_backbone`` read: ``N``, ``CA``, ``C``, ``CB``, ``O``,
``species``, ``chain_id``, ``mask`` (N, CA, C and O all resolved) and
``_n_nodes``.  A multimer's shard is ``hash(pdb_id) % N_PROCESS``, which,
as in the JAX script, is stable only within one process.

Usage:
    python -m equivariant_nn_zoo_tpu_torch.data_processing.af2_multimer \
        MAPPING.json LABEL_DIR OUT_DIR [SPLIT] [N_PROCESS]

MAPPING.json: {pdb_id: {"chains": [...], "opers": [[4x4], ...]}}
"""

import json
import os
import pickle
import sys

import numpy as np

from ..data.batch import Batch

# AF2 atom37 indices for the backbone atoms the reference extracts
ATOM37_INDEX = {"N": 0, "CA": 1, "C": 2, "CB": 3, "O": 4}


def load_chain(label_path, chain):
    for ext in (".npz", ".pkl", ".pickle"):
        p = os.path.join(label_path, chain + ext)
        if os.path.exists(p):
            if ext == ".npz":
                with np.load(p, allow_pickle=True) as f:
                    return {k: f[k] for k in f.files}
            with open(p, "rb") as f:
                return pickle.load(f)
    raise FileNotFoundError(chain)


def apply_oper(positions, oper):
    """Apply a 4x4 (or (3x3, 3)) assembly transform to [n, 37, 3]."""
    oper = np.asarray(oper, np.float64)
    if oper.shape == (4, 4):
        rot, trans = oper[:3, :3], oper[:3, 3]
    else:
        rot, trans = oper[0], oper[1]
    return positions @ rot.T + trans


def load_multimer_raw_feature(chains, label_path, label_transform=None):
    labels = []
    for i, chain in enumerate(chains):
        item = load_chain(label_path, chain)
        if label_transform is not None and i < len(label_transform):
            item = dict(item)
            item["all_atom_positions"] = apply_oper(
                np.asarray(item["all_atom_positions"]), label_transform[i]
            )
        labels.append(item)
    return labels


def convert(mapping, label_path, split=0, n_process=1, verbose=True):
    failure = 0
    lst = []
    for key in mapping:
        if hash(key) % n_process != split:
            continue
        chains = [f"{key}_{c}" for c in mapping[key]["chains"]]
        label_transforms = mapping[key].get("opers")
        try:
            labels = load_multimer_raw_feature(
                chains, label_path=label_path,
                label_transform=label_transforms,
            )
        except Exception:
            failure += 1
            if verbose:
                print(f"Failed {key}, number of failure cases {failure}.")
            continue

        data = {}
        for atom, i in ATOM37_INDEX.items():
            data[atom] = np.concatenate(
                [np.asarray(item["all_atom_positions"])[:, i] for item in labels],
                axis=0,
            ).astype(np.float32)
        data["species"] = np.concatenate(
            [np.asarray(item["aatype_index"]).reshape(-1, 1) for item in labels],
            axis=0,
        ).astype(np.int64)

        cnt = 0
        n_total = data["species"].shape[0]
        chain_id = np.zeros((n_total, 1), dtype=np.int64)
        mask = np.zeros((n_total, 1), dtype=np.int64)
        for i, item in enumerate(labels):
            n_res = np.asarray(item["aatype_index"]).shape[0]
            chain_id[cnt : cnt + n_res] = i
            am = np.asarray(item["all_atom_mask"])
            ok = np.logical_and(am[:, 0:3].all(axis=1), am[:, 4])
            mask[cnt : cnt + n_res, 0] = ok
            cnt += n_res
        data["chain_id"] = chain_id
        data["mask"] = mask
        lst.append(data)
    return lst


def main(mapping_path, label_path, output_dir, split=0, n_process=1):
    with open(mapping_path) as f:
        mapping = json.load(f)
    lst = convert(mapping, label_path, split, n_process)
    if not lst:
        print("no multimers converted")
        return
    attrs = {}
    for atom in ATOM37_INDEX:
        attrs[atom] = ("node", "1x1o")
    attrs["mask"] = ("node", "1x0e")
    attrs["species"] = ("node", "1x0e")
    attrs["chain_id"] = ("node", "1x0e")
    attrs["_n_nodes"] = ("graph", "1x0e")
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"pdb_{split}.hdf5")
    Batch.from_data_list(lst, attrs).dumpHDF5(path)
    print(f"wrote {len(lst)} multimers to {path}")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1], a[2], int(a[3]) if len(a) > 3 else 0,
         int(a[4]) if len(a) > 4 else 1)
