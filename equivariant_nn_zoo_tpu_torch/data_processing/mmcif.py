"""mmCIF -> HDF5 converter: per-residue CA positions, amino-acid types,
chain ids and position masks from PDBx/mmCIF files, sharded by
``hash(name) % N_PROCESS``.

The port's counterpart of the repository's ``data_processing/mmcif.py``,
on the port's ``Batch`` and its own HDF5 writer (``data/hdf5.py``), so it
runs where ``h5py`` is absent.  The same minimal mmCIF loop parser
(quoted tokens, rows wrapped across lines, the key-value form), the same
fields (``_atom_site``, ``_entity_poly_seq``; ``_pdbx_struct_oper_list``
is parsed and, as in the JAX script, never applied) and the same output
keys: ``pos``, ``pos_mask`` (0 for an observed residue), ``aa_type``,
``chain_id``, ``_n_nodes``.  A structure's shard is ``hash(name) %
N_PROCESS``, which, as in the JAX script, is stable only within one
process (Python salts ``str`` hashes per process).

Usage:
    python -m equivariant_nn_zoo_tpu_torch.data_processing.mmcif \
        INPUT_DIR OUTPUT_DIR [SPLIT] [N_PROCESS]
"""

import gzip
import os
import sys

import numpy as np

from ..data.batch import Batch


# three-letter -> index codification (matches the saveProtein order)
codification = {
    "ALA": "A", "ARG": "R", "ASP": "D", "ASN": "N", "CYS": "C", "GLU": "E",
    "GLN": "Q", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}
one_letter_ids = {v: i for i, (k, v) in enumerate(codification.items())}
three_letter_ids = {k: i for i, k in enumerate(codification.keys())}
UNK = len(codification)  # "UNK"


def parse_mmcif_loops(text, categories):
    """Minimal mmCIF parser: returns {category: list of row-dicts} for the
    requested ``_category.`` prefixes (handles loop_ and key-value forms)."""
    out = {c: [] for c in categories}
    lines = text.splitlines()
    i = 0
    n = len(lines)

    def tokenize(line):
        toks, cur, quote = [], "", None
        for ch in line:
            if quote:
                if ch == quote:
                    quote = None
                else:
                    cur += ch
            elif ch in "'\"":
                quote = ch
            elif ch.isspace():
                if cur:
                    toks.append(cur)
                    cur = ""
            else:
                cur += ch
        if cur:
            toks.append(cur)
        return toks

    while i < n:
        line = lines[i].strip()
        if line == "loop_":
            fields = []
            i += 1
            while i < n and lines[i].strip().startswith("_"):
                fields.append(lines[i].strip().split()[0])
                i += 1
            if not fields:
                continue
            cat = fields[0].split(".")[0].lstrip("_")
            names = [f.split(".")[1] for f in fields]
            rows = []
            while i < n:
                s = lines[i].strip()
                if not s or s.startswith(("_", "loop_", "#", "data_")):
                    break
                toks = tokenize(s)
                # mmCIF rows may wrap across lines
                while len(toks) < len(names) and i + 1 < n:
                    i += 1
                    toks += tokenize(lines[i].strip())
                if len(toks) >= len(names):
                    rows.append(dict(zip(names, toks)))
                i += 1
            if cat in out:
                out[cat] = rows
            continue
        if line.startswith("_"):
            key = line.split()[0]
            cat = key.split(".")[0].lstrip("_")
            if cat in out and "." in key:
                toks = tokenize(line)
                name = key.split(".")[1]
                if len(toks) >= 2:
                    if not out[cat]:
                        out[cat] = [{}]
                    out[cat][0][name] = " ".join(toks[1:])
        i += 1
    return out


def convert_file(path):
    """One mmCIF(.gz) file -> dict of arrays, or None on failure."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", errors="ignore") as f:
            text = f.read()
    except OSError:
        return None
    cats = parse_mmcif_loops(
        text, ["atom_site", "entity_poly_seq", "pdbx_struct_oper_list"]
    )
    atoms = [
        a
        for a in cats["atom_site"]
        if a.get("group_PDB") == "ATOM" and a.get("label_atom_id") == "CA"
    ]
    if not atoms:
        return None
    seq_rows = cats["entity_poly_seq"]
    if seq_rows:
        # build per-entity sequences
        entities = {}
        for row in seq_rows:
            ent = row.get("entity_id", "1")
            entities.setdefault(ent, []).append(
                three_letter_ids.get(row.get("mon_id", ""), UNK)
            )
        order = sorted(entities, key=lambda e: int(e) if e.isdigit() else e)
        aa_type = []
        cumsum = [0]
        ent_index = {}
        for k, ent in enumerate(order):
            ent_index[ent] = k
            aa_type += entities[ent]
            cumsum.append(len(aa_type))
    else:
        # fall back: derive residue list from the CA atoms themselves
        aa_type = [
            three_letter_ids.get(a.get("label_comp_id", ""), UNK)
            for a in atoms
        ]
        cumsum = [0, len(aa_type)]
        ent_index = {}
    cnt = len(aa_type)
    if cnt == 0:
        return None

    chain_id = np.zeros((cnt, 1), dtype=np.int64)
    for i in range(len(cumsum) - 1):
        chain_id[cumsum[i] : cumsum[i + 1]] = i

    pos = np.zeros((cnt, 3), dtype=np.float32)
    pos_mask = np.ones(cnt, dtype=np.int64)
    for ca in atoms:
        try:
            ent = ca.get("label_entity_id", "1")
            k = ent_index.get(ent, 0)
            idx = cumsum[k] + int(ca["label_seq_id"]) - 1
            if not (0 <= idx < cnt):
                continue
            pos_mask[idx] = 0  # 0 = observed (reference convention)
            pos[idx] = (
                float(ca["Cartn_x"]), float(ca["Cartn_y"]),
                float(ca["Cartn_z"]),
            )
        except (KeyError, ValueError):
            continue

    return {
        "_n_nodes": cnt,
        "aa_type": np.asarray(aa_type),
        "pos": pos,
        "pos_mask": pos_mask,
        "chain_id": chain_id,
    }


def main(input_dir, output_dir, split=0, n_process=1):
    proteins = []
    for root, dirs, files in os.walk(input_dir):
        for filename in sorted(files):
            name = filename.split(".")[0]
            if not filename.endswith((".cif", ".cif.gz", ".gz")):
                continue
            if hash(name) % n_process != split:
                continue
            item = convert_file(os.path.join(root, filename))
            if item is not None:
                proteins.append(item)
    if not proteins:
        print("no structures converted")
        return
    attrs = {
        "pos": ("node", "1x1o"),
        "pos_mask": ("node", "1x0e"),
        "aa_type": ("node", "1x0e"),
        "_n_nodes": ("graph", "1x0e"),
        "chain_id": ("node", "1x0e"),
    }
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"pdb_{split}.hdf5")
    batch = Batch.from_data_list(proteins, attrs)
    batch.dumpHDF5(path)
    print(f"wrote {len(proteins)} structures to {path}")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(
        args[0], args[1],
        int(args[2]) if len(args) > 2 else 0,
        int(args[3]) if len(args) > 3 else 1,
    )
