"""The port's structure converters (``equivariant_nn_zoo_tpu_torch/
data_processing/``) against the JAX package's scripts (``data_processing/``),
and the dataset files on a machine without ``h5py``:

- ``mmcif``: ``.cif`` and ``.cif.gz`` files with a row wrapped across
  lines, quoted tokens, a residue without a CA, HETATM rows, the key-value
  form and a file without ``_entity_poly_seq``, converted by both scripts
  with ``n_process`` 1 and 2 (in one process, so ``hash(name)`` shards
  alike): the same files, arrays and attributes;
- ``af2_multimer``: per-chain ``.npz`` and ``.pkl`` labels with 4x4 and
  (3x3, 3) operators and unresolved backbone atoms, likewise;
- the first ``config_diffusion_CA`` and ``config_diffusion_backbone``
  training batches from a converted file equal JAX's pipeline's (the same
  loader seed, the crop's generator seeded alike on both sides);
- with ``h5py`` blocked (``sys.modules["h5py"] = None``) a subprocess
  loads a dataset, dumps one, runs the inference CLI, whose file reads
  back equal to what it returned (and a failure to write raises), and
  runs both converters as modules.
"""

import gzip
import importlib.util
import json
import os
import pickle
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

from equivariant_nn_zoo_tpu.data.dataloader import (
    getDataIters as jgetDataIters,
)
from equivariant_nn_zoo_tpu.models import get_config as jget_config
from equivariant_nn_zoo_tpu_torch.data import getDataIters, hdf5
from equivariant_nn_zoo_tpu_torch.data_processing import (
    af2_multimer,
    mmcif,
)
from equivariant_nn_zoo_tpu_torch.models import get_config
from test_torch_data import _assert_same_batch
from test_torch_edge_order import torch_threads_per_worker
from test_torch_hdf5 import assert_same, h5py_view

torch_threads_per_worker()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREE = list(mmcif.codification)


def jax_script(name):
    """The JAX package's ``data_processing/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "data_processing", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_files(got_dir, want_dir):
    """The same file names; each file's arrays and attributes equal bit for
    bit with ``h5py``'s types, read by ``h5py`` and by the port."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        got, want = (os.path.join(d, name) for d in (got_dir, want_dir))
        for read in (h5py_view, hdf5.read):
            (gd, ga), (wd, wa) = read(got), read(want)
            assert list(gd) == list(wd) and list(ga) == list(wa)
            for k in wd:
                assert_same(gd[k], wd[k], f"{name}:{k}")
            for k in wa:
                assert_same(ga[k], wa[k], f"{name}:{k}")


# ------------------------------------------------------------------ mmCIF

def cif_text(rng, chains, poly_seq=True, wrap=True):
    """An mmCIF file of ``chains`` [(n_res, observed residues)] as
    entities 1, 2, ...: ``_entity_poly_seq`` (unless ``poly_seq`` is
    false), ``_pdbx_struct_oper_list`` in the key-value form, and
    ``_atom_site`` with N, CA and C per observed residue, a quoted
    comp id, one row wrapped over two lines and two HETATM waters."""
    lines = ["data_TEST", "#", "_entry.id TEST", "#"]
    seqs = [[THREE[i] for i in rng.integers(0, 20, n)] for n, _ in chains]
    if poly_seq:
        lines += ["loop_", "_entity_poly_seq.entity_id",
                  "_entity_poly_seq.num", "_entity_poly_seq.mon_id",
                  "_entity_poly_seq.hetero"]
        for e, seq in enumerate(seqs, 1):
            lines += [f"{e} {i} {aa} n" for i, aa in enumerate(seq, 1)]
        lines.append("#")
    lines += ["_pdbx_struct_oper_list.id 1",
              "_pdbx_struct_oper_list.type 'identity operation'",
              "_pdbx_struct_oper_list.matrix[1][1] 1.0", "#", "loop_"]
    fields = ["group_PDB", "id", "type_symbol", "label_atom_id",
              "label_alt_id", "label_comp_id", "label_asym_id",
              "label_entity_id", "label_seq_id", "Cartn_x", "Cartn_y",
              "Cartn_z", "auth_asym_id"]
    lines += [f"_atom_site.{f}" for f in fields]
    atom = 0
    for e, ((n, observed), seq) in enumerate(zip(chains, seqs), 1):
        asym = "ABCD"[e - 1]
        ca = np.cumsum(rng.normal(size=(n, 3)) * 2.2, axis=0) + 10 * e
        for i in observed:
            for name in ("N", "CA", "C"):
                atom += 1
                x, y, z = ca[i] + (0 if name == "CA" else
                                   rng.normal(size=3))
                comp = f'"{seq[i]}"' if i % 7 == 3 else seq[i]
                row = (f"ATOM {atom} {name[0]} {name} . {comp} {asym} {e} "
                       f"{i + 1} {x:.3f} {y:.3f} {z:.3f} '{asym} x'")
                if wrap and atom == 5:
                    head, tail = row.split(" . ")
                    lines += [head + " .", tail]
                else:
                    lines.append(row)
    for k in range(2):
        atom += 1
        lines.append(f"HETATM {atom} O O . HOH Z 9 . {k}.5 1.0 2.0 Z")
    return "\n".join(lines + ["#", ""])


@pytest.fixture(scope="module")
def cif_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cif")
    rng = np.random.default_rng(11)
    structures = {
        "1abc.cif": ([(12, [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11]),
                      (9, list(range(9)))], True),
        "2def.cif.gz": ([(15, list(range(1, 15)))], True),
        "3ghi.cif": ([(8, list(range(8)))], False),
        "4jkl.cif.gz": ([(6, [0, 1, 2, 3, 4, 5]), (7, [0, 2, 3, 4, 5, 6]),
                         (5, [1, 2, 3])], True),
        "5mno.cif": ([(10, [0, 1, 3, 4, 5, 6, 7, 8, 9])], True),
    }
    for name, (chains, poly_seq) in structures.items():
        text = cif_text(rng, chains, poly_seq=poly_seq)
        if name.endswith(".gz"):
            with gzip.open(root / name, "wt") as f:
                f.write(text)
        else:
            (root / name).write_text(text)
    (root / "notes.txt").write_text("not a structure")
    return str(root)


@pytest.mark.parametrize("n_process", [1, 2])
def test_mmcif_matches_jax(cif_dir, tmp_path, n_process):
    jmmcif = jax_script("mmcif")
    for split in range(n_process):
        jmmcif.main(cif_dir, str(tmp_path / "jax"), split, n_process)
        mmcif.main(cif_dir, str(tmp_path / "port"), split, n_process)
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_mmcif_parser_details(cif_dir):
    """The wrapped row, the quoted tokens, the missing residue and the
    fallback without ``_entity_poly_seq``, as the JAX script reads them."""
    jmmcif = jax_script("mmcif")
    for name in sorted(os.listdir(cif_dir)):
        if not name.endswith((".cif", ".gz")):
            continue
        got = mmcif.convert_file(os.path.join(cif_dir, name))
        want = jmmcif.convert_file(os.path.join(cif_dir, name))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    one = mmcif.convert_file(os.path.join(cif_dir, "1abc.cif"))
    assert one["_n_nodes"] == 21
    assert one["pos_mask"].tolist().count(1) == 1 and one["pos_mask"][3] == 1
    assert one["chain_id"][:, 0].tolist() == [0] * 12 + [1] * 9
    fallback = mmcif.convert_file(os.path.join(cif_dir, "3ghi.cif"))
    assert fallback["_n_nodes"] == 8 and not fallback["pos_mask"].any()
    text = open(os.path.join(cif_dir, "1abc.cif")).read()
    rows = mmcif.parse_mmcif_loops(text, ["atom_site",
                                          "pdbx_struct_oper_list"])
    assert rows["atom_site"][1]["label_atom_id"] == "CA"
    assert rows["atom_site"][0]["auth_asym_id"] == "A x"
    assert rows["pdbx_struct_oper_list"][0]["type"] == "identity operation"


# ------------------------------------------------------------- AF2 labels

def chain_labels(rng, n):
    """AF2 labels of a chain of ``n`` residues: the backbone of a random
    walk with CB, the other atom37 slots zero; about 5 % of the residues
    miss one of N, CA, C or O."""
    pos = np.zeros((n, 37, 3), np.float32)
    ca = np.cumsum(rng.normal(size=(n, 3)) * 2.2, axis=0)
    mask = np.zeros((n, 37), np.float32)
    for slot in range(5):
        pos[:, slot] = ca + (0 if slot == 1 else rng.normal(size=(n, 3)))
        mask[:, slot] = 1
    lost = rng.random(n) < 0.05
    mask[lost, rng.integers(0, 5, int(lost.sum()))] = 0
    return {"all_atom_positions": pos, "all_atom_mask": mask,
            "aatype_index": rng.integers(0, 20, n)}


def rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def write_af2(root, rng, n_multimers=6, sizes=(20, 40)):
    """Label files and a mapping: 1-3 chains a multimer, ``.npz`` (one
    ``.pkl``), operators on a few chains, one multimer with a missing
    chain file.  A (3x3, 3) operator read from JSON is a ragged list,
    which both scripts fail on (``np.asarray``): its multimer is counted
    as a failure."""
    labels = root / "labels"
    labels.mkdir()
    mapping = {}
    for m in range(n_multimers):
        key = f"{m}x{m}y"
        chains = "ABC"[:int(rng.integers(1, 4))]
        for c in chains:
            item = chain_labels(rng, int(rng.integers(*sizes)))
            if m == 1 and c == "A":
                with open(labels / f"{key}_{c}.pkl", "wb") as f:
                    pickle.dump(item, f)
            else:
                np.savez(labels / f"{key}_{c}.npz", **item)
        entry = {"chains": list(chains)}
        if m % 3 == 1:
            r, t = rotation(rng), rng.normal(size=3) * 5
            four = np.eye(4)
            four[:3, :3], four[:3, 3] = r, t
            entry["opers"] = [four.tolist()] if m % 2 else \
                [[r.tolist(), t.tolist()]]
        mapping[key] = entry
    mapping["9zzz"] = {"chains": ["A"]}               # no label file
    path = root / "mapping.json"
    path.write_text(json.dumps(mapping))
    return str(path), str(labels)


@pytest.mark.parametrize("n_process", [1, 2])
def test_af2_multimer_matches_jax(tmp_path, n_process):
    mapping, labels = write_af2(tmp_path, np.random.default_rng(5))
    jaf2 = jax_script("af2_multimer")
    for split in range(n_process):
        jaf2.main(mapping, labels, str(tmp_path / "jax"), split, n_process)
        af2_multimer.main(mapping, labels, str(tmp_path / "port"), split,
                          n_process)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    data, attrs = hdf5.read(str(tmp_path / "port" / "pdb_0.hdf5"))
    assert {"N", "CA", "C", "CB", "O", "species", "chain_id", "mask",
            "_n_nodes"} <= set(data)
    assert tuple(attrs["CA"]) == ("node", "1x1o")


# ----------------------------------------------------- the protein batch

@pytest.mark.parametrize("name", ["config_diffusion_CA",
                                  "config_diffusion_backbone"])
def test_protein_batch_from_a_converted_file_matches_jax(tmp_path, name):
    """Labels through the port's converter into ``pdb_0.hdf5``; the first
    training batch of the config's pipeline (``masked2indexed``, ``crop``
    to 384, the loader seeded 0) from that directory equals JAX's."""
    mapping, labels = write_af2(tmp_path, np.random.default_rng(8),
                                n_multimers=10, sizes=(150, 330))
    out = tmp_path / "pdb"
    af2_multimer.main(mapping, labels, str(out))
    cfg, jcfg = get_config(name), jget_config(name)
    masked2indexed, crop = cfg["data_config"]["preprocess"]
    jmasked2indexed, jcrop = jcfg.data_config.preprocess
    cfg["data_config"] = dict(
        cfg["data_config"], path=[str(out)], edge_capacity=4096,
        n_train=0.5, n_val=0.5,
        preprocess=[masked2indexed, partial(
            crop.func, **crop.keywords, rng=np.random.default_rng(3))])
    # the JAX configs type the field: a list (CA) or a str (backbone)
    jcfg.data_config.path = [str(out)] if isinstance(
        jcfg.data_config.path, list) else str(out)
    jcfg.data_config.edge_capacity = 4096
    jcfg.data_config.n_train = jcfg.data_config.n_val = 0.5
    jcfg.data_config.preprocess = [jmasked2indexed, partial(
        jcrop.func, **jcrop.keywords, rng=np.random.default_rng(3))]
    port = next(getDataIters(cfg, seed=0)[0])
    want = next(jgetDataIters(jcfg, seed=0)[0])
    _assert_same_batch(port, want)
    assert int(port["_graph_mask"].sum()) == cfg["batch_size"]
    assert int(port["_n_nodes"].max()) <= 384


# ------------------------------------------------------- without h5py

NO_H5PY = r'''
import os, runpy, sys
sys.modules["h5py"] = None
sys.path.insert(0, {repo!r})
import numpy as np

from equivariant_nn_zoo_tpu_torch import inference
from equivariant_nn_zoo_tpu_torch.data import Batch, CondensedDataset, hdf5
from equivariant_nn_zoo_tpu_torch.models import get_config, register_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as lc

out = {out!r}
rng = np.random.default_rng(0)
items = [dict(R=rng.normal(size=(n, 3)).astype(np.float32) * 1.2,
              Z=rng.choice([1, 6, 7, 8], size=(n, 1)),
              U0=rng.normal(size=(1, 1)).astype(np.float32), _n_nodes=n)
         for n in rng.integers(3, 8, size=12)]
attrs = dict(R=("node", "1x1o"), Z=("node", "1x0e"), U0=("graph", "1x0e"))
qm9 = os.path.join(out, "qm9.hdf5")
Batch.from_data_list(items, attrs).dumpHDF5(qm9)
ds = CondensedDataset(path=qm9)
assert len(ds) == 12 and ds.attrs["R"] == ("node", "1x1o")


def tiny(spec=None):
    cfg = get_config("config_energy")
    cfg["model_config"] = lc.addEnergyOutput(lc.featureModel(
        n_dim=4, l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
        edge_radial="4x0e", num_types=10, num_layers=1, r_max=4.0),
        shifts=[0.0] * 10)
    cfg["data_config"] = dict(
        cfg["data_config"], path=qm9,
        key_map={{"Z": ("species", "atom_types"), "R": "pos",
                 "U0": "total_energy"}})
    cfg["batch_size"] = 5
    return cfg


register_config("config_tiny_noh5", tiny)
argv = ["--config", "config_tiny_noh5", "--device", "cpu",
        "--output_keys", "total_energy"]
dump = os.path.join(out, "inference.hdf5")
merged = inference.main(argv + ["--output_path", dump])
data, _ = hdf5.read(dump)
assert len(merged) == 12
assert np.array_equal(data["total_energy"], merged["total_energy"])
assert np.array_equal(data["_n_nodes"], merged["_n_nodes"])
try:
    inference.main(argv + ["--output_path",
                           os.path.join(out, "missing", "x.hdf5")])
except OSError:
    print("WRITE FAILURE RAISED")

for module, args in (("mmcif", [{cif!r}, os.path.join(out, "cif")]),
                     ("af2_multimer", [{mapping!r}, {labels!r},
                                       os.path.join(out, "af2")])):
    sys.argv = [module] + args
    runpy.run_module(
        f"equivariant_nn_zoo_tpu_torch.data_processing.{{module}}",
        run_name="__main__")
assert "h5py" not in [m for m in sys.modules if sys.modules[m] is not None]
print("NO H5PY OK")
'''


def test_files_without_h5py(tmp_path, cif_dir):
    mapping, labels = write_af2(tmp_path, np.random.default_rng(6),
                                n_multimers=3)
    script = tmp_path / "no_h5py.py"
    script.write_text(NO_H5PY.format(repo=REPO, out=str(tmp_path),
                                     cif=cif_dir, mapping=mapping,
                                     labels=labels))
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "WRITE FAILURE RAISED" in proc.stdout
    assert "NO H5PY OK" in proc.stdout
    jmmcif, jaf2 = jax_script("mmcif"), jax_script("af2_multimer")
    jmmcif.main(cif_dir, str(tmp_path / "jax_cif"))
    jaf2.main(mapping, labels, str(tmp_path / "jax_af2"))
    assert_same_files(tmp_path / "cif", tmp_path / "jax_cif")
    assert_same_files(tmp_path / "af2", tmp_path / "jax_af2")
