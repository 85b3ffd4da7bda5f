"""Atomic/async persistence: background writer thread, temp-file + atomic
rename (cross-filesystem safe), write groups, multi-format save/load,
molecule writers, checkpoint save/restore for nested state dicts.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/utils/saveload.py``.
Pickles hold nested dicts of numpy arrays: tensors are copied to the host
and converted at save time (``_numpyify``), so a checkpoint unpickles with
numpy alone and the two packages read each other's parameter files.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from .utils import default_type_names

# accumulate writes to group for renaming
_MOVE_SET = contextvars.ContextVar("_move_set", default=None)


# ---------------------------------------------------------------- molecules


def saveMol(batch, type_names=None, idx=0, workdir="", filename="tmp"):
    """Save one molecule of a batch in gromacs .gro format.

    Reference parity: saveload.py:17-38.
    """
    import numpy as np

    if type_names is None:
        type_names = default_type_names()
    item = batch[idx] if hasattr(batch, "get") else batch
    n = int(np.asarray(item["_n_nodes"]).reshape(-1)[0])
    lines = ["title", f"{n}"]
    pos = np.asarray(item["pos"]).reshape(-1, 3)
    species = np.asarray(item["species"]).reshape(-1).astype(int)
    for i in range(n):
        name = type_names[species[i]]
        line = f"{1:>5}{'none':>5}{name:>5}{i:>5}"
        x, y, z = pos[i] * 0.1  # A to nm
        line += f"{x:>8.3f}{y:>8.3f}{z:>8.3f}"
        line += f"{0.:>8.4f}{0.:>8.4f}{0.:>8.4f}"
        lines.append(line)
    filename = os.path.join(workdir, filename) + ".gro"
    with open(filename, "w") as f:
        f.write("\n".join(lines))
    return filename


AA_CODES = [
    "ALA", "ARG", "ASP", "ASN", "CYS", "GLU", "GLN", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "UNK",
]


def saveProtein(batch, workdir, idx=0, filename="tmp"):
    """Save one protein (CA or backbone keys) of a batch as .pdb.

    Reference parity: saveload.py:40-88.
    """
    import numpy as np

    aa_ids = {i: key for i, key in enumerate(AA_CODES)}
    filename = os.path.join(workdir, filename) + ".pdb"
    item = batch[idx] if hasattr(batch, "get") else batch
    n = int(np.asarray(item["_n_nodes"]).reshape(-1)[0])
    species = np.asarray(item["species"]).reshape(-1).astype(int)
    with open(filename, "w") as f:
        for i in range(n):
            for j, key in enumerate(["C", "N", "CA", "O"]):
                if key not in item.keys():
                    continue
                atom = "ATOM"
                atom_id = i * 4 + j
                res = aa_ids.get(min(species[i], len(AA_CODES) - 1), "UNK")
                if "id" in item.keys():
                    res_id = int(np.asarray(item["id"]).reshape(-1)[i]) + 1
                else:
                    res_id = i + 1
                x, y, z = np.asarray(item[key]).reshape(-1, 3)[i]
                chain = 0
                if "chain_id" in item.keys():
                    chain = int(np.asarray(item["chain_id"]).reshape(-1)[i])
                chain_id = chr(ord("A") + chain)
                line = (
                    f"{atom:6s}{atom_id:5d} {key:^4s} {res:3s} "
                    f"{chain_id:1s}{res_id:4d}{'':1s}"
                )
                line += (
                    f"   {x:8.3f}{y:8.3f}{z:8.3f}{0:6.2f}{0:6.2f}"
                    f"          {key[0]:>2s}{'':2s}\n"
                )
                f.write(line)
        f.write("TER\nEND\n")
    return filename


# ------------------------------------------------------- atomic async write
#
# Staged-file publication. ``atomic_write`` stages content into a temp file,
# then hands a (staged, destination) pair to the publisher; publication is
# a copy-into-destination-directory followed by an atomic rename, so readers
# (and a preemption) only ever observe complete files. ``atomic_write_group``
# batches several publications into one unit. Feature parity with the
# reference's background-writer design (e3_layers/utils/saveload.py:103-190,
# C15) but built on a single-lane ThreadPoolExecutor instead of a hand-rolled
# thread + Queue.


def _delete_files_if_exist(paths):
    for f in paths:
        Path(f).unlink(missing_ok=True)


@dataclass
class _StagedWrite:
    staged: Path  # temp file already holding the final content
    destination: Path
    sync: bool  # caller asked to block until the file is published


def _publish(batch: List[_StagedWrite]) -> None:
    """Publish a batch of staged files: land each next to its destination
    (works across filesystems), then rename into place. Staged files are
    always removed, even on failure, so aborted writes leave no litter."""
    try:
        for w in batch:
            landing = w.destination.parent / f".tmp-{w.destination.name}~"
            shutil.move(w.staged, landing)
            landing.rename(w.destination)
        logging.debug(
            "Published %s", ", ".join(w.destination.name for w in batch)
        )
    finally:
        _delete_files_if_exist([w.staged for w in batch])


class _Publisher:
    """Runs `_publish` batches on a single-lane executor.

    One worker lane keeps publications ordered (last-writer-wins semantics
    for repeated saves of e.g. ``last.ckpt``). Failures are re-raised on the
    main thread at the next submit or drain, never swallowed.
    """

    def __init__(self, asynchronous: bool):
        self.asynchronous = asynchronous
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: List = []
        self._guard = threading.Lock()

    def _reap(self, wait: bool) -> None:
        """Drop finished futures, re-raising the first stored exception."""
        with self._guard:
            inflight, self._inflight = self._inflight, []
        failure = None
        for fut in inflight:
            if wait or fut.done():
                exc = fut.exception()  # waits when not yet done
                if exc is not None and failure is None:
                    failure = exc
            else:
                with self._guard:
                    self._inflight.append(fut)
        if failure is not None:
            raise RuntimeError("Async writer failed.") from failure

    def submit(self, batch: List[_StagedWrite]) -> None:
        if not batch:
            return
        if not self.asynchronous:
            _publish(batch)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="e3-writer"
            )
        self._reap(wait=False)
        fut = self._pool.submit(_publish, batch)
        with self._guard:
            self._inflight.append(fut)
        if any(w.sync for w in batch):
            self._reap(wait=True)

    def drain(self) -> None:
        self._reap(wait=True)


_PUBLISHER = _Publisher(asynchronous=True)


def _submit_move(from_name, to_name, blocking: bool):
    """Queue one staged file for publication (or append to the open group)."""
    write = _StagedWrite(Path(from_name), Path(to_name), sync=blocking)
    group = _MOVE_SET.get()
    if group is None:
        _PUBLISHER.submit([write])
    else:
        group.append(write)


@contextlib.contextmanager
def atomic_write_group():
    """Collect every ``atomic_write`` in the block into one publication unit
    so a preemption can never observe a half-written checkpoint set.
    Entering while a group is already open joins the outer group.

    Reference parity: saveload.py:167-184.
    """
    if _MOVE_SET.get() is not None:
        yield
        return
    token = _MOVE_SET.set([])
    try:
        yield
        _PUBLISHER.submit(_MOVE_SET.get())
    finally:
        _MOVE_SET.reset(token)


def finish_all_writes():
    _PUBLISHER.drain()


@contextlib.contextmanager
def atomic_write(filename, blocking: bool = True, binary: bool = False):
    """Reference parity: saveload.py:219-252."""
    aslist = isinstance(filename, list)
    filenames = [Path(f) for f in (filename if aslist else [filename])]
    with contextlib.ExitStack() as stack:
        files = [
            stack.enter_context(
                tempfile.NamedTemporaryFile(
                    mode="w" + ("b" if binary else ""), delete=False
                )
            )
            for _ in filenames
        ]
        try:
            yield files if aslist else files[0]
        except:  # noqa: E722 — always clean up temp files on failure
            _delete_files_if_exist([Path(f.name) for f in files])
            raise
        for tp, fname in zip(files, filenames):
            _submit_move(Path(tp.name), Path(fname), blocking=blocking)


# ----------------------------------------------------- multi-format save/load

SUPPORTED_FORMATS = dict(
    pickle=["pickle", "pkl", "pt", "pth"],
    yaml=["yaml", "yml"],
    json=["json"],
    npz=["npz"],
)


def _match_suffix(filename: str):
    for fmt, suffixes in SUPPORTED_FORMATS.items():
        for s in suffixes:
            if str(filename).endswith("." + s):
                return fmt
    raise NotImplementedError(f"cannot infer format of {filename}")


def adjust_format_name(supported_formats, filename, enforced_format=None):
    if enforced_format is not None:
        fmt = enforced_format
        if not any(
            str(filename).endswith("." + s) for s in supported_formats[fmt]
        ):
            filename = f"{filename}.{supported_formats[fmt][0]}"
    else:
        fmt = _match_suffix(filename)
    return fmt, filename


def save_file(item, filename: str, enforced_format: str = None,
              blocking: bool = True):
    """Save yaml/json/pickle/npz with atomic (optionally async) writes.

    Reference parity: saveload.py:255-317; torch format maps to pickle of
    numpy trees.
    """
    path = os.path.dirname(os.path.realpath(filename))
    os.makedirs(path, exist_ok=True)
    fmt, filename = adjust_format_name(SUPPORTED_FORMATS, filename,
                                       enforced_format)
    binary = fmt in ("pickle", "npz")
    with atomic_write(filename, blocking=blocking, binary=binary) as f:
        if fmt == "json":
            import json

            json.dump(item, f)
        elif fmt == "yaml":
            import yaml

            yaml.dump(item, f)
        elif fmt == "pickle":
            import pickle

            pickle.dump(_numpyify(item), f)
        elif fmt == "npz":
            import numpy as np

            np.savez(f, **item)
    return filename


def load_file(filename: str, enforced_format: str = None):
    """Reference parity: saveload.py:319-360."""
    fmt = enforced_format or _match_suffix(filename)
    if not os.path.isfile(filename):
        abs_path = str(Path(filename).resolve())
        raise OSError(f"file {filename} at {abs_path} is not found")
    if fmt == "json":
        import json

        with open(filename) as fin:
            return json.load(fin)
    if fmt == "yaml":
        import yaml

        with open(filename) as fin:
            return yaml.load(fin, Loader=yaml.Loader)
    if fmt == "pickle":
        import pickle

        with open(filename, "rb") as fin:
            return pickle.load(fin)
    if fmt == "npz":
        import numpy as np

        return np.load(filename, allow_pickle=True)
    raise NotImplementedError(f"format {fmt}")


def _numpyify(tree):
    """Copy tensors to host numpy arrays (through dicts, lists and tuples)
    so pickles are framework-neutral."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpyify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_numpyify(v) for v in tree)
    return tree


# ------------------------------------------------------------- checkpoints


def save_checkpoint(path: str, state: dict, blocking: bool = False):
    """Save a flat training-state dict (params/opt/ema/step/rng trees).

    Reference parity: saveload.py:447-454 (same (path, state) argument order
    as the reference's ``save_checkpoint(ckpt_dir, state)``).
    """
    save_file(state, path, enforced_format="pickle", blocking=blocking)
    return path


def restore_checkpoint(path: str, state: dict = None):
    """Gracefully return the input state when the file is absent.

    Reference parity: saveload.py:432-444.
    """
    if not os.path.exists(path):
        logging.warning(
            f"No checkpoint found at {path}. Returned the same state as input"
        )
        return state
    return load_file(path, enforced_format="pickle")
