"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package (``full_conv.cu``,
``full_conv_bwd.cu``, ``full_conv_ext.cu``, ``species_sc.cu``,
``uvu_conv.cu``, ``pairwise_tp.cu``, ``row_mix.cu``; the tensor-core GEMM
of the mix and of the backwards' products in ``row_mix.cuh`` is shared by
six of them, the node-major walk in ``edge_walk.cuh`` by the first two)
for ``sm_90a`` (one compiler
process per source, all started together) and links the objects into one shared library with a
plain C interface under ``build/kernels/`` at the repository root (listed
in ``.gitignore``); ``ctypes`` loads it at first use.  The library's file
name carries a hash of the sources, headers and flags, so an edited source
is rebuilt and a current one is reused.  A failed build raises with the
compiler's output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# leading arguments of the three external-weight conv entries (K4f/b/g)
_EXT_COMMON = [
    _I, _I, _I,                # N, in_dim, J
    _P, _P, _I,                # src, dst, E
    _I,                        # radial-weight columns P * mul
    _P, _I, _P, _P,            # path table, P, CG non-zero codes, values
    _I, _I,                    # K * mul, mul
    _P, _I, _I,                # host mix problems, count, out_dim
]
# the node-major walk's arguments of K1 and K2 (csrc/edge_walk.cuh)
_WALK = [
    _P, _P, _I, _P, _P,        # walk table, chunks, count, cells, CG
                               # non-zeros
    _I, _I, _I,                # most non-zeros of a chunk, widest d1, d3
    _P, _P, _I, _I,            # edge order, its row pointers, cap, items
]
# C signatures of the entry points (pointers and the stream as c_void_p)
SIGNATURES = {
    "full_conv_fwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # edge_radial, R
        _P, _P, _I,            # src, dst, E
        _P, _I, _I,            # hidden MLP weights, H, n_hidden
        _P, _I, _F,            # last MLP layer, its width, activation scale
        *_WALK,
        _P, _P,                # work: last hidden layer, long-run pieces
        _P, _I, _I,            # scratch, K * mul, mul
        _P, _P, _I,            # mix matrices, host mix problems, count
        _P, _I, _P,            # out, out_dim, stream
    ],
    "species_sc_fwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # species, types
        _P, _I,                # tables, table row width
        _P, _I, _P,            # output slots, count, items
        _P, _I, _P,            # out, out_dim, stream
    ],
    "species_sc_bwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # species, types
        _P, _I,                # tables, table row width
        _P, _I,                # g, out_dim
        _P, _I,                # input slots, count
        _P, _I, _I, _I,        # backward items, count, max mul1, max mul_out
        _I,                    # widest irrep (register rows)
        _P, _P, _P,            # dx, dtables, stream
    ],
    "full_conv_bwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # edge_radial, R
        _P, _P, _I,            # src, dst, E
        _P, _I, _I,            # hidden MLP weights, H, n_hidden
        _P, _I, _F,            # last MLP layer, its width, activation scale
        *_WALK[:8],
        _P, _I, _I, _I,        # left irreps, count, dx row width, dx covered
        *_WALK[8:],
        _P, _I, _I,            # forward scratch, K * mul, mul
        _P, _I, _P, _I,        # mix matrices, their length, host problems, n
        _P, _I,                # gout, out_dim
        _P, _P, _P, _P, _P, _P,  # work: dS, dw, z, h, dh, dz,
        _P, _P,                # per-path dx rows, long-run pieces
        _P, _P, _P, _I,        # dx, d edge_radial, d hidden weights, length
        _P, _P,                # d last layer, d mix matrices
        _P, _I, _P,            # workspace, its length, stream
    ],
    "uvu_conv_fwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # radial weights, their columns P * mul
        _P, _I,                # src, E
        _P, _I, _P, _P,        # path table, P, CG non-zero codes, values
        _P, _I, _I,            # scratch, K * mul, mul
        _P, _P, _I,            # mix matrices, host mix problems, count
        _P, _I, _P,            # out, out_dim, stream
    ],
    "uvu_conv_bwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # radial weights, their columns P * mul
        _P, _I,                # src, E
        _P, _I, _P, _P,        # path table, P, CG non-zero codes, values
        _P, _I, _I,            # forward scratch, K * mul, mul
        _P, _I, _P, _I,        # mix matrices, their length, host problems, n
        _P, _I,                # gout, out_dim
        _P,                    # work: dS
        _P, _P, _P, _P,        # dx, dsh, dw, dwsel
        _P, _I, _P,            # workspace, its length, stream
    ],
    "pairwise_tp_fwd": [
        _P, _I, _I,            # left, M, its columns
        _P, _I,                # weighted right [M, R, mul], R
        _P, _I, _P, _P,        # path table, P, CG non-zero codes, values
        _P, _I, _I,            # scratch, K * mul, mul
        _P, _P, _I,            # mix matrices, host mix problems, count
        _P, _I, _P,            # out, out_dim, stream
    ],
    "pairwise_tp_bwd": [
        _P, _I, _I,            # left, M, its columns
        _P, _I,                # weighted right [M, R, mul], R
        _P, _I, _P, _P,        # path table, P, CG non-zero codes, values
        _P, _I, _P,            # left irreps, count, their paths
        _I, _I,                # K * mul, mul
        _P, _I, _P, _I,        # mix matrices, their length, host problems, n
        _P, _I,                # gout, out_dim
        _P, _P,                # work: S, dS
        _P, _P, _P,            # d left, d weighted right, dwsel
        _I,                    # which of them (1 dwsel, 2 d left, 4 dbw)
        _P, _I, _P,            # workspace, its length, stream
    ],
    "full_conv_ext_fwd": _EXT_COMMON + [
        _P, _P, _P, _P,        # x, sh, w, wsel
        _P, _P, _P,            # scratch, out, stream
    ],
    "full_conv_ext_bwd": _EXT_COMMON + [
        _P, _P, _P, _P, _P,    # x, sh, w, wsel, gout
        _P, _P,                # work: scratch, dS
        _P, _P, _P, _P, _I,    # dx, dsh, dw, dwsel, its length
        _P, _I, _P,            # workspace, its length, stream
    ],
    "full_conv_ext_grad2": _EXT_COMMON + [
        _P, _P, _P, _P,        # x, cx, sh, csh
        _P, _P, _P, _P,        # w, cw, wsel, gout
        _P, _P,                # work: scratch, dS
        _P, _P, _P, _P, _P,    # c_x, c_s, c_w, c_m, c_g
        _I,                    # wsel length
        _P, _I, _P,            # workspace, its length, stream
    ],
    "row_mix_forward": [
        _P, _I, _I,            # scratch, rows, K * mul
        _P, _P, _I,            # mix matrices, host mix problems, count
        _P, _I, _P,            # out, out_dim, stream
    ],
    "row_mix_backward": [
        _I, _P, _I,            # which (1 dS, 2 dwsel), host problems, count
        _I, _I, _I,            # rows, K * mul, out_dim
        _P, _P, _P,            # scratch, mix matrices, gout
        _P, _I,                # the product, the mix matrices' length
        _P, _I, _P,            # workspace, its length, stream
    ],
    "row_mix_matmul": [
        _P, _I, _P, _I,        # A, A stored [M, K], B, B stored [N, K]
        _P, _I, _I, _I,        # C [M, N], M, N, K
        _I, _P, _I, _P,        # split K, workspace, its length, stream
    ],
}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def build() -> Tuple[Path, str]:
    """Compile the kernels if their library is missing; return its path and
    the compiler's output (empty when an existing library was reused)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libe3kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = nvcc_path()
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [src.name for src, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with {res.returncode}:\n"
                               f"{log}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib, log


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_tensor(t, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what the kernels' C entry points take."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )
