"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package (``full_conv.cu``,
``full_conv_bwd.cu``, ``full_conv_ext.cu``, ``species_sc.cu``,
``uvu_conv.cu``, ``pairwise_tp.cu``, ``row_mix.cu``; the tensor-core GEMM
of the mix and of the backwards' products in ``row_mix.cuh`` is shared by
six of them, the node-major walk in ``edge_walk.cuh`` by the first three)
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
# the node-major walk's arguments of K1 and K2 (csrc/edge_walk.cuh)
_WALK = [
    _P, _P, _I, _P, _P,        # walk table, chunks, count, cells, CG
                               # non-zeros
    _I, _I, _I,                # most non-zeros of a chunk, widest d1, d3
    _P, _P, _I, _I,            # edge order, its row pointers, cap, items
]
# leading arguments of the three external-weight conv entries (K4f/b/g)
_EXT_COMMON = [
    _I, _I, _I,                # N, in_dim, J
    _P, _P, _I,                # src, dst, E
    _I,                        # radial-weight columns P * mul
    _P, _P, _I, _P, _I,        # walk table, chunks, count, the source-
                               # major walk's chunks, count
    _P, _P,                    # cells, CG non-zeros
    _I, _I, _I, _I,            # most non-zeros of a chunk, widest d1, d2, d3
    _P, _I, _I, _I,            # left irreps, count, dx row width, dx covered
    _P, _P, _P, _P, _I, _I,    # both edge orders and their row pointers,
                               # cap, items
    _I, _I,                    # K * mul, mul
    _P, _I, _I,                # host mix problems, count, out_dim
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
        _P, _P, _I,            # species order: perm, ptr; types
        _P, _I,                # tables, table row width
        _P, _P,                # output slots, items
        _P, _P, _I,            # entries, their host copy, count
        _P, _I, _P,            # out, out_dim, stream
    ],
    "species_sc_bwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _P, _I,            # species order: perm, ptr; types
        _P, _I,                # tables, table row width
        _P, _I,                # g, out_dim
        _P, _P,                # input slots, backward items
        _P, _P, _I,            # dx entries, their host copy, count
        _P, _P, _I,            # dtables entries, their host copy, count
        _I,                    # rows per dtables chunk
        _P, _I,                # workspace, its length
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
        _P, _P,                # dsh or null, its path chunks' rows
        _P, _I, _P,            # workspace, its length, stream
    ],
    "uvu_conv_fwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # radial weights, their columns P * mul
        _P, _I,                # src, E
        _P, _P, _P, _P,        # fused paths, non-zeros, host dimensions,
                               # radial-weight columns
        _P, _I, _I,            # units (one cut of the components), count,
                               # mul
        _P, _P, _I, _P,        # mix matrices, out, out_dim, stream
    ],
    "uvu_conv_bwd": [
        _P, _I, _I,            # x, N, in_dim
        _P, _I,                # sh, J
        _P, _I,                # radial weights, their columns P * mul
        _P, _I,                # src, E
        _P, _P, _P, _P,        # fused paths, non-zeros, host dimensions,
                               # radial-weight columns
        _P, _I, _I,            # dwsel units, count, edge tiles a chunk
        _P, _P, _P,            # adjoint sweep: paths, their weight columns
                               # and slots, the path-slots,
        _P, _I,                # non-zeros in two orders, their count,
        _P, _P, _I,            # chunks, units, count,
        _P, _I, _P,            # left irreps, count, host dimensions
        _P, _P,                # source-major edge order, its row pointers
        _I,                    # mul
        _P, _I, _P, _I,        # mix matrices, their length, gout, out_dim
        _P, _P, _P, _P,        # dx, dsh, dw, dwsel
        _P, _P, _P, _P,        # work: dwsel chunks, dx columns per edge,
                               # dsh rows per unit; stream
    ],
    "pairwise_tp_fwd": [
        _P, _I, _I,            # left, M, its columns
        _P, _I, _I,            # weighted right [M, R, mul], R, mul
        _P, _P, _P,            # fused paths, non-zeros, host dimensions
        _P, _I,                # units (one cut of the components), count
        _P, _P, _I, _P,        # mix matrices, out, out_dim, stream
    ],
    "pairwise_tp_bwd": [
        _P, _I, _I,            # left, M, its columns
        _P, _I, _I,            # weighted right [M, R, mul], R, paths
        _P, _P, _P,            # fused paths, non-zeros, host dimensions
        _P, _I, _I,            # K5m units, count, element tiles a chunk
        _P, _P,                # adjoint sweep: paths, their host copy,
        _P, _I,                # non-zeros in two orders, their count,
        _P, _P, _I,            # chunks, their host copy, count,
        _P, _I, _I,            # d left sums, count, elements per block
        _I, _I,                # K * mul, mul
        _P, _I, _P, _I,        # mix matrices, their length, host problems, n
        _P, _I,                # gout, out_dim
        _P,                    # work: dS
        _P, _P, _P,            # d left, d weighted right, dwsel
        _I,                    # which of them (1 dwsel, 2 d left, 4 dbw)
        _P, _I,                # workspace, its length,
        _P, _I,                # d left partials, their length,
        _P, _P,                # K5m's chunk partials, stream
    ],
    "full_conv_ext_fwd": _EXT_COMMON + [
        _P, _P, _P, _P,        # x, sh, w, wsel
        _P, _P, _P, _P,        # scratch, work: long-run pieces, out, stream
    ],
    "full_conv_ext_bwd": _EXT_COMMON + [
        _P, _P, _P, _P, _P,    # x, sh, w, wsel, gout
        _P,                    # K4f's saved scratch, or null
        _P, _P, _P, _P, _P,    # work: scratch, dS, per-path dx rows, pieces,
                               # the chunks' dsh rows
        _P, _P, _P, _P, _I,    # dx, dsh, dw, dwsel, its length
        _P, _I, _P,            # workspace, its length, stream
    ],
    "full_conv_ext_grad2": _EXT_COMMON + [
        _P, _P, _P, _P,        # x, cx, sh, csh
        _P, _P, _P, _P,        # w, cw, wsel, gout
        _P, _P, _P, _P, _P,    # work: scratch, dS, per-path dx rows, pieces,
                               # the chunks' dsh rows
        _P, _P, _P, _P, _P,    # c_x, c_s, c_w, c_m, c_g
        _I,                    # wsel length
        _P, _I, _P,            # workspace, its length, stream
    ],
    "row_mix_forward": [
        _P, _I, _I,            # scratch, rows, K * mul
        _P, _P, _I,            # mix matrices, host mix problems, count
        _P, _I, _I, _P,        # out, out_dim, bfloat16 products, stream
    ],
    "row_mix_backward": [
        _I, _P, _I,            # which (1 dS, 2 dwsel), host problems, count
        _I, _I, _I,            # rows, K * mul, out_dim
        _P, _P, _P,            # scratch, mix matrices, gout
        _P, _I,                # the product, the mix matrices' length
        _P, _I, _I, _P,        # workspace, its length, bfloat16, stream
    ],
    "row_mix_matmul": [
        _P, _I, _P, _I,        # A, A stored [M, K], B, B stored [N, K]
        _P, _I, _I, _I,        # C [M, N], M, N, K
        _I, _P, _I, _I, _P,    # split K, workspace, its length, bfloat16,
                               # stream
    ],
}
# the bfloat16 variants of K3 and K3b: the float32 entries' lists
# (bfloat16 pointers where the operands are bfloat16)
SIGNATURES.update({e + "_bf16": SIGNATURES[e] for e in (
    "species_sc_fwd", "species_sc_bwd")})
# the bfloat16 K1 and K2: the float32 entries' lists with the bfloat16
# walk's tables (csrc/bf16_walk.cuh) in place of the float32 walk's
_BF16_WALK = [_P, _P, _I, _P]  # tables, tiles, units, host dimensions
_CONV_HEAD = SIGNATURES["full_conv_fwd"][:16]
SIGNATURES["full_conv_fwd_bf16"] = [
    *_CONV_HEAD, *_BF16_WALK, *_WALK[8:],
    _P, _P, _P,                # work: last hidden layer, long-run pieces,
                               # W_out transposed
    *SIGNATURES["full_conv_fwd"][30:]]
# leading arguments of the bfloat16 K4f, K4b and K4g entries
_EXT_BF16_COMMON = [
    _I, _I, _I,                # N, in_dim, J
    _P, _P, _I,                # src, dst, E
    _I, _I, _I, _I,            # P * mul, K * mul, mul, out_dim
    *_BF16_WALK,               # the bfloat16 walks' tables
    _I,                        # dx covered
    _P, _P, _P, _P,            # both edge orders and their row pointers
    _I, _I,                    # cap, items
    _P, _I,                    # host mix problems, count
]
SIGNATURES["full_conv_ext_fwd_bf16"] = _EXT_BF16_COMMON + [
    _P, _P, _P, _P,            # x, sh, w, wsel
    _P, _P, _P, _P,            # scratch, work: long-run pieces, out, stream
]
SIGNATURES["full_conv_ext_bwd_bf16"] = _EXT_BF16_COMMON + [
    _P, _P, _P, _P, _P,        # x, sh, w, wsel, gout
    _P,                        # K4f's saved scratch, or null
    _P, _P, _P, _P,            # work: scratch, pieces, dS, each left
                               # irrep's dsh sums
    _P, _P, _P, _P, _I,        # dx, dsh, dw, dwsel, its length
    _P, _I, _P,                # workspace, its length, stream
]
SIGNATURES["full_conv_ext_grad2_bf16"] = _EXT_BF16_COMMON + [
    _P, _P, _P, _P,            # x, cx, sh, csh
    _P, _P, _P, _P,            # w, cw, wsel, gout
    _P, _P, _P, _P,            # work: scratch, pieces, dS, each left
                               # irrep's two c_s sums
    _P, _P, _P, _P, _P,        # c_x, c_s, c_w, c_m, c_g
    _I,                        # wsel length
    _P, _I, _P,                # workspace, its length, stream
]
SIGNATURES["full_conv_bwd_bf16"] = [
    *_CONV_HEAD, *_BF16_WALK,
    _I,                        # dx covered
    *_WALK[8:],
    _P, _I, _I,                # forward scratch, K * mul, mul
    _P, _I, _P, _I,            # mix matrices, their length, host problems, n
    _P, _I,                    # gout, out_dim
    _P, _P, _P, _P, _P, _P,    # work: dS, dw, z, h, dh, dz,
    _P, _P,                    # long-run pieces of dx, W_out transposed
    _P, _P, _P, _I,            # dx, d edge_radial, d hidden weights, length
    _P, _P,                    # d last layer, d mix matrices
    _P, _I, _P,                # workspace, its length, stream
]


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


class KernelSwitch:
    """What every module that holds a kernel wrapper shares: ``kernels``,
    true unless ``models.build_model(..., kernels=False)`` (``set_kernels``)
    turned it off for the model.  Off, the wrapper takes its plain version
    on CUDA tensors too; on the CPU it always does.  Nothing turns it off
    by itself: a kernel that fails to build or launch raises."""

    kernels = True

    def uses_kernel(self, x: "torch.Tensor") -> bool:
        """Whether a call on ``x`` launches the kernel."""
        return self.kernels and x.device.type != "cpu"


def set_kernels(model, on: bool) -> None:
    """Give every kernel-holding module of ``model`` ``kernels = on``."""
    for module in model.modules():
        if isinstance(module, KernelSwitch):
            module.kernels = bool(on)


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
