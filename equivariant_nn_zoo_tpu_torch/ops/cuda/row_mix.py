"""The tensor-core GEMM of ``csrc/row_mix.cuh`` on its own: the mix of the
conv and pairwise kernels, the two mix products of their backwards, and a
plain matrix product (K2's radial-MLP stage), with their plain PyTorch
versions.

The convolution and pairwise kernels launch the GEMM from their own C
entries; the wrappers here (``launch_forward``, ``launch_backward``,
``launch_matmul``) call it alone, for the card tests and the timings of
``chip_smoke.py``.  ``launches()`` reads the library's count of the GEMM's
launches, forward mix and backward products apart, whoever launched them.

The plan (which problems make one product, which rows one split) is the
host side of the C code, written out here: ``plan`` groups the problems of
a mix table into owners and launches, ``split_rows`` sizes a launch's row
splits, and ``run_plan`` runs a plan with ``torch.matmul`` in float32 —
the plain version of the kernel's arithmetic, and what the CPU tests hold
to ``full_conv.mix_rows`` and its autograd.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np
import torch

from .build import check, check_tensor, load_library

TILE = 64                    # output tile, both axes
DEPTH = 32                   # reduction depth of a stage (kBK)
TARGET_BLOCKS = 4 * 132      # a split product's blocks: 4 per SM
MIN_SPLIT_ROWS = 64
MAX_JOBS, MAX_MEMBERS = 24, 48   # per launch
# partial tiles of split products, in floats (kWorkspaceFloats)
WORKSPACE_FLOATS = 2 * TARGET_BLOCKS * TILE * TILE

FORWARD, ROWS, WEIGHTS = 0, 1, 2   # the mix; dS; dwsel


class Job(NamedTuple):
    """One product: the problems (rows of the table) it sums, in order,
    and its output shape (M, N)."""
    members: List[int]
    M: int
    N: int


def owners(prob_rows, kind: int) -> List[List[int]]:
    """The problems of each product, in table order: one per problem
    (FORWARD), per scratch block a_col (ROWS: an output group's slots) or
    per mix matrix b_off (WEIGHTS: a (group, slot)'s d components)."""
    if kind == FORWARD:
        return [[q] for q in range(len(prob_rows))]
    key = 0 if kind == ROWS else 2
    groups = {}
    for q, row in enumerate(prob_rows):
        groups.setdefault(int(row[key]), []).append(q)
    return list(groups.values())


def plan(prob_rows, kind: int, rows: int) -> List[List[Job]]:
    """The launches of one mix product over ``rows`` scratch rows: lists of
    jobs of at most ``MAX_JOBS`` jobs and ``MAX_MEMBERS`` members."""
    launches, cur, n_mem = [], [], 0
    for members in owners(prob_rows, kind):
        a_col, kdim, b_off, wo = (int(v) for v in prob_rows[members[0]][:4])
        M, N = {FORWARD: (rows, wo), ROWS: (rows, kdim),
                WEIGHTS: (kdim, wo)}[kind]
        if M <= 0 or N <= 0:
            continue
        if len(members) > MAX_MEMBERS:
            raise ValueError(f"{len(members)} problems share one product")
        if len(cur) == MAX_JOBS or n_mem + len(members) > MAX_MEMBERS:
            launches.append(cur)
            cur, n_mem = [], 0
        cur.append(Job(members, M, N))
        n_mem += len(members)
    if cur:
        launches.append(cur)
    return launches


def tiles(jobs: List[Job]) -> int:
    return sum(-(-j.M // TILE) * -(-j.N // TILE) for j in jobs)


def split_rows(jobs: List[Job], K: int,
               ws_len: int = WORKSPACE_FLOATS) -> List[range]:
    """The row chunks of one launch of a product that reduces over K rows:
    as many as the card needs blocks (``TARGET_BLOCKS``), each at least
    ``MIN_SPLIT_ROWS`` rows and a multiple of ``DEPTH``, all partial tiles
    within the workspace."""
    mn = sum(j.M * j.N for j in jobs)
    splits = 1
    if K > 0 and mn > 0:
        splits = -(-TARGET_BLOCKS // max(tiles(jobs), 1))
        splits = min(splits, max(1, K // MIN_SPLIT_ROWS), ws_len // mn,
                     65535)
        splits = max(1, splits)
    if splits == 1:
        return [range(0, K)]
    chunk = -(-(-(-K // splits)) // DEPTH) * DEPTH
    return [range(k, min(K, k + chunk)) for k in range(0, K, chunk)]


def run_plan(kind: int, prob_rows, rows: int, KM: int, out_dim: int,
             S=None, wsel=None, gout=None, wsel_len: int = 0):
    """The product ``kind`` as the kernel computes it, in plain PyTorch:
    per job the members' products summed in order, WEIGHTS' row splits
    summed in split order.  FORWARD: out [rows, out_dim] from S and wsel;
    ROWS: dS [rows, KM] from gout and wsel; WEIGHTS: dwsel [wsel_len] from
    S and gout."""
    ref = S if S is not None else gout
    shape = {FORWARD: (rows, out_dim), ROWS: (rows, KM),
             WEIGHTS: (wsel_len,)}[kind]
    out = ref.new_zeros(shape)
    for launch in plan(prob_rows, kind, rows):
        chunks = (split_rows(launch, rows) if kind == WEIGHTS
                  else [range(0, rows)])
        for job in launch:
            total = None
            for ch in chunks:
                part = None
                for q in job.members:
                    a_col, kdim, b_off, wo, c_off, cs = (
                        int(v) for v in prob_rows[q])
                    w = wsel[b_off: b_off + kdim * wo].reshape(kdim, wo) \
                        if wsel is not None else None
                    r = slice(ch.start, ch.stop)
                    if kind == FORWARD:
                        t = S[r, a_col: a_col + kdim] @ w
                    elif kind == ROWS:
                        t = gout[r, c_off: c_off + cs * wo: cs] @ w.T
                    else:
                        t = S[r, a_col: a_col + kdim].T @ \
                            gout[r, c_off: c_off + cs * wo: cs]
                    part = t if part is None else part + t
                total = part if total is None else total + part
            q0 = prob_rows[job.members[0]]
            a_col, kdim, b_off, wo, c_off, cs = (int(v) for v in q0)
            if kind == FORWARD:
                out[:, c_off: c_off + cs * wo: cs] = total
            elif kind == ROWS:
                out[:, a_col: a_col + kdim] = total
            else:
                out[b_off: b_off + kdim * wo] = total.reshape(-1)
    return out


def launches():
    """``{"forward": n, "backward": n}``: the GEMM's launches counted by the
    kernel library since it was loaded or last reset."""
    counts = (ctypes.c_longlong * 2).in_dll(load_library(),
                                            "rowmix_launches")
    return {"forward": int(counts[0]), "backward": int(counts[1])}


def reset_launches() -> None:
    counts = (ctypes.c_longlong * 2).in_dll(load_library(),
                                            "rowmix_launches")
    counts[0] = counts[1] = 0


def workspace(device, gout_numel: int = 0) -> torch.Tensor:
    """Work space of one C entry's products: the component-major copy of
    gout (``gout_numel`` floats, for the mix products), then the split
    products' partial tiles."""
    return torch.empty(gout_numel + WORKSPACE_FLOATS, dtype=torch.float32,
                       device=device)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_mix(prob_rows, S, wsel, gout, rows, KM, out_dim):
    dev = (S if S is not None else gout).device
    if dev.type != "cuda":
        raise ValueError(f"row_mix kernel needs CUDA tensors, got {dev}")
    if S is not None:
        check_tensor(S, "S", (rows, KM), torch.float32, dev)
    if gout is not None:
        check_tensor(gout, "gout", (rows, out_dim), torch.float32, dev)
    if wsel is not None and (wsel.device != dev or wsel.dim() != 1
                             or not wsel.is_contiguous()):
        raise ValueError("wsel: want a contiguous 1-d tensor on the device")
    if not (isinstance(prob_rows, np.ndarray)
            and prob_rows.dtype == np.int32 and prob_rows.ndim == 2
            and prob_rows.shape[1] == 6 and prob_rows.flags.c_contiguous):
        raise ValueError("prob_rows: want a contiguous int32 [n, 6] array")
    return dev


def launch_forward(S, wsel, prob_rows, out_dim: int) -> torch.Tensor:
    """The forward mix of S [rows, KM]: out [rows, out_dim]; the plain
    version on the CPU (``run_plan``)."""
    rows, KM = S.shape
    if S.device.type == "cpu":
        return run_plan(FORWARD, prob_rows, rows, KM, out_dim, S=S,
                        wsel=wsel)
    dev = _check_mix(prob_rows, S, wsel, None, rows, KM, out_dim)
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = load_library().row_mix_forward(
            S.data_ptr(), rows, KM, wsel.data_ptr(), prob_rows.ctypes.data,
            len(prob_rows), out.data_ptr(), out_dim, _stream(dev))
    check(err, "row_mix_forward")
    return out


def launch_backward(kind: int, prob_rows, KM: int, gout, S=None, wsel=None,
                    wsel_len: int = 0) -> torch.Tensor:
    """ROWS: dS [rows, KM] from gout [rows, out_dim] and wsel; WEIGHTS:
    dwsel [wsel_len] from S [rows, KM] and gout.  The plain version on the
    CPU."""
    rows, out_dim = gout.shape
    if gout.device.type == "cpu":
        return run_plan(kind, prob_rows, rows, KM, out_dim, S=S, wsel=wsel,
                        gout=gout, wsel_len=wsel_len)
    if kind not in (ROWS, WEIGHTS):
        raise ValueError(f"unknown backward product {kind}")
    dev = _check_mix(prob_rows, S, wsel, gout, rows, KM, out_dim)
    shape = (rows, KM) if kind == ROWS else (wsel_len,)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ws = workspace(dev, gout.numel())
    with torch.cuda.device(dev):
        err = load_library().row_mix_backward(
            kind, prob_rows.ctypes.data, len(prob_rows), rows, KM, out_dim,
            S.data_ptr() if S is not None else None,
            wsel.data_ptr() if wsel is not None else None, gout.data_ptr(),
            out.data_ptr(), wsel_len, ws.data_ptr(), ws.numel(),
            _stream(dev))
    check(err, "row_mix_backward")
    return out


def launch_matmul(A, B, a_t: bool = False, b_t: bool = False,
                  split: bool = False) -> torch.Tensor:
    """C = op(A) @ op(B), op(X) = X.T where ``*_t``, for contiguous float32
    A and B (K2's radial-MLP products: dW = h.T @ dw with ``a_t`` and
    ``split``, dh = dw @ W.T with ``b_t``); torch.matmul on the CPU."""
    Am = A.T if a_t else A
    Bm = B.T if b_t else B
    if A.device.type == "cpu":
        return Am @ Bm
    dev = A.device
    (M, K), N = Am.shape, Bm.shape[1]
    check_tensor(A, "A", tuple(A.shape), torch.float32, dev)
    check_tensor(B, "B", tuple(B.shape), torch.float32, dev)
    if Bm.shape[0] != K:
        raise ValueError(f"matmul: {tuple(Am.shape)} @ {tuple(Bm.shape)}")
    C = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = workspace(dev) if split else None
    with torch.cuda.device(dev):
        err = load_library().row_mix_matmul(
            A.data_ptr(), int(not a_t), B.data_ptr(), int(b_t), C.data_ptr(),
            M, N, K, int(split), ws.data_ptr() if ws is not None else None,
            ws.numel() if ws is not None else 0, _stream(dev))
    check(err, "row_mix_matmul")
    return C
