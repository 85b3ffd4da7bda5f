"""K6 and K6b: the per-edge uvu tensor-product convolution without the edge
sum, forward and backward, around ``csrc/uvu_conv.cu``.

The kernels replace the TPU kernels ``PallasUVUConv._fwd_kernel`` and
``_bwd_kernel`` (``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:233`` and
``:278``), whose live use is the neighbor conv of the hamiltonian head
(``Pairwise``, ``reduce=False``):

    out[e] = Mix_wsel( w_e (.) CG(x[src_e] (x) sh_e) )        [E, out_dim]

with per-edge radial weights ``w [E, P * mul]`` from the caller's MLP
(columns in the expansion's instruction order) and the flat mix matrices
``wsel`` (the mix ``Linear``'s alphas folded in, ``ConvTables.flat_wsel``).
Row and table conventions are K1's (``ConvTables``); the gather of
``x[src]`` is an indexed load inside the kernel.

For tensors on the CPU the wrapper runs the plain version
(``FusedUVUConv`` with ``reduce=False``) and autograd differentiates it.
For CUDA tensors it goes through ``UVUConvFunction``, whose forward
launches K6 and whose backward launches K6b (``dx``, ``dsh``, ``dw``,
``dwsel``), or raises; autograd carries ``dw`` back into the caller's radial
MLP and ``dwsel`` to ``tp.linear.*``.  ``plain_forward`` and
``plain_backward`` are the plain PyTorch versions of the two kernels'
contracts on the flat mix matrices, for the tests and the on-card checks.
"""

from __future__ import annotations

import torch

from . import row_mix
from .build import check, check_tensor, load_library
from .full_conv import MAX_D, MAX_SH, ConvTables


class UVUConv(ConvTables):
    """K6 and K6b for one ``FactorizedConvolution`` built with
    ``reduce=False``; the expansion's mix ``Linear`` is passed at call time,
    the radial weights come from the caller's MLP."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0
    backward_launches = 0

    def __init__(self, tpe):
        super().__init__(tpe)
        if not self.rows_complete:
            raise ValueError("UVUConv: a CG path has a component without a "
                             "non-zero; the kernel would leave its scratch "
                             "row unwritten")

    def forward(self, linear, x: torch.Tensor, sh: torch.Tensor,
                w: torch.Tensor, edge_src: torch.Tensor) -> torch.Tensor:
        """x [N, in_dim] (already linear_1'd), sh [E, J], radial weights
        w [E, P * mul], edge_src [E] -> per-edge output [E, out_dim]."""
        if x.device.type == "cpu":
            return self.fused(linear, x, edge_src, None, sh, w, x.shape[0],
                              reduce=False)
        return self.launch(linear, x, sh, w, edge_src)

    def launch(self, linear, x, sh, w, edge_src):
        """The kernel path: the flat mix matrices in plain PyTorch, then
        K6, through ``UVUConvFunction`` (K6b in the backward) when a
        gradient is wanted."""
        wsel = self.flat_wsel(linear)
        args = (x.contiguous(), sh.contiguous(), w.contiguous(), wsel)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return UVUConvFunction.apply(self, *args, edge_src)
        return launch_forward(self, *args, edge_src)[0]

    def plain_forward(self, x, sh, w, wsel, edge_src):
        """Plain PyTorch version of K6's contract: ``(out [E, out_dim],
        scratch [E, K * mul])`` (the conv core with every edge its own
        destination; the scratch holds the weighted, unmixed rows)."""
        E = sh.shape[0]
        rows = torch.arange(E, device=x.device)
        return self.plain_core(x, sh, w, wsel, edge_src, rows, E)

    def plain_backward(self, x, sh, w, wsel, edge_src, scratch, gout):
        """Plain PyTorch version of K6b's contract: ``(dx, dsh, dw,
        dwsel)`` for the cotangent ``gout``, by autograd of
        ``plain_forward`` (which recomputes what the kernel reads from
        ``scratch``)."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x, sh, w, wsel)]
            out, _ = self.plain_forward(*ins, edge_src)
            return torch.autograd.grad(out, ins, gout)


class UVUConvFunction(torch.autograd.Function):
    """K6 forward, K6b backward.  Differentiable inputs: ``x``, ``sh``,
    ``w`` and the flat mix matrices.  The forward's scratch is saved for
    ``dwsel``.  (``needs_input_grad`` does not see grad mode, so
    ``UVUConv.launch`` calls this under grad mode only.)"""

    @staticmethod
    def forward(ctx, conv, x, sh, w, wsel, edge_src):
        out, scratch = launch_forward(conv, x, sh, w, wsel, edge_src)
        ctx.save_for_backward(x, sh, w, wsel, edge_src, scratch)
        ctx.conv = conv
        return out

    @staticmethod
    def backward(ctx, gout):
        grads = launch_backward(ctx.conv, *ctx.saved_tensors,
                                gout.contiguous())
        return (None, *(g if need else None for g, need in
                        zip(grads, ctx.needs_input_grad[1:5])), None)


def _check_inputs(conv, x, sh, w, wsel, edge_src):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"UVUConv kernel needs CUDA tensors, got {dev}")
    fused = conv.fused
    N, E = x.shape[0], sh.shape[0]
    check_tensor(x, "x", (N, fused.irreps_in.dim), torch.float32, dev)
    check_tensor(sh, "sh", (E, fused.J_dim), torch.float32, dev)
    check_tensor(w, "w", (E, fused.weight_numel), torch.float32, dev)
    check_tensor(wsel, "wsel", (conv.wsel_len,), torch.float32, dev)
    check_tensor(edge_src, "edge_src", (E,), torch.int64, dev)
    if not (N >= 1 and fused.J_dim <= MAX_SH and fused.mul * 4 <= 1024):
        raise ValueError(f"UVUConv kernel does not take N={N}, "
                         f"J={fused.J_dim}, mul={fused.mul}")
    if conv.path_table.device != dev:
        raise ValueError("UVUConv tables are not on the input's device")
    return dev, N, E


def launch_forward(conv, x, sh, w, wsel, edge_src):
    """Launch K6: ``(out [E, out_dim], scratch [E, K * mul])``, the scratch
    holding the weighted, unmixed rows that the backward reads."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src)
    fused = conv.fused
    scratch = torch.empty((E, conv.KM), dtype=torch.float32, device=dev)
    out = torch.empty((E, conv.out_dim), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uvu_conv_fwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            w.data_ptr(), fused.weight_numel,
            edge_src.data_ptr(), E,
            conv.path_table.data_ptr(), conv.n_paths,
            conv.nz_idx.data_ptr(), conv.nz_c.data_ptr(),
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.prob_rows.ctypes.data, conv.n_probs,
            out.data_ptr(), conv.out_dim, stream,
        )
    check(err, "uvu_conv_fwd")
    UVUConv.launches += 1
    return out, scratch


def launch_backward(conv, x, sh, w, wsel, edge_src, scratch, gout):
    """Launch K6b: ``(dx [N, in_dim], dsh [E, J], dw [E, P * mul],
    dwsel)``, all float32, from the forward's inputs, its scratch and
    ``gout [E, out_dim]``."""
    dev, N, E = _check_inputs(conv, x, sh, w, wsel, edge_src)
    check_tensor(scratch, "scratch", (E, conv.KM), torch.float32, dev)
    check_tensor(gout, "gout", (E, conv.out_dim), torch.float32, dev)
    fused = conv.fused
    lanes = min(fused.mul, 32)
    if not (max(conv.max_d1, conv.max_d2) <= MAX_D
            and lanes & (lanes - 1) == 0 and fused.mul % lanes == 0):
        raise ValueError(
            f"the UVUConv backward takes irreps up to l = 4 and a power of "
            f"two or a multiple of 32 channels, got d = "
            f"{max(conv.max_d1, conv.max_d2)}, mul = {fused.mul}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx, dsh = empty(N, fused.irreps_in.dim), empty(E, fused.J_dim)
    dw, dwsel = empty(E, fused.weight_numel), empty(conv.wsel_len)
    dS = empty(E, conv.KM)          # work: cotangent of the scratch
    ws = row_mix.workspace(dev, gout.numel())   # see row_mix.workspace
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.uvu_conv_bwd(
            x.data_ptr(), N, fused.irreps_in.dim,
            sh.data_ptr(), fused.J_dim,
            w.data_ptr(), fused.weight_numel,
            edge_src.data_ptr(), E,
            conv.path_table.data_ptr(), conv.n_paths,
            conv.nz_idx.data_ptr(), conv.nz_c.data_ptr(),
            scratch.data_ptr(), conv.KM, fused.mul,
            wsel.data_ptr(), conv.wsel_len,
            conv.prob_rows.ctypes.data, conv.n_probs,
            gout.data_ptr(), conv.out_dim,
            dS.data_ptr(), dx.data_ptr(), dsh.data_ptr(), dw.data_ptr(),
            dwsel.data_ptr(), ws.data_ptr(), ws.numel(), stream,
        )
    check(err, "uvu_conv_bwd")
    UVUConv.backward_launches += 1
    return dx, dsh, dw, dwsel
