"""K6: the per-edge uvu tensor-product convolution without the edge sum,
around ``csrc/uvu_conv.cu``.

The kernel replaces the TPU kernel ``PallasUVUConv._fwd_kernel``
(``equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py:233``), whose live use is
the neighbor conv of the hamiltonian head (``Pairwise``, ``reduce=False``):

    out[e] = Mix_wsel( w_e (.) CG(x[src_e] (x) sh_e) )        [E, out_dim]

with per-edge radial weights ``w [E, P * mul]`` from the caller's MLP
(columns in the expansion's instruction order) and the flat mix matrices
``wsel`` (the mix ``Linear``'s alphas folded in, ``ConvTables.flat_wsel``).
Row and table conventions are K1's (``ConvTables``); the gather of
``x[src]`` is an indexed load inside the kernel.

For tensors on the CPU the wrapper runs the plain version
(``FusedUVUConv`` with ``reduce=False``) and autograd differentiates it.
For CUDA tensors it launches the kernel or raises.  The kernel is
forward-only: a CUDA call under grad mode with an input or parameter that
needs a gradient raises instead of returning a detached tensor.
``plain_forward`` is the plain PyTorch version of the kernel's contract on
the flat mix matrices, for the tests and the on-card checks.
"""

from __future__ import annotations

import torch

from .build import check, check_tensor, load_library
from .full_conv import MAX_SH, ConvTables


class UVUConv(ConvTables):
    """K6 for one ``FactorizedConvolution`` built with ``reduce=False``; the
    expansion's mix ``Linear`` is passed at call time, the radial weights
    come from the caller's MLP."""

    #: kernel launches, over all instances (the main path's proof of use)
    launches = 0

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
        K6."""
        wsel = self.flat_wsel(linear)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, sh, w, wsel)):
            raise NotImplementedError(
                "UVUConv: the per-edge conv kernel has no backward yet; call "
                "it under torch.no_grad() or on the CPU")
        return launch_forward(self, x.contiguous(), sh.contiguous(),
                              w.contiguous(), wsel, edge_src)

    def plain_forward(self, x, sh, w, wsel, edge_src):
        """Plain PyTorch version of K6's contract: ``out [E, out_dim]``
        (the conv core with every edge its own destination)."""
        E = sh.shape[0]
        rows = torch.arange(E, device=x.device)
        return self.plain_core(x, sh, w, wsel, edge_src, rows, E)[0]


def launch_forward(conv, x, sh, w, wsel, edge_src):
    """Launch K6: ``out [E, out_dim]``."""
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
            wsel.data_ptr(), conv.prob_table.data_ptr(), conv.n_probs,
            conv.max_wo, out.data_ptr(), conv.out_dim,
            int(not conv.covers_output), stream,
        )
    check(err, "uvu_conv_fwd")
    UVUConv.launches += 1
    return out
