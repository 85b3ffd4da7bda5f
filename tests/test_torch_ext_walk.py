"""The node-major walks of the force path's kernels K4f, K4b and K4g
(``csrc/full_conv_ext.cu``) on the CPU in numpy, over the walk tables of
``ConvTables`` and the edge orders of ``ops/cuda/edge_order.py`` (no JAX):

- the destination-major walk with external radial weights (K4f's scratch,
  K4g's S_sum) and the source-major walk (K4b's dx, dw and dsh; K4g's c_x,
  c_w and c_s), item by item and chunk by chunk as the kernels run them:
  each node's x held as X[m3][m2] = sum_m1 C x from the dense CG that the
  kernel builds out of the cells, each chunk's dsh rows written whole and
  the chunks added in order, the order's tail positions (dropped edges)
  zeroed by the items that own them.  With the node-stage products, they
  reproduce the plain contracts (``plain_forward``, ``plain_backward``,
  ``plain_grad2``) at rel-linf 1e-5 (float32 sums in another order) on the
  four hard edge orders, and dropped edges' per-edge rows are exactly zero;
- one training step of a narrow force model, with the launches routed to
  the plain contracts, builds the edge orders once, and every K4b call of
  the first backward receives them and its layer's K4f scratch (the
  pairing rule's calls, on substituted operands, take none).
"""

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv import mix_rows
from equivariant_nn_zoo_tpu_torch.utils import build, init_parameters
from test_torch_edge_order import KINDS, SHIFTS, TOL, _energy_batch, \
    _graph, _walk
from test_torch_force import route_to_plain
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

F = full_conv_mod.WALK_FIELDS


@pytest.fixture(scope="module")
def conv():
    """A narrow ``grad_order=2`` conv layer (8 channels of l <= 2)."""
    layer = FactorizedConvolution(
        input_features="8x0e+8x0o+8x1e+8x1o+8x2e+8x2o",
        output_features="8x0e+8x0o+24x0e+8x1e+8x1o+8x2e+8x2o",
        node_attrs="4x0e", edge_radial="8x0e",
        edge_spherical="1x0e+1x1o+1x2e", invariant_layers=2,
        invariant_neurons=8, avg_num_neighbors=5.0, grad_order=2)
    init_parameters(layer, torch.Generator().manual_seed(1))
    return layer.full_conv


def _case(fc, kind):
    """Seeded operands and cotangents on one hard edge order."""
    src, dst, N = _graph(kind, seed=4)
    E = len(src)
    g = torch.Generator().manual_seed(5)
    fused = fc.fused
    c = {k: torch.randn(*shape, generator=g) for k, shape in (
        ("x", (N, fused.irreps_in.dim)), ("cx", (N, fused.irreps_in.dim)),
        ("sh", (E, fused.J_dim)), ("csh", (E, fused.J_dim)),
        ("w", (E, fused.weight_numel)), ("cw", (E, fused.weight_numel)),
        ("wsel", (fc.wsel_len,)), ("gout", (N, fc.out_dim)))}
    c.update(src=src, dst=dst, N=N, E=E)
    return c


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


class Walks:
    """The walks of one conv layer on one case, in float64: the per-path,
    per-edge quantities the kernels form (vectorised over the edges), and
    the walks that sum them in the kernels' order."""

    def __init__(self, fc, c):
        self.fc = fc
        self.mul = fc.fused.mul
        self.N, self.E = c["N"], c["E"]
        self.tab = fc.walk_table.numpy().reshape(-1, F).astype(np.int64)
        self.order = edge_order.build(c["src"], c["dst"], self.N)
        self.src, self.dst = c["src"].numpy(), c["dst"].numpy()
        self.kept = (self.src >= 0) & (self.src < self.N) & \
            (self.dst >= 0) & (self.dst < self.N)
        # endpoints clipped: a dropped edge's quantities are formed but
        # never walked
        self.s = np.clip(self.src, 0, self.N - 1)
        self.d = np.clip(self.dst, 0, self.N - 1)
        self.chunk = {}       # the source-major walk's chunk of a path
        for k, (c0, cn) in enumerate(
                fc.walk_src_chunks.numpy().reshape(-1, 2)):
            for p in self.tab[c0: c0 + cn]:
                self.chunk[int(p[6])] = k
        self.np = {k: v.double().numpy() for k, v in c.items()
                   if isinstance(v, torch.Tensor) and v.is_floating_point()}

    def dense_cg(self, p):
        """cd[m3, m1, m2] of one path, from its cells (as the
        source-major walk builds it in shared memory)."""
        fc = self.fc
        cells, nz = fc.walk_cells.numpy(), fc.walk_nz.numpy()
        m2s = nz[:, 1].view(np.int32)
        d1, d3, d2 = p[1], p[3], p[9]
        cd = np.zeros((d3, d1, d2))
        for m3 in range(d3):
            for m1 in range(d1):
                k = p[8] + m3 * d1 + m1
                for z in range(cells[k], cells[k + 1]):
                    cd[m3, m1, m2s[z]] = nz[z, 0]
        return cd

    def path(self, p):
        """Per-edge operands of path p: the CG matrices M(sh) [E, d3, d1]
        (and M(csh)), x[src] [E, mul, d1] (and cx), the weight columns
        [E, mul] (and cw), the dense CG."""
        x_off, d1, j0 = p[:3]
        mul, a = self.mul, self.np
        cd = self.dense_cg(p)
        sl = slice(j0, j0 + cd.shape[2])
        cols = slice(p[6], p[6] + mul)
        xs = slice(x_off, x_off + d1 * mul)
        return dict(
            cd=cd,
            M=np.einsum("abc,ec->eab", cd, a["sh"][:, sl]),
            Mc=np.einsum("abc,ec->eab", cd, a["csh"][:, sl]),
            x=a["x"][self.s, xs].reshape(-1, mul, d1),
            cx=a["cx"][self.s, xs].reshape(-1, mul, d1),
            xn=a["x"][:, xs].reshape(-1, mul, d1),
            cxn=a["cx"][:, xs].reshape(-1, mul, d1),
            w=a["w"][:, cols], cw=a["cw"][:, cols],
            sh=a["sh"][:, sl], csh=a["csh"][:, sl])

    def dst_walk(self, two):
        """The destination-major walk: the scratch S (two: S_sum)."""
        mul = self.mul
        msgs = {}
        for p in self.tab:
            o = self.path(p)
            mid = np.einsum("eab,eub->eau", o["M"], o["x"])
            if two:
                mab = np.einsum("eab,eub->eau", o["M"], o["cx"]) + \
                    np.einsum("eab,eub->eau", o["Mc"], o["x"])
                msgs[p[6]] = o["w"][:, None] * mab + o["cw"][:, None] * mid
            else:
                msgs[p[6]] = o["w"][:, None] * mid

        def body(p, e, acc):
            m = msgs[p[6]][e]
            return m if acc is None else acc + m

        def flush(p, acc, rows, r):
            for m3 in range(p[3]):
                col = (p[4] + m3 * p[5]) * mul
                rows[r, col: col + mul] = 0 if acc is None else acc[m3]

        return _walk(self.fc, self.order.dst_perm, self.order.dst_ptr,
                     self.dst, self.src, self.E, self.N, body, flush,
                     self.fc.KM)

    def node_stage(self):
        """dS = mix^T(gout)."""
        fc, a = self.fc, self.np
        dS = np.zeros((self.N, fc.KM))
        for a_col, kdim, b_off, wo, c_off, cs in fc.prob_rows:
            wq = a["wsel"][b_off: b_off + kdim * wo].reshape(kdim, wo)
            dS[:, a_col: a_col + kdim] += \
                a["gout"][:, c_off + cs * np.arange(wo)] @ wq.T
        return dS

    def mix_weights(self, S):
        """S^T gout per mix matrix (dwsel, c_m)."""
        fc, g = self.fc, self.np["gout"]
        out = np.zeros(fc.wsel_len)
        for a_col, kdim, b_off, wo, c_off, cs in fc.prob_rows:
            out[b_off: b_off + kdim * wo] += (
                S[:, a_col: a_col + kdim].T
                @ g[:, c_off + cs * np.arange(wo)]).reshape(-1)
        return out

    def src_walk(self, dS, two):
        """The source-major walk: dx (c_x), dw (c_w) and dsh (c_s)."""
        fc, mul, N, E = self.fc, self.mul, self.N, self.E
        J, PC = fc.fused.J_dim, fc.fused.weight_numel
        dxc, dwc, dshc = {}, {}, {}
        for p in self.tab:
            o = self.path(p)
            d3, row_base, row_stride = p[3], p[4], p[5]
            idx = (row_base + np.arange(d3)[:, None] * row_stride) * mul + \
                np.arange(mul)
            gm = dS[self.d][:, idx]                           # [E, d3, mul]
            # the node's x as X[m3][m2], once per node, then per edge
            X = np.einsum("abc,nub->nacu", o["cd"], o["xn"])[self.s]
            y = np.einsum("eau,eacu->ecu", gm, X)
            if two:
                CX = np.einsum("abc,nub->nacu", o["cd"], o["cxn"])[self.s]
                yc = np.einsum("eau,eacu->ecu", gm, CX)
                dwc[p[6]] = np.einsum("ec,ecu->eu", o["sh"], yc) + \
                    np.einsum("ec,ecu->eu", o["csh"], y)
                dxc[p[6]] = (
                    np.einsum("eab,eau->ebu", o["Mc"], gm) * o["w"][:, None]
                    + np.einsum("eab,eau->ebu", o["M"], gm)
                    * o["cw"][:, None]).reshape(E, -1)
                dshc[p[6]] = np.einsum("ecu,eu->ec", yc, o["w"]) + \
                    np.einsum("ecu,eu->ec", y, o["cw"])
            else:
                dwc[p[6]] = np.einsum("ec,ecu->eu", o["sh"], y)
                dxc[p[6]] = (np.einsum("eab,eau->ebu", o["M"], gm)
                             * o["w"][:, None]).reshape(E, -1)
                dshc[p[6]] = np.einsum("ecu,eu->ec", y, o["w"])
        dw = np.full((E, PC), np.nan)
        part = np.full((fc.n_src_chunks, E, J), np.nan)

        def body(p, e, acc):
            wcol, j0, d2 = p[6], p[2], p[9]
            dw[e, wcol: wcol + mul] = dwc[wcol][e]
            row = part[self.chunk[wcol], e]
            if np.isnan(row).all():     # the chunk's first path: a whole row
                row[:] = 0.0
            row[j0: j0 + d2] += dshc[wcol][e]
            m = dxc[wcol][e]
            return m if acc is None else acc + m

        def flush(p, acc, rows, r):
            rows[r, p[7]: p[7] + p[1] * mul] = 0 if acc is None else acc

        dxp = _walk(fc, self.order.src_perm, self.order.src_ptr, self.src,
                    self.dst, E, N, body, flush, fc.KMd, fc.walk_src_chunks)
        # the order's tail positions: each item zeroes those it owns
        cap, T = full_conv_mod.walk_items(E, fc.n_chunks)
        perm = self.order.src_perm.numpy()
        end = int(self.order.src_ptr[N])
        for t in range(T):
            for pos in range(max(t * cap, end), min(t * cap + cap, E)):
                dw[perm[pos]] = 0.0
                part[:, perm[pos]] = 0.0
        assert not np.isnan(dw).any() and not np.isnan(part).any()
        dx = np.zeros((N, fc.fused.irreps_in.dim))
        for x_off, d1, dcol, n_paths in fc.walk_irreps.numpy().reshape(-1, 4):
            width = d1 * mul
            s = sum(dxp[:, dcol + k * width: dcol + (k + 1) * width]
                    for k in range(n_paths))
            dx[:, x_off: x_off + width] = s.reshape(N, d1, mul).transpose(
                0, 2, 1).reshape(N, width)
        dsh = part[0].copy()
        for k in range(1, fc.n_src_chunks):  # the chunks in order
            dsh += part[k]
        return dx, dsh, dw


def _kept_args(c, w):
    keep = torch.as_tensor(w.kept)
    return {"x": c["x"], "cx": c["cx"], "sh": c["sh"][keep],
            "csh": c["csh"][keep], "w": c["w"][keep], "cw": c["cw"][keep],
            "wsel": c["wsel"], "src": c["src"][keep], "dst": c["dst"][keep],
            "N": c["N"], "gout": c["gout"]}


def _check(got, want, kept, per_edge, names):
    for name, a, b in zip(names, got, want):
        if name in per_edge:   # dropped edges' rows are exactly zero
            assert not np.abs(a[~kept]).any(), name
            a = a[kept]
        assert _rel(a, b.numpy()) <= TOL, (name, _rel(a, b.numpy()))


@pytest.mark.parametrize("kind", KINDS)
def test_dst_walk_reproduces_k4f(conv, kind):
    c = _case(conv, kind)
    walks = Walks(conv, c)
    S = walks.dst_walk(two=False)
    k = _kept_args(c, walks)
    out, scratch = conv.plain_core(k["x"], k["sh"], k["w"], k["wsel"],
                                   k["src"], k["dst"], k["N"])
    assert _rel(S, scratch.detach().numpy()) <= TOL
    got = mix_rows(torch.as_tensor(S), c["wsel"].double(), conv.prob_rows,
                   conv.out_dim)
    assert _rel(got.numpy(), out.detach().numpy()) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_walks_reproduce_k4b(conv, kind):
    """K4b: dwsel on the scratch of the destination-major walk (the saved
    scratch and the recomputed one are the same walk), dx, dsh and dw from
    the source-major walk."""
    c = _case(conv, kind)
    walks = Walks(conv, c)
    S = walks.dst_walk(two=False)
    dx, dsh, dw = walks.src_walk(walks.node_stage(), two=False)
    k = _kept_args(c, walks)
    want = conv.plain_backward(k["x"], k["sh"], k["w"], k["wsel"], k["src"],
                               k["dst"], k["N"], k["gout"])
    _check((dx, dsh, dw, walks.mix_weights(S)), want, walks.kept,
           ("dsh", "dw"), ("dx", "dsh", "dw", "dwsel"))


@pytest.mark.parametrize("kind", KINDS)
def test_walks_reproduce_k4g(conv, kind):
    """K4g: S_sum from the destination-major walk with two operands, c_g
    and c_m from it; c_x, c_s and c_w from the source-major walk."""
    c = _case(conv, kind)
    walks = Walks(conv, c)
    S = walks.dst_walk(two=True)
    c_x, c_s, c_w = walks.src_walk(walks.node_stage(), two=True)
    c_g = mix_rows(torch.as_tensor(S), c["wsel"].double(), conv.prob_rows,
                   conv.out_dim).numpy()
    k = _kept_args(c, walks)
    want = conv.plain_grad2(k["x"], k["cx"], k["sh"], k["csh"], k["w"],
                            k["cw"], k["wsel"], k["src"], k["dst"], k["N"],
                            k["gout"])
    _check((c_x, c_s, c_w, walks.mix_weights(S), c_g), want, walks.kept,
           ("c_s", "c_w"), ("c_x", "c_s", "c_w", "c_m", "c_g"))


def test_force_step_builds_one_order_and_saves_the_scratch(monkeypatch):
    """A narrow 3-layer force model's training step (energy and force
    loss, differentiated twice), with the launches routed to the plain
    contracts: one edge order for the step; every launch walks it; the
    first backward's K4b calls (forces, then the energy term) take their
    layer's K4f scratch; the pairing rule's take none."""
    layers = 3
    model = build(tlc.addForceOutput(tlc.addEnergyOutput(tlc.featureModel(
        n_dim=8, l_max=2, node_attrs="4x0e", edge_radial="4x0e",
        num_types=10, num_layers=layers, r_max=3.0), SHIFTS,
        output_key="energy")))
    init_parameters(model, torch.Generator().manual_seed(0))
    gb = _energy_batch()
    seen = {}
    calls = route_to_plain(monkeypatch, seen)
    builds = edge_order.builds
    out = model(gb)
    (out["energy"].sum() + (out["forces"] ** 2).sum()).backward()
    assert edge_order.builds == builds + 1
    assert calls == {"fwd": layers + 2, "bwd": 2 * layers + 2,
                     "grad2": layers - 1}
    ei = gb["edge_index"]
    want = edge_order.build(ei[0], ei[1], gb.node_capacity)
    order = seen["fwd"][0][0]["order"]
    assert all(torch.equal(a, b) for a, b in zip(order, want))
    for kind in ("fwd", "bwd", "grad2"):
        for kw, _ in seen[kind]:
            assert all(a is b for a, b in zip(kw["order"], order)), kind
    primal = [res[1] for _, res in seen["fwd"][:layers]]
    saved = [kw["scratch"] for kw, _ in seen["bwd"]
             if kw.get("scratch") is not None]
    assert len(saved) == 2 * layers
    assert all(any(s.data_ptr() == p.data_ptr() for p in primal)
               for s in saved)
    assert sum(kw.get("scratch") is None for kw, _ in seen["bwd"]) == 2
