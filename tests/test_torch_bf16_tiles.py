"""The tile tables of the bfloat16 K1 and K2 walks (CPU, no JAX).

``FullConv._bf16_walk_tables`` cuts the rounded CG coefficients into the
B operands of ``mma.sync m16n8k16`` tiles, one set per left irrep (a
block's unit), stored as the 32 lanes' fragments.  An emulation of the
kernels' tiled contractions in float64 (``tile_matrix`` reads each tile
back from the fragments the kernel loads) is held to the plain contract's
einsums before their rounding, at 1e-12 of the largest value:

- the forward product ``mid = O C`` (``_mid_bf16``: the outer products
  ``O[j, i] = bf16(sh_j x_i)`` contracted with the rounded CG), every
  (path, m3) row of the expansion read from exactly one column of one
  unit;
- the backward product ``douter = dmid C^T`` (``plain_backward_bf16``:
  summed over every path of a sh irrep's section, one value per (j, m1)),
  zero where no path of the unit reads j.

At a narrow width (8 channels) for ``config_energy``'s and
``config_dipole``'s hot layers (``layer3``), for ``config_energy_force``'s
(``grad_order=2``: ``FullConvExt``, whose K4f, K4b and K4g walk the same
tiles; K4g's three CG products and two C^T products are these two
contractions on other operands), and at l = 4 with sh irreps up to l = 3
(two m1 blocks of 8, eight j pairs).
"""

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.nn.message_passing import \
    FactorizedConvolution
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv import (
    BF16,
    BF16_UNIT_FIELDS,
    round_bf16,
)
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-12


def row_tiles(mask, base, n):
    """The tile of each of the n columns of a (mask, base) map row, or -1:
    base + the set bits of mask below the column, as the kernels count."""
    return [base + bin(mask & ((1 << c) - 1)).count("1")
            if mask >> c & 1 else -1 for c in range(n)]


def tile_matrix(frag):
    """The [16, 8] B operand of a tile from its 32 lanes' fragments (64
    int32 words): lane (g, t) = divmod(lane, 4) holds B[2t, g] | B[2t + 1,
    g] << 16, then B[2t + 8, g] | B[2t + 9, g] << 16, as bfloat16 bits."""
    words = np.asarray(frag, np.int32).reshape(32, 2).view(np.uint16)
    vals = torch.tensor(words.astype(np.int16)).view(BF16).float().numpy()
    b = np.zeros((16, 8), np.float32)
    g, t = np.divmod(np.arange(32), 4)
    for i, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
        b[k, g] = vals.reshape(32, 4)[:, i]
    return b


def _features(mul, l_max, parities="eo"):
    return "+".join(f"{mul}x{l}{p}" for l in range(l_max + 1)
                    for p in parities)


LAYERS = {   # features, sh irreps, grad_order
    "energy": (_features(8, 3), "1x0e+1x1o+1x2e", 1),
    "dipole": (_features(8, 2), "1x0e+1x1o+1x2e", 1),
    "force": (_features(8, 2), "1x0e+1x1o+1x2e", 2),
    "l4": (_features(8, 4), "1x0e+1x1o+1x2e+1x3o", 1),
}


@pytest.fixture(scope="module", params=sorted(LAYERS))
def conv(request):
    feats, sh, grad_order = LAYERS[request.param]
    c = FactorizedConvolution(
        input_features=feats, output_features=feats, node_attrs="4x0e",
        edge_radial="8x0e", edge_spherical=sh, invariant_layers=2,
        invariant_neurons=16, avg_num_neighbors=5.0, sc_species_types=5,
        grad_order=grad_order, compute_dtype="bfloat16")
    assert (type(c.full_conv).__name__ == "FullConvExt") == (grad_order == 2)
    return c.full_conv


def _units(fc):
    """Each unit's header, columns [NT * 8, 2], slots [P, 3], forward map
    [KS, NT], backward map [J * MB, NT / 2] (tile indices or -1, read from
    the (mask, base) rows as the kernels read them) and tiles as [16, 8]
    matrices."""
    tab = fc.bf16_walk_tab.numpy()
    tiles = fc.bf16_walk_tiles.numpy()
    J = fc.fused.J_dim
    out = []
    for u in range(int(fc.bf16_walk_dims[0])):
        r = tab[tab[u]:]
        (x_off, d1, MB, P, N, NT, KS, ints, tile0, n_tiles, col0, slot0,
         fmap0, bmap0) = (int(v) for v in r[:14])
        assert col0 >= BF16_UNIT_FIELDS and ints % 4 == 0
        assert fmap0 % 2 == 0 and bmap0 % 2 == 0    # read as int2
        fmap = r[fmap0: fmap0 + 2 * KS].reshape(-1, 2)
        bmap = r[bmap0: bmap0 + 2 * J * MB].reshape(-1, 2)
        tiled = sorted(ti for m, n in ((fmap, NT), (bmap, NT // 2))
                       for mask, base in m for ti in row_tiles(mask, base, n)
                       if ti >= 0)
        assert tiled == list(range(n_tiles))    # each tile named once
        out.append(dict(
            x_off=x_off, d1=d1, MB=MB, N=N, NT=NT, KS=KS,
            cols=r[col0: col0 + 16 * NT].reshape(-1, 2),
            slots=r[slot0: slot0 + 3 * P].reshape(-1, 3),
            fmap=np.asarray([row_tiles(*row, NT) for row in fmap]),
            bmap=np.asarray([row_tiles(*row, NT // 2) for row in bmap]),
            tiles=[tile_matrix(tiles[tile0 + i]).astype(np.float64)
                   for i in range(n_tiles)]))
    return out


def _k_of_srow(fc):
    return {int(s): k for k, s in enumerate(fc.bf16_srow.tolist())}


def _operands(fc, E, seed):
    """Rounded x [N, I, mul] and sh [E, J] of random edges, and the outer
    products O [E, J, I, mul] (rounded), all float64."""
    g = torch.Generator().manual_seed(seed)
    mul, J, I = fc.fused.mul, fc.fused.J_dim, fc.fused.I_dim
    xT = round_bf16(torch.randn(5, I, mul, generator=g))
    sh = round_bf16(torch.randn(E, J, generator=g))
    src = torch.randint(0, 5, (E,), generator=g)
    outer = round_bf16(sh[:, :, None, None] * xT[src][:, None])
    return xT.double(), sh.double(), src, outer.double()


def test_units_cover_every_row_once(conv):
    """Every (path, m3) row of the expansion is one column of one unit,
    the columns of a slot are its d3 consecutive ones, and every tile a
    map names has a non-zero coefficient."""
    k_of = _k_of_srow(conv)
    seen = []
    for unit in _units(conv):
        live = unit["cols"][:unit["N"]]
        assert (unit["cols"][unit["N"]:, 0] == -1).all()
        seen += [k_of[int(s)] for s in live[:, 0]]
        for s, (wcol, c0, d3) in enumerate(unit["slots"]):
            assert (live[c0: c0 + d3, 1] == s).all()
            assert wcol % conv.fused.mul == 0
        for m in (unit["fmap"], unit["bmap"]):
            for ti in m[m >= 0]:
                assert np.abs(unit["tiles"][ti]).max() > 0
    assert sorted(seen) == list(range(conv.fused.K_dim))


def test_forward_tiles_give_the_plain_mid(conv):
    """The tiled ``O C`` of every unit in float64 equals ``_mid_bf16``'s
    einsum before its rounding."""
    E, mul, J = 11, conv.fused.mul, conv.fused.J_dim
    _, _, _, outer = _operands(conv, E, seed=5)
    want = torch.einsum("jki,ejiu->eku", conv.bf16_C.double(), outer)
    k_of = _k_of_srow(conv)
    scale = float(want.abs().max())
    for unit in _units(conv):
        d1, MB, i0 = unit["d1"], unit["MB"], unit["x_off"] // mul
        # A [k-step][E * mul, 16]: column c = (j = 2 jp + c // 8, m1 = 8 mb
        # + c % 8), zero past J and d1
        blk = torch.zeros(E, 2 * (-(-J // 2)), 8 * MB, mul,
                          dtype=torch.float64)
        blk[:, :J, :d1] = outer[:, :, i0: i0 + d1]
        A = [blk[:, 2 * jp: 2 * jp + 2, 8 * mb: 8 * mb + 8]
             .permute(0, 3, 1, 2).reshape(E * mul, 16)
             for jp in range(-(-J // 2)) for mb in range(MB)]
        assert len(A) == unit["KS"]
        for nt in range(unit["NT"]):
            acc = torch.zeros(E * mul, 8, dtype=torch.float64)
            for ks in range(unit["KS"]):
                ti = unit["fmap"][ks, nt]
                if ti >= 0:
                    acc += A[ks] @ torch.tensor(unit["tiles"][ti])
            for n in range(8):
                srow = int(unit["cols"][8 * nt + n, 0])
                got = acc[:, n].reshape(E, mul)
                if srow < 0:
                    assert not got.any()
                    continue
                err = float((got - want[:, k_of[srow]]).abs().max())
                assert err <= TOL * scale, (nt, n, err)


def test_backward_tiles_give_the_plain_douter(conv):
    """The tiled ``dmid C^T`` of every unit in float64 equals
    ``plain_backward_bf16``'s einsum before its rounding: per (j, m1) the
    sum over every path of the unit's left irrep whose sh section holds
    j."""
    E, mul, J = 9, conv.fused.mul, conv.fused.J_dim
    K = conv.fused.K_dim
    g = torch.Generator().manual_seed(6)
    dmid = round_bf16(torch.randn(E, K, mul, generator=g)).double()
    want = torch.einsum("jki,eku->ejiu", conv.bf16_C.double(), dmid)
    k_of = _k_of_srow(conv)
    scale = float(want.abs().max())
    for unit in _units(conv):
        d1, MB, i0, NT = unit["d1"], unit["MB"], unit["x_off"] // mul, \
            unit["NT"]
        # A' [E * mul, NT * 8]: column c the unit's column c
        Ap = torch.zeros(E, 8 * NT, mul, dtype=torch.float64)
        for c, (srow, _) in enumerate(unit["cols"]):
            if srow >= 0:
                Ap[:, c] = dmid[:, k_of[int(srow)]]
        Ap = Ap.permute(0, 2, 1).reshape(E * mul, 8 * NT)
        for j in range(J):
            for mb in range(MB):
                acc = torch.zeros(E * mul, 8, dtype=torch.float64)
                for kk in range(NT // 2):
                    ti = unit["bmap"][j * MB + mb, kk]
                    if ti >= 0:
                        acc += Ap[:, 16 * kk: 16 * kk + 16] @ torch.tensor(
                            unit["tiles"][ti])
                for n in range(8):
                    m1 = 8 * mb + n
                    got = acc[:, n].reshape(E, mul)
                    if m1 >= d1:
                        assert not got.any()
                        continue
                    err = float((got - want[:, j, i0 + m1]).abs().max())
                    assert err <= TOL * scale, (j, m1, err)
