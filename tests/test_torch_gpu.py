"""On-card checks of the port's CUDA kernels against their plain PyTorch
versions, at full ``config_energy`` width: K1 and K3 forward, K2 and K3b
backward, and a whole training step's gradients against the CPU plain path;
and for the force path (``config_energy_force``): K4f, K4b and K4g against
their plain contracts, the routes of the second backward, and forces and a
training step's gradients against the CPU plain path; and for the
hamiltonian path (``config_hamiltonian``): K5 and K6 against their plain
versions, their backward kernels (K5m, K5a, K5b; K6b) per output against the
plain backward and, through the autograd Functions, against the CPU, K1, K2,
K3 and K3b at the trunk's l = 4 layer, the full-width forward and a training
step's gradients against the CPU plain path.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card every test
skips (the decision is taken inside the fixture, never at import).
TF32 is off, so the plain versions compute in float32; the kernels sum in
another order (the mix GEMM of ``csrc/row_mix.cuh`` in 3xTF32 on the tensor
cores), some with atomics in a varying order, so agreement is rel-linf
1e-4 of max|plain|.  The mix GEMM (forward mix, dS, dwsel and the radial
MLP's products) is also checked on its own at ragged shapes, and the
outputs it makes repeatable are checked to repeat bit for bit.
"""

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.models.config_energy import SHIFTS
from equivariant_nn_zoo_tpu_torch.ops.cuda import FullConv, SpeciesScalarFCTP
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.run import Loss

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _molecules(n_mol, seed=0):
    """QM9-like molecules with ``total_energy`` labels (per-species shifts
    plus unit noise)."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        d["atom_types"] = d["species"]
        d["total_energy"] = np.asarray(
            [[sum(SHIFTS[int(t)] for t in d["species"][:, 0])
              + rng.normal()]])
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e"),
                 "total_energy": ("graph", "1x0e")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return mols


def _batch(mols, device, extra_edges=64):
    host = Batch.from_data_list(mols)
    return GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                                 int(host["_n_edges"].sum()) + extra_edges,
                                 len(mols), device)


@pytest.fixture(scope="module")
def model_and_batch(cuda):
    model = build_model(get_config("config_energy")["model_config"], cuda,
                        torch.Generator().manual_seed(0))
    return model, _batch(_molecules(16), cuda)


def _layer3_inputs(model, gb):
    """The data dict as it reaches layer3's convolution."""
    seen = {}
    hook = model.layer3.conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.no_grad():
        model(gb)
    hook.remove()
    return seen["data"]


def _k2_case(conv, x, er, sh, src, dst, N, pre, seed):
    """K1's forward (for its scratch) and a seeded cotangent: the inputs
    of K2 and of its plain version."""
    fc = conv.full_conv
    w = fc.flat_weights(conv.fc, conv.tp.linear, pre)
    with torch.no_grad():
        _, scratch = full_conv_mod.launch_forward(fc, x, er, sh, src, dst,
                                                  *w, N)
    gout = torch.randn(N, fc.out_dim, generator=torch.Generator().manual_seed(
        seed)).to(x.device)
    return (x, er, sh, src, dst, *(t.detach() for t in w), N, scratch, gout)


def _k3b_case(conv, x, attrs, species, seed):
    sc = conv.species_sc
    with torch.no_grad():
        tables = sc.tables(conv.sc, attrs, species.reshape(-1))
    g = torch.randn(x.shape[0], sc.irreps_out.dim,
                    generator=torch.Generator().manual_seed(seed)).to(
        x.device)
    return (x, species.reshape(-1), tables, g)


def _assert_all_close(got, want, names):
    for name, a, b in zip(names, got, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


def _rel(a, b):
    """max|a - b| / max|b|; an all-zero ``b`` (a structurally zero
    gradient) requires an all-zero ``a``."""
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / scale


K2_OUT = ("dx", "d edge_radial", "dw_hidden", "dw_out", "dwsel")


def test_full_conv_kernel_matches_plain(model_and_batch):
    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    with torch.inference_mode():
        x = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
        args = (conv.fc, conv.tp.linear, x, er, data["edge_spherical"],
                data["edge_index"][0], data["edge_index"][1], x.shape[0],
                0.1 ** 0.5)
        before = FullConv.launches
        got = conv.full_conv.launch(*args)
        want = conv.full_conv.plain(*args)
        torch.cuda.synchronize()
    assert FullConv.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL


def test_species_sc_kernel_matches_plain(model_and_batch):
    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    with torch.inference_mode():
        args = (conv.sc, data["input_features"], data["node_attrs"],
                data["species"])
        before = SpeciesScalarFCTP.launches
        got = conv.species_sc.launch(*args)
        want = conv.species_sc.plain(*args)
        torch.cuda.synchronize()
    assert SpeciesScalarFCTP.launches == before + 1
    assert _rel(got, want) <= TOL


def test_model_forward_matches_cpu(model_and_batch):
    model, gb = model_and_batch
    cpu = build_model(get_config("config_energy")["model_config"], "cpu",
                      torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = model(gb)["total_energy"].cpu()
        want = cpu(gb.to("cpu"))["total_energy"]
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL


def _small_conv(cuda, n_dim, grad_order=1):
    from equivariant_nn_zoo_tpu_torch.nn.message_passing import (
        FactorizedConvolution,
    )
    from equivariant_nn_zoo_tpu_torch.utils import init_parameters

    feats = "+".join(f"{n_dim}x{l}{p}" for l in range(3) for p in "eo")
    conv = FactorizedConvolution(
        input_features=feats,
        output_features=f"{n_dim}x0e+{n_dim}x0o+{3 * n_dim}x0e+"
        f"{n_dim}x1e+{n_dim}x1o+{n_dim}x2e+{n_dim}x2o",
        node_attrs="4x0e", edge_radial="8x0e",
        edge_spherical="1x0e+1x1o+1x2e", invariant_layers=2,
        invariant_neurons=n_dim, avg_num_neighbors=5.0,
        sc_species_types=5, grad_order=grad_order)
    init_parameters(conv, torch.Generator().manual_seed(1))
    return conv.to(cuda)


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (32, 130, 4099)])
def test_kernels_match_plain_at_other_widths(cuda, n_dim, N, E):
    """Narrow multiplicities, edge and node counts off every tile size,
    and a mix group feeding two output slots (0e -> two 0e blocks)."""
    conv = _small_conv(cuda, n_dim)
    g = torch.Generator().manual_seed(2)
    in_dim = conv.full_conv.fused.irreps_in.dim
    x = torch.randn(N, in_dim, generator=g).to(cuda)
    sh = torch.randn(E, 9, generator=g).to(cuda)
    er = torch.randn(E, 8, generator=g).to(cuda)
    src = torch.randint(0, N, (E,), generator=g).to(cuda)
    dst = torch.randint(0, N, (E,), generator=g).to(cuda)
    table = torch.randn(5, 4, generator=g)
    species = torch.randint(0, 5, (N,), generator=g)
    attrs = table[species].to(cuda)
    species = species.to(cuda)
    with torch.inference_mode():
        k1 = (conv.fc, conv.tp.linear, x, er, sh, src, dst, N, 0.3)
        got1 = conv.full_conv.launch(*k1)
        want1 = conv.full_conv.plain(*k1)
        k3 = (conv.sc, x, attrs, species)
        got3 = conv.species_sc.launch(*k3)
        want3 = conv.species_sc.plain(*k3)
        torch.cuda.synchronize()
    assert _rel(got1, want1) <= TOL
    assert _rel(got3, want3) <= TOL


def test_full_conv_kernel_skips_out_of_range_edges(cuda):
    """Edges with an endpoint outside [0, N) are dropped, as a segment sum
    drops out-of-range ids, instead of writing out of bounds."""
    conv = _small_conv(cuda, 8)
    N, E = 20, 300
    g = torch.Generator().manual_seed(3)
    in_dim = conv.full_conv.fused.irreps_in.dim
    x = torch.randn(N, in_dim, generator=g).to(cuda)
    sh = torch.randn(E, 9, generator=g).to(cuda)
    er = torch.randn(E, 8, generator=g).to(cuda)
    src = torch.randint(0, N, (E,), generator=g)
    dst = torch.randint(0, N, (E,), generator=g)
    bad_src, bad_dst = src.clone(), dst.clone()
    bad_src[::7] = N + 5
    bad_dst[3::11] = -1
    keep = (bad_src < N) & (bad_dst >= 0)
    with torch.inference_mode():
        got = conv.full_conv.launch(
            conv.fc, conv.tp.linear, x, er, sh, bad_src.to(cuda),
            bad_dst.to(cuda), N, 0.3)
        want = conv.full_conv.plain(
            conv.fc, conv.tp.linear, x, er[keep.to(cuda)], sh[keep.to(cuda)],
            src[keep].to(cuda), dst[keep].to(cuda), N, 0.3)
        torch.cuda.synchronize()
    assert _rel(got, want) <= TOL


def test_full_conv_backward_kernel_matches_plain(model_and_batch):
    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    with torch.no_grad():
        x = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    args = _k2_case(conv, x, er, data["edge_spherical"],
                    data["edge_index"][0], data["edge_index"][1],
                    x.shape[0], 0.1 ** 0.5, seed=4)
    before = FullConv.backward_launches
    got = full_conv_mod.launch_backward(conv.full_conv, *args)
    want = conv.full_conv.plain_backward(*args)
    torch.cuda.synchronize()
    assert FullConv.backward_launches == before + 1
    _assert_all_close(got, want, K2_OUT)


def test_species_sc_backward_kernel_matches_plain(model_and_batch):
    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    args = _k3b_case(conv, data["input_features"], data["node_attrs"],
                     data["species"], seed=5)
    before = SpeciesScalarFCTP.backward_launches
    got = species_sc_mod.launch_backward(conv.species_sc, *args)
    want = conv.species_sc.plain_backward(*args)
    torch.cuda.synchronize()
    assert SpeciesScalarFCTP.backward_launches == before + 1
    _assert_all_close(got, want, ("dx", "dtables"))


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (32, 130, 4099)])
def test_backward_kernels_match_plain_at_other_widths(cuda, n_dim, N, E):
    conv = _small_conv(cuda, n_dim)
    g = torch.Generator().manual_seed(6)
    in_dim = conv.full_conv.fused.irreps_in.dim
    x = torch.randn(N, in_dim, generator=g).to(cuda)
    sh = torch.randn(E, 9, generator=g).to(cuda)
    er = torch.randn(E, 8, generator=g).to(cuda)
    src = torch.randint(0, N, (E,), generator=g).to(cuda)
    dst = torch.randint(0, N, (E,), generator=g).to(cuda)
    table = torch.randn(5, 4, generator=g)
    species = torch.randint(0, 4, (N,), generator=g)  # type 4 absent
    args = _k2_case(conv, x, er, sh, src, dst, N, 0.3, seed=7)
    got = full_conv_mod.launch_backward(conv.full_conv, *args)
    want = conv.full_conv.plain_backward(*args)
    _assert_all_close(got, want, K2_OUT)
    args = _k3b_case(conv, x, table[species].to(cuda), species.to(cuda),
                     seed=8)
    got = species_sc_mod.launch_backward(conv.species_sc, *args)
    want = conv.species_sc.plain_backward(*args)
    torch.cuda.synchronize()
    _assert_all_close(got, want, ("dx", "dtables"))


def _edges(kind, N, E, g):
    """Edges of one hard case for the node-major walk (K1, K2), shuffled:
    ``padded`` sends 2,000 more edges to the dummy node N - 1, ``hub``
    gives node 5 a run of 1,500 edges each way, ``out_of_range`` points
    some endpoints outside [0, N)."""
    src = torch.randint(0, N - 1, (E,), generator=g)
    dst = torch.randint(0, N - 1, (E,), generator=g)
    if kind == "padded":
        src = torch.cat([src, torch.full((2000,), N - 1)])
        dst = torch.cat([dst, torch.full((2000,), N - 1)])
    elif kind == "hub":
        src = torch.cat([src, torch.full((1500,), 5),
                         torch.randint(0, N, (1500,), generator=g)])
        dst = torch.cat([dst, torch.randint(0, N, (1500,), generator=g),
                         torch.full((1500,), 5)])
    elif kind == "out_of_range":
        src[::7] = N + 5
        dst[3::11] = -1
    perm = torch.randperm(src.shape[0], generator=g)
    return src[perm], dst[perm]


@pytest.mark.parametrize("kind", ["shuffled", "padded", "hub",
                                  "out_of_range"])
def test_walk_kernels_match_plain_on_hard_edge_orders(model_and_batch, kind):
    """K1 and K2 at full config_energy width (layer3) on shuffled edges,
    a long run at the dummy node, a hub, and out-of-range endpoints
    (dropped: compared with the plain versions on the kept edges; their
    d edge_radial is zero).  K1's output and scratch and K2's dx are also
    bitwise equal over two launches: every sum of the walk, the long runs'
    pieces included, runs in a fixed order."""
    model, _ = model_and_batch
    conv = model.layer3.conv
    fc = conv.full_conv
    N, g = 211, torch.Generator().manual_seed(30)
    src, dst = _edges(kind, N, 3001, g)
    E = src.shape[0]
    dev = next(conv.parameters()).device
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g).to(dev)
    sh = torch.randn(E, fc.fused.J_dim, generator=g).to(dev)
    er = torch.randn(E, fc.fc_dims[0], generator=g).to(dev)
    keep = ((src >= 0) & (src < N) & (dst >= 0) & (dst < N)).to(dev)
    src, dst = src.to(dev), dst.to(dev)
    args = _k2_case(conv, x, er, sh, src, dst, N, 0.3, seed=31)
    kept = _k2_case(conv, x, er[keep], sh[keep], src[keep], dst[keep], N,
                    0.3, seed=31)
    w = args[5:8]
    with torch.no_grad():
        out1, s1 = full_conv_mod.launch_forward(fc, *args[:5], *w, N)
        out2, s2 = full_conv_mod.launch_forward(fc, *args[:5], *w, N)
        want_out, want_s = fc.plain_forward(*kept[:5], *w, N)
    got = full_conv_mod.launch_backward(fc, *args)
    again = full_conv_mod.launch_backward(fc, *args)
    want = fc.plain_backward(*kept)
    torch.cuda.synchronize()
    assert _rel(out1, want_out) <= TOL and _rel(s1, want_s) <= TOL
    assert torch.equal(out1, out2) and torch.equal(s1, s2)
    assert torch.equal(got[0], again[0])
    assert not got[1][~keep].any()
    _assert_all_close((got[0], got[1][keep], *got[2:]), want, K2_OUT)


def _step_gradients(model, gb):
    model.zero_grad()
    out = model(gb)
    loss, _ = Loss({"total_energy": [1e3, "MSELoss"]})(out.data, gb.data)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in
                         model.named_parameters()}


def test_train_step_gradients_match_cpu(model_and_batch):
    """One training step's gradient of every parameter, through K1/K2 and
    K3/K3b on the card, against the plain path on the CPU."""
    model, gb = model_and_batch
    cpu = build_model(get_config("config_energy")["model_config"], "cpu",
                      torch.Generator().manual_seed(0))
    # labels N(0, 1): against the shifted labels the float32 residual keeps
    # ~3 digits (totals ~1e4), and the gradient would differ at ~1e-3
    # between any two summation orders
    gb = gb.replace(total_energy=torch.randn(
        gb.n_graphs, 1, generator=torch.Generator().manual_seed(9)).to(
        gb["total_energy"].device))
    before = (FullConv.backward_launches, SpeciesScalarFCTP.backward_launches)
    loss, got = _step_gradients(model, gb)
    torch.cuda.synchronize()
    n_layers = get_config("config_energy")["model_config"]["num_layers"]
    assert FullConv.backward_launches - before[0] == n_layers
    assert SpeciesScalarFCTP.backward_launches - before[1] == n_layers
    want_loss, want = _step_gradients(cpu, gb.to("cpu"))
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert set(got) == set(want)
    for name in want:
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name], want[name]) <= TOL, (name, _rel(got[name],
                                                               want[name]))


def test_kernel_outputs_carry_autograd(model_and_batch):
    """On the card the conv and self-connection outputs are attached to
    autograd, and an sh that needs a gradient is refused."""
    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    x = data["input_features"].detach().requires_grad_(True)
    out = conv.species_sc(conv.sc, x, data["node_attrs"], data["species"])
    assert out.grad_fn is not None
    x1 = conv.linear_1(x)
    er = data["edge_radial"] * data["_edge_mask"]
    args = (conv.fc, conv.tp.linear, x1, er, data["edge_spherical"],
            data["edge_index"][0], data["edge_index"][1], x1.shape[0], 0.3)
    assert conv.full_conv(*args).grad_fn is not None
    sh = data["edge_spherical"].detach().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="sh cotangent"):
        conv.full_conv(*args[:4], sh, *args[5:])


# ------------------------------------------------------------- force path

EXT_OUT = {"K4f": ("out",), "K4b": ("dx", "dsh", "dw", "dwsel"),
           "K4g": ("c_x", "c_s", "c_w", "c_m", "c_g")}


def _ext_case(conv, cuda, N, E, seed, pad=40):
    """Seeded operands and cotangents of the three K4 kernels, with padded
    edges (src = dst = the last node, unit sh, zero weights) at the end."""
    g = torch.Generator().manual_seed(seed)
    fused = conv.full_conv.fused

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    x, cx = rnd(N, fused.irreps_in.dim), rnd(N, fused.irreps_in.dim)
    sh, csh = rnd(E + pad, fused.J_dim), rnd(E + pad, fused.J_dim)
    w, cw = rnd(E + pad, fused.weight_numel), rnd(E + pad, fused.weight_numel)
    sh[E:] = 0.0
    sh[E:, 0] = 1.0
    w[E:] = 0.0
    src = torch.cat([torch.randint(0, N - 1, (E,), generator=g),
                     torch.full((pad,), N - 1)]).to(cuda)
    dst = torch.cat([torch.randint(0, N - 1, (E,), generator=g),
                     torch.full((pad,), N - 1)]).to(cuda)
    wsel = conv.full_conv.flat_wsel(conv.tp.linear, 0.3).detach()
    gout = rnd(N, conv.full_conv.out_dim)
    return dict(x=x, cx=cx, sh=sh, csh=csh, w=w, cw=cw, wsel=wsel, src=src,
                dst=dst, N=N, gout=gout)


def _ext_calls(fc, c, plain=True):
    """Results of K4f, K4b and K4g on one case, or of their plain
    contracts."""
    args = (c["x"], c["sh"], c["w"], c["wsel"], c["src"], c["dst"], c["N"])
    g2 = (c["x"], c["cx"], c["sh"], c["csh"], c["w"], c["cw"], c["wsel"],
          c["src"], c["dst"], c["N"], c["gout"])
    with torch.no_grad():
        if plain:
            return {"K4f": (fc.plain_forward(*args),),
                    "K4b": fc.plain_backward(*args, c["gout"]),
                    "K4g": fc.plain_grad2(*g2)}
        return {"K4f": (ext_mod.launch_forward(fc, *args),),
                "K4b": ext_mod.launch_backward(fc, *args, c["gout"]),
                "K4g": ext_mod.launch_grad2(fc, *g2)}


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (32, 130, 4099),
                                       (64, 300, 5003)])
def test_ext_kernels_match_plain(cuda, n_dim, N, E):
    """K4f, K4b and K4g against their plain contracts, padded edges
    included, at narrow and full multiplicities and sizes off every tile."""
    conv = _small_conv(cuda, n_dim, grad_order=2)
    before = (FullConvExt.launches_fwd, FullConvExt.launches_bwd,
              FullConvExt.launches_grad2)
    case = _ext_case(conv, cuda, N, E, seed=10)
    got = _ext_calls(conv.full_conv, case, plain=False)
    torch.cuda.synchronize()
    assert (FullConvExt.launches_fwd, FullConvExt.launches_bwd,
            FullConvExt.launches_grad2) == tuple(b + 1 for b in before)
    want = _ext_calls(conv.full_conv, case)
    for name in got:
        _assert_all_close(got[name], want[name],
                          [f"{name} {o}" for o in EXT_OUT[name]])


def test_ext_kernels_skip_out_of_range_edges(cuda):
    conv = _small_conv(cuda, 8, grad_order=2)
    c = _ext_case(conv, cuda, 20, 300, seed=11, pad=0)
    src, dst = c["src"].clone(), c["dst"].clone()
    src[::7] = c["N"] + 5
    dst[3::11] = -1
    keep = (src < c["N"]) & (dst >= 0)
    got = _ext_calls(conv.full_conv, dict(c, src=src, dst=dst), plain=False)
    kept = dict(c, src=src[keep], dst=dst[keep])
    for k in ("sh", "csh", "w", "cw"):
        kept[k] = c[k][keep]
    want = _ext_calls(conv.full_conv, kept)
    for name in got:
        outs = list(got[name])
        if name != "K4f":  # per-edge outputs: dropped edges give zeros
            for i in (1, 2):
                assert float(outs[i][~keep].abs().max()) == 0.0
                outs[i] = outs[i][keep]
        _assert_all_close(outs, want[name],
                          [f"{name} {o}" for o in EXT_OUT[name]])


def test_ext_bwd_function_routes(cuda):
    """The second backward takes K4g when the cotangents of dx, dsh and dw
    are live, and the pairing rule (one K4b and one K4f per live slot) when
    dx's is absent."""
    conv = _small_conv(cuda, 8, grad_order=2)
    c = _ext_case(conv, cuda, 37, 1001, seed=12)
    for wrt, want in ((("x", "sh", "w"), (1, 1, 1)),
                      (("sh", "w"), (3, 3, 0))):
        ins = {k: c[k].clone().requires_grad_(True) for k in ("x", "sh", "w")}
        before = (FullConvExt.launches_fwd, FullConvExt.launches_bwd,
                  FullConvExt.launches_grad2)
        out = conv.full_conv(conv.tp.linear, ins["x"], ins["sh"], ins["w"],
                             c["src"], c["dst"], c["N"], pre_scale=0.3)
        inner = torch.autograd.grad((out * c["gout"]).sum(),
                                    [ins[k] for k in wrt], create_graph=True)
        tot = sum((g * g.detach()).sum() for g in inner)
        torch.autograd.grad(tot, list(ins.values()) + list(
            conv.tp.linear.parameters()), allow_unused=True)
        torch.cuda.synchronize()
        got = (FullConvExt.launches_fwd - before[0],
               FullConvExt.launches_bwd - before[1],
               FullConvExt.launches_grad2 - before[2])
        assert got == want, (wrt, got)


def _fragments(n_mol, seed=0):
    """Protein-fragment-like molecules (8-23 atoms of 20 species, r_max 5)
    with N(0, 1) energy and force labels."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.6,
             "species": rng.integers(0, 20, size=(n, 1)),
             "energy": rng.normal(size=(1, 1)),
             "forces": rng.normal(size=(n, 3))}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e"), "energy": ("graph", "1x0e"),
                 "forces": ("node", "1x1o")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=5.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return mols


def test_force_model_matches_cpu(cuda):
    """Full-width ``config_energy_force``: energies and forces, and one
    training step's gradient of every parameter (through K4f, K4b and K4g
    on every layer), on the card against the plain path on the CPU."""
    cfg = get_config("config_energy_force")
    mc = cfg["model_config"]
    gb = _batch(_fragments(16), cuda)
    card = build_model(mc, cuda, torch.Generator().manual_seed(0))
    cpu = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = card(gb)
        want = cpu(gb.to("cpu"))
    for key in ("energy", "forces"):
        assert torch.isfinite(got[key]).all(), key
        assert _rel(got[key].cpu(), want[key]) <= TOL, (key, _rel(
            got[key].cpu(), want[key]))

    def step(model, batch):
        model.zero_grad()
        out = model(batch)
        loss, _ = Loss(cfg["loss_coeffs"])(out.data, batch.data)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in
                             model.named_parameters()}

    before = (FullConvExt.launches_fwd, FullConvExt.launches_bwd,
              FullConvExt.launches_grad2)
    loss, got = step(card, gb)
    torch.cuda.synchronize()
    n_layers = mc["num_layers"]
    # layer 0 pairs (2 K4b + 2 K4f); the others take K4g
    assert (FullConvExt.launches_fwd - before[0],
            FullConvExt.launches_bwd - before[1],
            FullConvExt.launches_grad2 - before[2]) == (
        n_layers + 2, 2 * n_layers + 2, n_layers - 1)
    want_loss, want = step(cpu, gb.to("cpu"))
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    for name in want:
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name], want[name]) <= TOL, (name, _rel(got[name],
                                                               want[name]))


# ------------------------------------------------------- hamiltonian path

def _water(n_mol, seed=0):
    """Synthetic H2O: the equilibrium geometry plus N(0, 0.03^2) noise."""
    rng = np.random.default_rng(seed)
    base = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    mols = []
    for _ in range(n_mol):
        d = {"pos": base + rng.normal(scale=0.03, size=(3, 3)),
             "species": np.array([[8], [1], [1]])}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return mols


@pytest.fixture(scope="module")
def hamiltonian(cuda):
    """Full-width ``config_hamiltonian`` on the card, a 16-molecule batch,
    and the positional arguments with which one forward calls K5 (twice:
    ``tp_off``, then ``tp``) and K6."""
    model = build_model(get_config("config_hamiltonian")["model_config"],
                        cuda, torch.Generator().manual_seed(0))
    model.eval()
    gb = _batch(_water(16), cuda, extra_edges=0)
    head = model.pairwise
    seen = {"K5": [], "K6": []}
    hooks = [
        head.pairwise_tp.register_forward_pre_hook(
            lambda mod, args: seen["K5"].append(args)),
        head.conv.full_conv.register_forward_pre_hook(
            lambda mod, args: seen["K6"].append(args))]
    with torch.no_grad():
        model(gb)
    for h in hooks:
        h.remove()
    return model, gb, seen


def _small_expansion(cuda, n_dim, l_max=2):
    from equivariant_nn_zoo_tpu_torch.nn.pointwise import (
        TensorProductExpansion,
    )
    from equivariant_nn_zoo_tpu_torch.utils import init_parameters

    feats = "+".join(f"{n_dim}x{l}{p}" for l in range(l_max + 1)
                     for p in "eo")
    tpe = TensorProductExpansion(feats, feats, feats, "uvu")
    init_parameters(tpe, torch.Generator().manual_seed(1))
    return tpe.to(cuda)


@pytest.mark.parametrize("n_dim,M", [(8, 41), (32, 301), (64, 130)])
def test_pairwise_kernel_matches_plain(cuda, n_dim, M):
    """K5 against ``expand`` and against the plain walk over its own
    tables, at narrow and full multiplicities and ragged sizes."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP

    tpe = _small_expansion(cuda, n_dim)
    tpk = PairwiseTP(tpe).to(cuda)
    g = torch.Generator().manual_seed(13)
    a = torch.randn(M, tpk.irreps_a.dim, generator=g).to(cuda)
    b = torch.randn(M, tpk.irreps_b.dim, generator=g).to(cuda)
    before = PairwiseTP.launches
    with torch.no_grad():
        got = tpk(tpe, a, b)
        want = tpe.expand(a, b)
        contract = tpk.plain_forward(
            a, tpk.weighted_right(tpe.tp.weight, b),
            tpk.flat_wsel(tpe.linear))
        torch.cuda.synchronize()
    assert PairwiseTP.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL
    assert _rel(got, contract) <= TOL


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (64, 130, 4099)])
def test_uvu_conv_kernel_matches_plain(cuda, n_dim, N, E):
    """K6 against ``FusedUVUConv(reduce=False)`` and its plain contract."""
    from equivariant_nn_zoo_tpu_torch.nn.message_passing import (
        FactorizedConvolution,
    )
    from equivariant_nn_zoo_tpu_torch.ops.cuda.uvu_conv import UVUConv
    from equivariant_nn_zoo_tpu_torch.utils import init_parameters

    feats = "+".join(f"{n_dim}x{l}{p}" for l in range(3) for p in "eo")
    conv = FactorizedConvolution(
        input_features=feats, output_features=feats, node_attrs=None,
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e",
        invariant_layers=2, invariant_neurons=16, avg_num_neighbors=1,
        use_sc=False, reduce=False)
    init_parameters(conv, torch.Generator().manual_seed(1))
    conv = conv.to(cuda)
    fc = conv.full_conv
    g = torch.Generator().manual_seed(14)
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g).to(cuda)
    sh = torch.randn(E, 9, generator=g).to(cuda)
    w = torch.randn(E, fc.fused.weight_numel, generator=g).to(cuda)
    src = torch.randint(0, N, (E,), generator=g).to(cuda)
    before = UVUConv.launches
    with torch.no_grad():
        got = fc(conv.tp.linear, x, sh, w, src)
        want = fc.fused(conv.tp.linear, x, src, None, sh, w, N, reduce=False)
        contract, _ = fc.plain_forward(x, sh, w,
                                       fc.flat_wsel(conv.tp.linear), src)
        torch.cuda.synchronize()
    assert UVUConv.launches == before + 1
    assert got.shape == (E, fc.out_dim) and torch.isfinite(got).all()
    assert _rel(got, want) <= TOL
    assert _rel(got, contract) <= TOL


def test_head_kernels_match_plain_at_full_width(hamiltonian):
    """K5 (``tp_off`` on the edges, ``tp`` on the nodes) and K6 at the
    full-width head's shapes, on the inputs one forward gives them."""
    model, _, seen = hamiltonian
    head = model.pairwise
    assert len(seen["K5"]) == 2 and len(seen["K6"]) == 1
    with torch.no_grad():
        for tpe, left, right in seen["K5"]:
            got = head.pairwise_tp.launch(tpe, left, right)
            want = tpe.expand(left, right)
            assert got.shape == (left.shape[0], 3200)
            assert _rel(got, want) <= TOL
        linear, x, sh, w, src = seen["K6"][0]
        fc = head.conv.full_conv
        got = fc.launch(linear, x, sh, w, src)
        want = fc.fused(linear, x, src, None, sh, w, x.shape[0],
                        reduce=False)
        torch.cuda.synchronize()
    assert got.shape == (sh.shape[0], 3200)
    assert _rel(got, want) <= TOL


def test_trunk_kernels_take_l4(hamiltonian):
    """K1 and K3, then K2 and K3b (nine register rows), at the hamiltonian
    trunk's hot layer (l = 4 in and out, 16 sh components, 3 hidden layers
    of 64) on the config's batch (96 edges); K1's output and scratch and
    K2's dx repeat bit for bit."""
    model, gb, _ = hamiltonian
    conv = model.layer3.conv
    assert conv.full_conv.max_d1 == 9
    data = _layer3_inputs(model, gb)
    assert data["edge_index"].shape[1] == 96      # the config's batch of 16
    with torch.inference_mode():
        x = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
        k1 = (conv.fc, conv.tp.linear, x, er, data["edge_spherical"],
              data["edge_index"][0], data["edge_index"][1], x.shape[0],
              conv.avg_num_neighbors ** -0.5)
        got1 = conv.full_conv.launch(*k1)
        want1 = conv.full_conv.plain(*k1)
        k3 = (conv.sc, data["input_features"], data["node_attrs"],
              data["species"])
        got3 = conv.species_sc.launch(*k3)
        want3 = conv.species_sc.plain(*k3)
        torch.cuda.synchronize()
    assert _rel(got1, want1) <= TOL
    assert _rel(got3, want3) <= TOL
    with torch.no_grad():
        x = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    k2 = _k2_case(conv, x, er, *k1[4:7], x.shape[0], k1[-1], seed=21)
    before = FullConv.backward_launches
    got = full_conv_mod.launch_backward(conv.full_conv, *k2)
    again = full_conv_mod.launch_backward(conv.full_conv, *k2)
    out1, s1 = full_conv_mod.launch_forward(conv.full_conv, *k2[:-2])
    out2, s2 = full_conv_mod.launch_forward(conv.full_conv, *k2[:-2])
    torch.cuda.synchronize()
    assert FullConv.backward_launches == before + 2
    _assert_all_close(got, conv.full_conv.plain_backward(*k2), K2_OUT)
    assert torch.equal(got[0], again[0])
    assert torch.equal(out1, out2) and torch.equal(s1, s2)
    k3b = _k3b_case(conv, data["input_features"], data["node_attrs"],
                    data["species"], seed=22)
    assert conv.species_sc.max_d == 9
    got = species_sc_mod.launch_backward(conv.species_sc, *k3b)
    torch.cuda.synchronize()
    _assert_all_close(got, conv.species_sc.plain_backward(*k3b),
                      ("dx", "dtables"))


def test_hamiltonian_model_matches_cpu(hamiltonian):
    """The full-width forward on the card against the plain path on the
    CPU; one forward launches K1 and K3 once per layer, K6 once, K5 twice."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import PairwiseTP, UVUConv

    model, gb, _ = hamiltonian
    mc = get_config("config_hamiltonian")["model_config"]
    cpu = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    before = (FullConv.launches, SpeciesScalarFCTP.launches,
              UVUConv.launches, PairwiseTP.launches)
    with torch.no_grad():
        got = model(gb)["hamiltonian"]
        torch.cuda.synchronize()
        after = (FullConv.launches, SpeciesScalarFCTP.launches,
                 UVUConv.launches, PairwiseTP.launches)
        want = cpu(gb.to("cpu"))["hamiltonian"]
    n_layers = mc["num_layers"]
    assert tuple(a - b for a, b in zip(after, before)) == (
        n_layers, n_layers, 1, 2)
    assert got.shape == (16, 576) and torch.isfinite(got).all()
    assert _rel(got.cpu(), want) <= TOL
    H = got.reshape(16, 24, 24)
    assert float((H - H.transpose(1, 2)).abs().max()) <= 1e-5 * float(
        H.abs().max())


K5_OUT = ("d left", "dbw", "dwsel")
K6_OUT = ("dx", "dsh", "dw", "dwsel")


def _cotangent(rows, cols, seed, device):
    return torch.randn(rows, cols, generator=torch.Generator().manual_seed(
        seed)).to(device)


def _function_grads_match_cpu(fn_card, fn_cpu, leaves, params, cpu_params):
    """Gradients of ``sum(fn * cos)`` through the card path against the
    same through a CPU copy's plain path."""
    def grads(fn, tensors, ps):
        ts = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*ts)
        weight = torch.cos(torch.arange(out.numel(), device=out.device,
                                        dtype=torch.float32)).reshape(
            out.shape)
        return torch.autograd.grad((out * weight).sum(), [*ts, *ps])

    got = grads(fn_card, leaves, params)
    want = grads(fn_cpu, [t.cpu() for t in leaves], cpu_params)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), i
        assert _rel(g.cpu(), w) <= TOL, (i, _rel(g.cpu(), w))


@pytest.mark.parametrize("n_dim,M", [(8, 41), (32, 301), (64, 130)])
def test_pairwise_backward_kernels_match_plain(cuda, n_dim, M):
    """K5m (dwsel), K5a (d left) and K5b (dbw) against the plain backward
    on ``(left, bw, wsel)``, then ``PairwiseTPFunction`` end to end (left,
    right and every parameter) against autograd of ``expand`` on the CPU."""
    import copy

    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_mod
    from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP

    tpe = _small_expansion(cuda, n_dim)
    cpu_tpe = copy.deepcopy(tpe).cpu()
    tpk = PairwiseTP(tpe).to(cuda)
    g = torch.Generator().manual_seed(15)
    a = torch.randn(M, tpk.irreps_a.dim, generator=g).to(cuda)
    b = torch.randn(M, tpk.irreps_b.dim, generator=g).to(cuda)
    with torch.no_grad():
        bw = tpk.weighted_right(tpe.tp.weight, b)
        wsel = tpk.flat_wsel(tpe.linear)
    gout = _cotangent(M, tpk.out_dim, 16, cuda)
    before = PairwiseTP.backward_launches
    got = k5_mod.launch_backward(tpk, a, bw, wsel, gout)
    torch.cuda.synchronize()
    assert PairwiseTP.backward_launches == before + 1
    _assert_all_close(got, tpk.plain_backward(a, bw, wsel, gout), K5_OUT)
    _function_grads_match_cpu(
        lambda a_, b_: tpk(tpe, a_, b_), cpu_tpe.expand, (a, b),
        list(tpe.parameters()), list(cpu_tpe.parameters()))
    assert PairwiseTP.backward_launches == before + 2


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (64, 130, 4099)])
def test_uvu_conv_backward_kernel_matches_plain(cuda, n_dim, N, E):
    """K6b (dx, dsh, dw, dwsel) against the plain backward, then
    ``UVUConvFunction`` end to end against ``FusedUVUConv(reduce=False)``
    under autograd on the CPU.  Several edges share each source, so the dx
    atomics and the per-edge dsh reduction are both exercised."""
    import copy

    from equivariant_nn_zoo_tpu_torch.nn.message_passing import (
        FactorizedConvolution,
    )
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_mod
    from equivariant_nn_zoo_tpu_torch.ops.cuda.uvu_conv import UVUConv
    from equivariant_nn_zoo_tpu_torch.utils import init_parameters

    feats = "+".join(f"{n_dim}x{l}{p}" for l in range(3) for p in "eo")
    conv = FactorizedConvolution(
        input_features=feats, output_features=feats, node_attrs=None,
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e",
        invariant_layers=2, invariant_neurons=16, avg_num_neighbors=1,
        use_sc=False, reduce=False)
    init_parameters(conv, torch.Generator().manual_seed(1))
    cpu_conv = copy.deepcopy(conv)
    conv = conv.to(cuda)
    fc, lin = conv.full_conv, conv.tp.linear
    g = torch.Generator().manual_seed(17)
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g).to(cuda)
    sh = torch.randn(E, 9, generator=g).to(cuda)
    w = torch.randn(E, fc.fused.weight_numel, generator=g).to(cuda)
    src = torch.randint(0, N, (E,), generator=g).to(cuda)
    with torch.no_grad():
        wsel = fc.flat_wsel(lin)
        _, scratch = k6_mod.launch_forward(fc, x, sh, w, wsel, src)
    gout = _cotangent(E, fc.out_dim, 18, cuda)
    before = UVUConv.backward_launches
    got = k6_mod.launch_backward(fc, x, sh, w, wsel, src, scratch, gout)
    torch.cuda.synchronize()
    assert UVUConv.backward_launches == before + 1
    _assert_all_close(
        got, fc.plain_backward(x, sh, w, wsel, src, scratch, gout), K6_OUT)
    cpu_fc, cpu_lin, cpu_src = cpu_conv.full_conv, cpu_conv.tp.linear, \
        src.cpu()
    _function_grads_match_cpu(
        lambda x_, sh_, w_: fc(lin, x_, sh_, w_, src),
        lambda x_, sh_, w_: cpu_fc(cpu_lin, x_, sh_, w_, cpu_src),
        (x, sh, w), list(lin.parameters()), list(cpu_lin.parameters()))
    assert UVUConv.backward_launches == before + 2


def test_head_backward_kernels_match_plain_at_full_width(hamiltonian):
    """K5m, K5a, K5b (``tp_off`` on the edges, ``tp`` on the nodes) and
    K6b at the full-width head's shapes, on the inputs one forward gives
    them, each output against the plain backward."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_mod
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_mod

    model, _, seen = hamiltonian
    head = model.pairwise
    tpk, fc = head.pairwise_tp, head.conv.full_conv
    dev = seen["K6"][0][1].device
    for i, (tpe, left, right) in enumerate(seen["K5"]):
        with torch.no_grad():
            bw = tpk.weighted_right(tpe.tp.weight, right)
            wsel = tpk.flat_wsel(tpe.linear)
        gout = _cotangent(left.shape[0], tpk.out_dim, 30 + i, dev)
        got = k5_mod.launch_backward(tpk, left, bw, wsel, gout)
        torch.cuda.synchronize()
        _assert_all_close(got, tpk.plain_backward(left, bw, wsel, gout),
                          K5_OUT)
    linear, x, sh, w, src = seen["K6"][0]
    with torch.no_grad():
        wsel = fc.flat_wsel(linear)
        _, scratch = k6_mod.launch_forward(fc, x, sh, w, wsel, src)
    gout = _cotangent(sh.shape[0], fc.out_dim, 32, dev)
    got = k6_mod.launch_backward(fc, x, sh, w, wsel, src, scratch, gout)
    torch.cuda.synchronize()
    _assert_all_close(
        got, fc.plain_backward(x, sh, w, wsel, src, scratch, gout), K6_OUT)


def test_hamiltonian_train_step_gradients_match_cpu(hamiltonian):
    """One step of the config's loss (1e5 * MSE on N(0, 1) targets) at
    full width: every parameter's gradient on the card against the CPU
    plain path, with 5 K1, 5 K2, 5 K3, 5 K3b, 1 K6, 1 K6b, 2 K5 and 2
    K5-backward launches."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import PairwiseTP, UVUConv

    model, gb, _ = hamiltonian
    cfg = get_config("config_hamiltonian")
    mc = cfg["model_config"]
    target = torch.randn(gb.n_graphs, 576,
                         generator=torch.Generator().manual_seed(33))
    cpu_gb = gb.to("cpu").replace(hamiltonian=target)
    gb = gb.replace(hamiltonian=target.to(gb["pos"].device))
    loss_fn = Loss(cfg["loss_coeffs"])

    def counts():
        return (FullConv.launches, FullConv.backward_launches,
                SpeciesScalarFCTP.launches,
                SpeciesScalarFCTP.backward_launches, UVUConv.launches,
                UVUConv.backward_launches, PairwiseTP.launches,
                PairwiseTP.backward_launches)

    def step(m, batch):
        m.zero_grad()
        loss, _ = loss_fn(m(batch).data, batch.data)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu()
                             for n, p in m.named_parameters()}

    before = counts()
    loss, got = step(model, gb)
    torch.cuda.synchronize()
    n = mc["num_layers"]
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        n, n, n, n, 1, 1, 2, 2)
    cpu = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    want_loss, want = step(cpu, cpu_gb)
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    floor = 1e-12 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        if float(w.abs().max()) < floor:    # zero by symmetry: noise
            assert float(got[name].abs().max()) < floor, name
        else:
            assert _rel(got[name], w) <= TOL, (name, _rel(got[name], w))


# ------------------------------------------------- the mix GEMM (row_mix)

def _mix_table(groups, mul):
    """A problem table as ``ConvTables`` builds one: per group (paths, d,
    output slot widths) the problems of each slot and component; returns
    ``(prob_rows, KM, out_dim, wsel_len)``."""
    rows, a_col, b_off, start, starts = [], 0, 0, 0, []
    for _, d, wos in groups:
        starts.append([])
        for wo in wos:
            starts[-1].append(start)
            start += wo * d
    for (n_paths, d, wos), slot_starts in zip(groups, starts):
        kdim = n_paths * mul
        for wo, s0 in zip(wos, slot_starts):
            for dd in range(d):
                rows.append([a_col + dd * kdim, kdim, b_off, wo, s0 + dd, d])
            b_off += kdim * wo
        a_col += d * kdim
    return np.asarray(rows, np.int32).reshape(-1, 6), a_col, start, b_off


# every c_stride 1-9 and slot widths 1, 64 and 384, several slots per group
MIX_TABLES = {
    "narrow": ([(3, 1, [1, 4]), (2, 2, [1]), (1, 3, [4]), (2, 4, [1]),
                (1, 5, [3]), (2, 6, [1]), (1, 7, [4]), (1, 8, [2]),
                (5, 9, [4, 3])], 4),
    "wide": ([(3, 1, [64, 384]), (4, 3, [64]), (2, 5, [64]), (1, 7, [64]),
              (6, 9, [64, 64])], 64),
    "single": ([(1, 1, [1]), (2, 7, [1])], 1),
}


@pytest.mark.parametrize("rows", [1, 49, 65, 3072])
@pytest.mark.parametrize("table", list(MIX_TABLES))
def test_row_mix_products_match_plain_and_repeat(cuda, table, rows):
    """The forward mix, dS and dwsel of the GEMM against their plain
    version (``row_mix.run_plan``), at ragged rows and slot widths; each
    repeats bit for bit."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm

    pr, KM, out_dim, wsel_len = _mix_table(*MIX_TABLES[table])
    g = torch.Generator().manual_seed(rows)
    S = torch.randn(rows, KM, generator=g).to(cuda)
    gout = torch.randn(rows, out_dim, generator=g).to(cuda)
    wsel = torch.randn(wsel_len, generator=g).to(cuda)
    before = rm.launches()
    for kind in (rm.FORWARD, rm.ROWS, rm.WEIGHTS):
        def run():
            if kind == rm.FORWARD:
                return rm.launch_forward(S, wsel, pr, out_dim)
            return rm.launch_backward(kind, pr, KM, gout, S=S, wsel=wsel,
                                      wsel_len=wsel_len)
        got, again = run(), run()
        want = rm.run_plan(kind, pr, rows, KM, out_dim, S=S, wsel=wsel,
                           gout=gout, wsel_len=wsel_len)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), kind
        assert _rel(got, want) <= TOL, (kind, _rel(got, want))
        assert torch.equal(got, again), kind
    after = rm.launches()
    assert after["forward"] > before["forward"]
    assert after["backward"] > before["backward"]


@pytest.mark.parametrize("M,N,K,a_t,b_t,split", [
    (64, 3072, 24386, True, False, True),    # dW_out = h^T dw
    (24386, 64, 3072, False, True, False),   # dh = dw W_out^T
    (8, 64, 4099, True, False, True),        # dW_0 = er^T dz
    (4099, 8, 64, False, True, False),       # d er = dz W_0^T
    (5, 7, 3, False, False, True),
    (65, 49, 1, True, True, False)])
def test_row_mix_matmul_matches_torch_and_repeats(cuda, M, N, K, a_t, b_t,
                                                  split):
    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm

    g = torch.Generator().manual_seed(M + N + K)
    A = torch.randn(*((K, M) if a_t else (M, K)), generator=g).to(cuda)
    B = torch.randn(*((N, K) if b_t else (K, N)), generator=g).to(cuda)
    got = rm.launch_matmul(A, B, a_t, b_t, split)
    again = rm.launch_matmul(A, B, a_t, b_t, split)
    want = (A.T if a_t else A) @ (B.T if b_t else B)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, want) <= TOL
    assert torch.equal(got, again)


def test_backward_products_repeat_bit_for_bit(model_and_batch, hamiltonian):
    """The outputs that the GEMM's plain stores and fixed order of
    summation make repeatable: K2's dW and dwsel, K6b's dwsel, K5's dwsel,
    d left and dbw, and the forward mix of K4f's problem table (K4f's
    edge sweep itself still scatters its scratch with atomics)."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_mod
    from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_mod

    def twice(fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        return a, b

    model, gb = model_and_batch
    conv = model.layer3.conv
    data = _layer3_inputs(model, gb)
    with torch.no_grad():
        x = conv.linear_1(data["input_features"])
        er = data["edge_radial"] * data["_edge_mask"]
    args = _k2_case(conv, x, er, data["edge_spherical"],
                    data["edge_index"][0], data["edge_index"][1],
                    x.shape[0], 0.1 ** 0.5, seed=4)
    a, b = twice(lambda: full_conv_mod.launch_backward(conv.full_conv, *args))
    for name, u, v in zip(K2_OUT, a, b):
        if name in ("dw_hidden", "dw_out", "dwsel"):
            assert torch.equal(u, v), f"K2 {name}"

    hmodel, _, seen = hamiltonian
    head = hmodel.pairwise
    tpk, fc = head.pairwise_tp, head.conv.full_conv
    dev = seen["K6"][0][1].device
    for i, (tpe, left, right) in enumerate(seen["K5"]):
        with torch.no_grad():
            bw = tpk.weighted_right(tpe.tp.weight, right)
            wsel = tpk.flat_wsel(tpe.linear)
        gout = _cotangent(left.shape[0], tpk.out_dim, 40 + i, dev)
        a, b = twice(lambda: k5_mod.launch_backward(tpk, left, bw, wsel,
                                                    gout))
        for name, u, v in zip(K5_OUT, a, b):
            assert torch.equal(u, v), f"K5 {name}"
    linear, x6, sh, w, src = seen["K6"][0]
    with torch.no_grad():
        wsel = fc.flat_wsel(linear)
        _, scratch = k6_mod.launch_forward(fc, x6, sh, w, wsel, src)
    gout = _cotangent(sh.shape[0], fc.out_dim, 42, dev)
    a, b = twice(lambda: k6_mod.launch_backward(fc, x6, sh, w, wsel, src,
                                                scratch, gout))
    assert torch.equal(a[3], b[3]), "K6b dwsel"

    ext = _small_conv(dev, 64, grad_order=2).full_conv
    S4 = torch.randn(300, ext.KM, generator=torch.Generator().manual_seed(
        12)).to(dev)
    wsel4 = torch.randn(ext.wsel_len, generator=torch.Generator(
    ).manual_seed(13)).to(dev)
    a, b = twice(lambda: rm.launch_forward(S4, wsel4, ext.prob_rows,
                                           ext.out_dim))
    assert torch.equal(a, b), "K4f mix"
