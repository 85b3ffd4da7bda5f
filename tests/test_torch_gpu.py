"""On-card checks of the port's CUDA kernels against their plain PyTorch
versions, at full ``config_energy`` width: K1 and K3 forward, K2 and K3b
backward, and a whole training step's gradients against the CPU plain path;
and for the force path (``config_energy_force``): K4f, K4b and K4g against
their plain contracts, the routes of the second backward, and forces and a
training step's gradients against the CPU plain path; and for the
hamiltonian serving path (``config_hamiltonian``): K5 and K6 against their
plain versions, K1 and K3 at the trunk's l = 4 layer, the full-width forward
against the CPU plain path, and the two forward-only kernels refusing a call
that needs a gradient.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card every test
skips (the decision is taken inside the fixture, never at import).
TF32 is off, so both sides compute in float32; the kernel sums with
atomics in a varying order, so agreement is rel-linf 1e-4 of max|plain|.
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
        contract = fc.plain_forward(x, sh, w, fc.flat_wsel(conv.tp.linear),
                                    src)
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
    """K1 and K3 at the hamiltonian trunk's hot layer (l = 4 in and out,
    16 sh components, 3 hidden layers of 64)."""
    model, gb, _ = hamiltonian
    conv = model.layer3.conv
    assert conv.full_conv.max_d1 == 9
    data = _layer3_inputs(model, gb)
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


def test_head_kernels_raise_when_a_gradient_is_needed(hamiltonian):
    """K5 and K6 are forward-only: a training forward on the card raises
    instead of returning detached features."""
    model, gb, seen = hamiltonian
    head = model.pairwise
    tpe, left, right = seen["K5"][0]
    with pytest.raises(NotImplementedError, match="no backward"):
        head.pairwise_tp(tpe, left, right)     # parameters need gradients
    linear, x, sh, w, src = seen["K6"][0]
    with pytest.raises(NotImplementedError, match="no backward"):
        head.conv.full_conv(linear, x.clone().requires_grad_(True), sh, w,
                            src)
    with pytest.raises(NotImplementedError, match="no backward"):
        model(gb)
