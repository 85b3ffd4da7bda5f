"""On-card checks of the port's CUDA kernels against their plain PyTorch
versions, at full ``config_energy`` width: K1 and K3 forward, K2 and K3b
backward, and a whole training step's gradients against the CPU plain path;
and for the force path (``config_energy_force``): K4f, K4b and K4g against
their plain contracts, the routes of the second backward, and forces and a
training step's gradients against the CPU plain path; and for the
hamiltonian path (``config_hamiltonian``): K5 and K6 against their plain
versions, their backward kernels (K5m, K5a, K5b; K6b) per output against the
plain backward (the adjoint sweep of K5a and K5b at the full-width head for
every set of cotangents, repeated bit for bit, and through the wrapper's
two chunks) and, through the autograd Functions, against the CPU, K1, K2,
K3 and K3b at the trunk's l = 4 layer, the full-width forward and a training
step's gradients against the CPU plain path.  K3 and K3b repeat bit for
bit, give zero rows for out-of-range species and zero dtables rows for
absent ones, and share one species order per step.  For small-molecule
diffusion (``config_diffusion``, both specs): the PC sampler's first steps
and the score-matching step's gradients against the CPU plain path on the
same replayed noise, and the model's outputs repeated bit for bit.  For
``config_dipole`` at full width: a step's gradients against the CPU plain
path, K3 and K3b at 18 species repeated bit for bit on every layer, and a
two-epoch ``Trainer.train`` through the pinned loader with a resume.  The
compiled step (``run/capture.py``): a captured ``config_energy`` step
replayed on two different batches equals the eager step on each, and a
captured run repeats itself bit for bit.  ``build_model(...,
kernels=False)``: a ``config_energy`` step through every kernel's plain
version on the card launches no kernel and gives the kernels' loss and
gradients.  At ``compute_dtype="bfloat16"``: a training step through the
bfloat16 K1, K2, K3 and K3b against their plain contracts on the card,
within the plain step's distance from float32; the bfloat16 K1/K2 walks
and K4f, K4b and K4g on ragged batches against their plain contracts
(half of the plain distance, bit for bit twice), and a bfloat16
``config_energy_force`` step against its ``kernels=False`` version.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card every test
skips (the decision is taken inside the fixture, never at import).
TF32 is off, so the plain versions compute in float32; the kernels sum in
another order (the mix GEMM of ``csrc/row_mix.cuh`` in 3xTF32 on the tensor
cores), some (K6b) with atomics in a varying order, so agreement is
rel-linf 1e-4 of max|plain|.  The mix GEMM (forward mix, dS, dwsel and the
radial MLP's products) is also checked on its own at ragged shapes, and the
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
from equivariant_nn_zoo_tpu_torch.ops.cuda import edge_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv as full_conv_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda import full_conv_ext as ext_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_order
from equivariant_nn_zoo_tpu_torch.ops.cuda import species_sc as species_sc_mod
from equivariant_nn_zoo_tpu_torch.run import Loss
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

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


@pytest.mark.parametrize("which", ["energy", "hamiltonian"])
def test_species_sc_kernels_repeat_and_zero_rows(model_and_batch,
                                                 hamiltonian, which):
    """K3 and K3b at config_energy's layer3 and config_hamiltonian's l = 4
    layer3, on one species order: out, dx and dtables repeat bit for bit
    over two launches, the dtables rows of species absent from the batch
    are exactly zero, and nodes of an out-of-range species (-1, types) get
    zero out and dx rows while the others match plain."""
    model, gb = model_and_batch if which == "energy" else hamiltonian[:2]
    conv = model.layer3.conv
    sc = conv.species_sc
    data = _layer3_inputs(model, gb)
    x, spec, tables, g = _k3b_case(conv, data["input_features"],
                                   data["node_attrs"], data["species"],
                                   seed=23)
    order = species_order.build(spec, sc.num_types)
    with torch.no_grad():
        outs = [species_sc_mod.launch_forward(sc, x, spec, tables,
                                              order=order)
                for _ in range(2)]
        grads = [species_sc_mod.launch_backward(sc, x, spec, tables, g,
                                                order=order)
                 for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    _assert_all_close((outs[0], *grads[0]),
                      (sc.table_product(x, spec, tables),
                       *sc.plain_backward(x, spec, tables, g)),
                      ("out", "dx", "dtables"))
    absent = sorted(set(range(sc.num_types)) - set(spec.tolist()))
    assert absent and not grads[0][1][absent].any()

    bad = spec.clone()
    bad[::5], bad[1::7] = -1, sc.num_types
    valid = (bad >= 0) & (bad < sc.num_types)
    out = species_sc_mod.launch_forward(sc, x, bad, tables)
    dx, dtables = species_sc_mod.launch_backward(sc, x, bad, tables, g)
    torch.cuda.synchronize()
    assert not out[~valid].any() and not dx[~valid].any()
    _assert_all_close(
        (out[valid], dx[valid], dtables),
        (sc.table_product(x[valid], bad[valid], tables),
         *sc.plain_backward(x[valid], bad[valid], tables, g[valid])),
        ("out", "dx", "dtables"))


def test_one_species_order_per_step(model_and_batch):
    """A training step of the 5-layer model builds the species order once:
    the five K3 and five K3b launches share it."""
    model, gb = model_and_batch
    species_order._last = None  # forget an order of an earlier test
    builds = species_order.builds
    before = (SpeciesScalarFCTP.launches,
              SpeciesScalarFCTP.backward_launches)
    model(gb)["total_energy"].sum().backward()
    torch.cuda.synchronize()
    model.zero_grad()
    n_layers = get_config("config_energy")["model_config"]["num_layers"]
    assert SpeciesScalarFCTP.launches - before[0] == n_layers
    assert SpeciesScalarFCTP.backward_launches - before[1] == n_layers
    assert species_order.builds == builds + 1


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


def _step_gradients(model, gb, loss64=False):
    """One step's loss and every parameter's gradient; ``loss64``: the
    loss value computed again in float64 from the same step's float32 node
    energies before the model's tail (per-species shift, sum over each
    graph's atoms; the gradients are the float32 loss's)."""
    seen = {}
    hook = model.rescale.register_forward_hook(
        lambda mod, args, out: seen.update(e=args[0]["input"]))
    model.zero_grad()
    out = model(gb)
    hook.remove()
    loss_fn = Loss({"total_energy": [1e3, "MSELoss"]})
    loss, _ = loss_fn(out.data, gb.data)
    loss.backward()
    value = loss.item()
    if loss64:
        d = {k: v.detach().double() if torch.is_tensor(v)
             and v.is_floating_point() else v for k, v in gb.data.items()}
        r, species = model.rescale, gb["species"].reshape(-1).long()
        e = seen["e"].detach().double()
        if r.has_scales:
            e = r.scales[species][:, None].double() * e
        e = (r.shifts[species][:, None].double() + e) * d["_node_mask"]
        energy = torch.zeros(d["_graph_mask"].shape[0] + 1, 1,
                             dtype=torch.float64, device=e.device)
        energy = energy.index_add(0, gb["_node_segment"], e)[:-1]
        value = float(loss_fn({"total_energy": energy}, d)[0])
    return value, {n: p.grad.detach().cpu() for n, p in
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
    autograd, and an sh that needs a gradient gets its cotangent (K2's dsh
    mode)."""
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
    out = conv.full_conv(*args[:4], sh, *args[5:])
    (dsh,) = torch.autograd.grad(out.square().sum(), sh)
    assert dsh.shape == sh.shape and torch.isfinite(dsh).all()
    assert dsh.abs().max() > 0


# ------------------------------------------------------------- force path

EXT_OUT = {"K4f": ("out",), "K4b": ("dx", "dsh", "dw", "dwsel"),
           "K4b saved": ("dx", "dsh", "dw", "dwsel"),
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
    """Results of K4f, K4b (with the scratch recomputed, and on K4f's
    saved scratch) and K4g on one case, on one edge order, or of their
    plain contracts."""
    args = (c["x"], c["sh"], c["w"], c["wsel"], c["src"], c["dst"], c["N"])
    g2 = (c["x"], c["cx"], c["sh"], c["csh"], c["w"], c["cw"], c["wsel"],
          c["src"], c["dst"], c["N"], c["gout"])
    with torch.no_grad():
        if plain:
            bwd = fc.plain_backward(*args, c["gout"])
            return {"K4f": (fc.plain_forward(*args),), "K4b": bwd,
                    "K4b saved": bwd, "K4g": fc.plain_grad2(*g2)}
        order = edge_order.build(c["src"], c["dst"], c["N"])
        out, scratch = ext_mod.launch_forward(fc, *args, order=order)
        return {"K4f": (out,),
                "K4b": ext_mod.launch_backward(fc, *args, c["gout"],
                                               order=order),
                "K4b saved": ext_mod.launch_backward(
                    fc, *args, c["gout"], order=order, scratch=scratch),
                "K4g": ext_mod.launch_grad2(fc, *g2, order=order)}


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
            FullConvExt.launches_grad2) == (before[0] + 1, before[1] + 2,
                                            before[2] + 1)
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
    _assert_ext_close(got, want, keep)


def _assert_ext_close(got, want, keep):
    """Every K4 output against plain, on the kept edges; the per-edge
    outputs of the dropped edges are zero."""
    for name in got:
        outs = list(got[name])
        if name != "K4f":  # per-edge outputs: dropped edges give zeros
            for i in (1, 2):
                assert not outs[i][~keep].any(), (name, i)
                outs[i] = outs[i][keep]
        _assert_all_close(outs, want[name],
                          [f"{name} {o}" for o in EXT_OUT[name]])


@pytest.mark.parametrize("kind", ["shuffled", "padded", "hub",
                                  "out_of_range"])
def test_ext_kernels_match_plain_on_hard_edge_orders(cuda, kind):
    """K4f, K4b (both branches) and K4g at full width (64 channels of
    l <= 2) on K1's hard edge orders: the walks' long runs at the dummy
    node and at a hub, and dropped endpoints, against the plain contracts
    on the kept edges; every output repeats bit for bit over two
    launches."""
    dev = cuda
    conv = _small_conv(dev, 64, grad_order=2)
    N, g = 211, torch.Generator().manual_seed(32)
    src, dst = _edges(kind, N, 3001, g)
    c = _ext_case(conv, dev, N, src.shape[0], seed=33, pad=0)
    keep = ((src >= 0) & (src < N) & (dst >= 0) & (dst < N)).to(dev)
    c.update(src=src.to(dev), dst=dst.to(dev))
    got = _ext_calls(conv.full_conv, c, plain=False)
    again = _ext_calls(conv.full_conv, c, plain=False)
    torch.cuda.synchronize()
    for name in got:
        assert all(torch.equal(a, b) for a, b in zip(got[name],
                                                     again[name])), name
    kept = dict(c, src=c["src"][keep], dst=c["dst"][keep])
    for k in ("sh", "csh", "w", "cw"):
        kept[k] = c[k][keep]
    _assert_ext_close(got, _ext_calls(conv.full_conv, kept), keep)


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
    dst = torch.randint(0, N, (E,), generator=g).to(cuda)
    before = UVUConv.launches
    with torch.no_grad():
        got = fc(conv.tp.linear, x, sh, w, src, dst)
        want = fc.fused(conv.tp.linear, x, src, None, sh, w, N, reduce=False)
        contract = fc.plain_forward(x, sh, w, fc.flat_wsel(conv.tp.linear),
                                    src)
        again = fc(conv.tp.linear, x, sh, w, src, dst)
        torch.cuda.synchronize()
    assert UVUConv.launches == before + 2
    assert torch.equal(got, again)
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
        linear, x, sh, w, src, dst = seen["K6"][0]
        fc = head.conv.full_conv
        got = fc.launch(linear, x, sh, w, src, dst)
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


@pytest.fixture(scope="module")
def full_head_tp(cuda):
    """The full-width head's expansion (64 channels of l <= 4) and its
    kernel tables, on the card."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP

    tpe = _small_expansion(cuda, 64, l_max=4)
    return tpe, PairwiseTP(tpe).to(cuda)


@pytest.mark.parametrize("M", [49, 96, 1537, 3072])
def test_pairwise_adjoint_sweep_matches_plain_and_repeats(full_head_tp, M):
    """The adjoint sweep (d left, dbw) and K5m at the full-width head, at
    the M of both ``Pairwise`` calls at batch 16 and 512, for every set of
    cotangents the C entry takes, against the plain backward per output;
    d left, dbw and dwsel repeat bit for bit."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_mod

    tpe, tpk = full_head_tp
    dev = tpk.fused_paths.device
    g = torch.Generator().manual_seed(50 + M)
    a = torch.randn(M, tpk.irreps_a.dim, generator=g).to(dev)
    b = torch.randn(M, tpk.irreps_b.dim, generator=g).to(dev)
    with torch.no_grad():
        bw = tpk.weighted_right(tpe.tp.weight, b)
        wsel = tpk.flat_wsel(tpe.linear)
    gout = _cotangent(M, tpk.out_dim, 51, dev)
    want = tpk.plain_backward(a, bw, wsel, gout)
    for parts in (7, 1, 2, 4, 6):
        wanted = (bool(parts & 2), bool(parts & 4), bool(parts & 1))
        got = k5_mod.launch_backward(tpk, a, bw, wsel, gout, wanted)
        again = k5_mod.launch_backward(tpk, a, bw, wsel, gout, wanted)
        torch.cuda.synchronize()
        for name, w, x, y, need in zip(K5_OUT, want, got, again, wanted):
            assert (x is None) == (not need), (parts, name)
            if need:
                assert torch.isfinite(x).all(), (parts, name)
                assert _rel(x, w) <= TOL, (parts, name, _rel(x, w))
                assert torch.equal(x, y), (parts, name)
    del want, bw


@pytest.mark.parametrize("M", [49, 96, 1537, 3072, 4097])
def test_pairwise_fused_forward_matches_plain_and_repeats(full_head_tp, M):
    """K5 (the fused CG and mix) at the full-width head, at the M of both
    ``Pairwise`` calls at batch 16 and 512 (the components split over
    units at the first two, whole groups at the others) and through the
    wrapper's two chunks at 4097, against the plain forward; its output
    repeats bit for bit."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as k5_mod
    from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP

    tpe, tpk = full_head_tp
    dev = tpk.fused_paths.device
    g = torch.Generator().manual_seed(60 + M)
    a = torch.randn(M, tpk.irreps_a.dim, generator=g).to(dev)
    b = torch.randn(M, tpk.irreps_b.dim, generator=g).to(dev)
    with torch.no_grad():
        if M > PairwiseTP.CHUNK:
            before = PairwiseTP.launches
            got = tpk.launch(tpe, a, b)
            again = tpk.launch(tpe, a, b)
            assert PairwiseTP.launches == before + 4
            want = tpe.expand(a, b)
        else:
            bw = tpk.weighted_right(tpe.tp.weight, b)
            wsel = tpk.flat_wsel(tpe.linear)
            got = k5_mod.launch_forward(tpk, a, bw, wsel)
            again = k5_mod.launch_forward(tpk, a, bw, wsel)
            want = tpk.plain_forward(a, bw, wsel)
        torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL, _rel(got, want)
    assert torch.equal(got, again)


def test_pairwise_wrapper_two_chunks_at_full_width(full_head_tp):
    """4097 elements through ``PairwiseTP.launch`` under autograd: two
    chunks (4096 and 1 elements), each one forward and one backward
    launch; left, right and every parameter's gradient against autograd
    of ``expand`` on the card."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP

    tpe, tpk = full_head_tp
    dev = tpk.fused_paths.device
    M = PairwiseTP.CHUNK + 1
    g = torch.Generator().manual_seed(52)
    leaves = [torch.randn(M, tpk.irreps_a.dim, generator=g).to(dev),
              torch.randn(M, tpk.irreps_b.dim, generator=g).to(dev)]

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in leaves]
        out = fn(*ts)
        weight = torch.cos(torch.arange(out.numel(), device=dev,
                                        dtype=torch.float32)).reshape(
            out.shape)
        return torch.autograd.grad((out * weight).sum(),
                                   [*ts, *tpe.parameters()])

    before = (PairwiseTP.launches, PairwiseTP.backward_launches)
    got = grads(lambda a_, b_: tpk.launch(tpe, a_, b_))
    torch.cuda.synchronize()
    assert (PairwiseTP.launches, PairwiseTP.backward_launches) == (
        before[0] + 2, before[1] + 2)
    want = grads(tpe.expand)
    for i, (x, w) in enumerate(zip(got, want)):
        assert torch.isfinite(x).all(), i
        assert _rel(x, w) <= TOL, (i, _rel(x, w))


@pytest.mark.parametrize("n_dim,N,E", [(8, 37, 1001), (64, 130, 4099)])
def test_uvu_conv_backward_kernel_matches_plain(cuda, n_dim, N, E):
    """K6b (dx, dsh, dw, dwsel) against the plain backward, each output
    repeated bit for bit, then ``UVUConvFunction`` end to end against
    ``FusedUVUConv(reduce=False)`` under autograd on the CPU.  Several
    edges share each source, so the dx sums per source and the per-edge
    dsh sums over the units are both exercised."""
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
    dst = torch.randint(0, N, (E,), generator=g).to(cuda)
    with torch.no_grad():
        wsel = fc.flat_wsel(lin)
    gout = _cotangent(E, fc.out_dim, 18, cuda)
    before = UVUConv.backward_launches
    got = k6_mod.launch_backward(fc, x, sh, w, wsel, src, gout)
    again = k6_mod.launch_backward(fc, x, sh, w, wsel, src, gout)
    torch.cuda.synchronize()
    assert UVUConv.backward_launches == before + 2
    _assert_all_close(
        got, fc.plain_backward(x, sh, w, wsel, src, gout), K6_OUT)
    for name, a, b in zip(K6_OUT, got, again):
        assert torch.equal(a, b), name
    cpu_fc, cpu_lin, cpu_src = cpu_conv.full_conv, cpu_conv.tp.linear, \
        src.cpu()
    _function_grads_match_cpu(
        lambda x_, sh_, w_: fc(lin, x_, sh_, w_, src, dst),
        lambda x_, sh_, w_: cpu_fc(cpu_lin, x_, sh_, w_, cpu_src, dst.cpu()),
        (x, sh, w), list(lin.parameters()), list(cpu_lin.parameters()))
    assert UVUConv.backward_launches == before + 3


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
    linear, x, sh, w, src, dst = seen["K6"][0]
    with torch.no_grad():
        wsel = fc.flat_wsel(linear)
    gout = _cotangent(sh.shape[0], fc.out_dim, 32, dev)
    order = edge_order.build(src, dst, x.shape[0])
    got = k6_mod.launch_backward(fc, x, sh, w, wsel, src, gout, order=order)
    torch.cuda.synchronize()
    _assert_all_close(
        got, fc.plain_backward(x, sh, w, wsel, src, gout), K6_OUT)


@pytest.mark.parametrize("E", [96, 768, 3072])
def test_head_conv_kernels_match_plain_at_each_batch(hamiltonian, E):
    """K6 and K6b on the full-width head's conv at the edges of a batch of
    16, 128 and 512 molecules (N = E / 2 + 1 node rows, two shuffled edges
    per source node), seeded inputs: every output against its plain
    version, repeated bit for bit over two launches."""
    from equivariant_nn_zoo_tpu_torch.ops.cuda import uvu_conv as k6_mod

    model, _, _ = hamiltonian
    conv = model.pairwise.conv
    fc = conv.full_conv
    dev = next(model.parameters()).device
    N = E // 2 + 1
    g = torch.Generator().manual_seed(E)
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g).to(dev)
    sh = torch.randn(E, fc.fused.J_dim, generator=g).to(dev)
    w = torch.randn(E, fc.fused.weight_numel, generator=g).to(dev)
    src = (torch.randperm(E, generator=g) // 2).to(dev)
    dst = (torch.randperm(E, generator=g) // 2).to(dev)
    with torch.no_grad():
        wsel = fc.flat_wsel(conv.tp.linear)
        got = k6_mod.launch_forward(fc, x, sh, w, wsel, src)
        again = k6_mod.launch_forward(fc, x, sh, w, wsel, src)
        want = fc.plain_forward(x, sh, w, wsel, src)
        torch.cuda.synchronize()
    assert torch.isfinite(got).all() and _rel(got, want) <= TOL
    assert torch.equal(got, again)
    gout = _cotangent(E, fc.out_dim, 50, dev)
    order = edge_order.build(src, dst, N)
    got = k6_mod.launch_backward(fc, x, sh, w, wsel, src, gout, order=order)
    again = k6_mod.launch_backward(fc, x, sh, w, wsel, src, gout,
                                   order=order)
    torch.cuda.synchronize()
    _assert_all_close(got, fc.plain_backward(x, sh, w, wsel, src, gout),
                      K6_OUT)
    for name, a, b in zip(K6_OUT, got, again):
        assert torch.equal(a, b), name


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
    summation make repeatable: K2's dW and dwsel, every output of K6b (its
    ordered sums), K5's dwsel,
    d left and dbw, and the forward mix of K4f's problem table; and with
    the K4 walks' plain stores, K4b's dx and dwsel (on K4f's saved scratch
    and recomputed) and K4g's c_x, c_m and c_g, at the force layer's full
    width."""
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
    linear, x6, sh, w, src, _ = seen["K6"][0]
    with torch.no_grad():
        wsel = fc.flat_wsel(linear)
    gout = _cotangent(sh.shape[0], fc.out_dim, 42, dev)
    a, b = twice(lambda: k6_mod.launch_backward(fc, x6, sh, w, wsel, src,
                                                gout))
    for name, u, v in zip(K6_OUT, a, b):
        assert torch.equal(u, v), f"K6b {name}"

    ext = _small_conv(dev, 64, grad_order=2).full_conv
    S4 = torch.randn(300, ext.KM, generator=torch.Generator().manual_seed(
        12)).to(dev)
    wsel4 = torch.randn(ext.wsel_len, generator=torch.Generator(
    ).manual_seed(13)).to(dev)
    a, b = twice(lambda: rm.launch_forward(S4, wsel4, ext.prob_rows,
                                           ext.out_dim))
    assert torch.equal(a, b), "K4f mix"

    conv4 = _small_conv(dev, 64, grad_order=2)
    c = _ext_case(conv4, dev, 300, 5003, seed=14)
    a, b = twice(lambda: _ext_calls(conv4.full_conv, c, plain=False))
    for name, outs in (("K4b", ("dx", "dwsel")), ("K4b saved", ("dx",
                                                                "dwsel")),
                       ("K4g", ("c_x", "c_m", "c_g"))):
        for i, what in enumerate(EXT_OUT[name]):
            if what in outs:
                assert torch.equal(a[name][i], b[name][i]), (name, what)


# ------------------------------------------------ small-molecule diffusion

def _diffusion_molecules(n_mol, seed):
    """Fully-connected molecules of 8-19 atoms of 18 species with a bond
    type per edge, as ``bench.py``'s ``synthetic_diffusion_mols``."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 20))
        d = {"pos": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
             "species": rng.integers(0, 18, size=(n, 1))}
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=9999.0)
        d.update(out)
        d["bond_type"] = rng.integers(0, 4, size=(d["edge_index"].shape[1],
                                                  1))
        attrs["bond_type"] = ("edge", "1x0e")
        mols.append(Data(attrs, **d))
    return mols


class _Replay:
    """A noise source that hands out seeded host draws in order, each
    moved to ``device``: the same draws on the card and on the CPU."""

    def __init__(self, shapes, seed, device, uniform_first=False):
        gen = torch.Generator().manual_seed(seed)
        self.draws = [torch.rand(s, generator=gen)
                      if uniform_first and i == 0
                      else torch.randn(s, generator=gen)
                      for i, s in enumerate(shapes)]
        self.device = device

    def normal(self, shape):
        a = self.draws.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return a.to(self.device)

    uniform = normal


@pytest.fixture(scope="module", params=("", "nll"))
def diffusion(cuda, request):
    """Full-width ``config_diffusion`` of one spec on the card and on the
    CPU from one seed, and an 8-molecule batch (with padded edges) on the
    CPU."""
    mc = get_config("config_diffusion", request.param)["model_config"]
    return (request.param,
            build_model(mc, cuda, torch.Generator().manual_seed(0)),
            build_model(mc, "cpu", torch.Generator().manual_seed(0)),
            _batch(_diffusion_molecules(8, seed=50), "cpu"))


def test_diffusion_sampler_steps_match_cpu(diffusion, cuda):
    """Three steps of the PC sampler (VP-SDE at N = 1000, from t = 1) on
    the same replayed noise: positions on the card against the CPU plain
    path; the conv kernels launch once per layer and score evaluation."""
    from equivariant_nn_zoo_tpu_torch.run import sde_sampling, sde_utils

    spec, card, cpu, gb = diffusion
    sde = sde_utils.VPSDE({"pos": 3}, N=1000)
    # host draws handed out one by one: the eager loop (a captured
    # iteration would replay its first draws)
    pc = sde_sampling.get_pc_sampler(
        sde, sde_sampling.get_predictor("euler_maruyama"),
        sde_sampling.get_corrector("langevin"), None, snr=0.16,
        capture=False)
    shapes = [(gb.node_capacity, 3)] * (1 + 3 * 2)
    before = (FullConv.launches, FullConvExt.launches_fwd)
    got, nfe = pc(card, gb.to(cuda), _Replay(shapes, 51, cuda), steps=3)
    torch.cuda.synchronize()
    launched = (FullConv.launches - before[0],
                FullConvExt.launches_fwd - before[1])
    assert launched == ((0, 4 * nfe) if spec else (4 * nfe, 0))
    want, _ = pc(cpu, gb, _Replay(shapes, 51, "cpu"), steps=3)
    assert torch.isfinite(got["pos"]).all()
    assert _rel(got["pos"].cpu(), want["pos"]) <= TOL


def test_diffusion_step_gradients_match_cpu(diffusion, cuda):
    """One step of the score-matching loss on the same replayed t and z:
    the loss and every parameter's gradient on the card against the CPU
    plain path (tensors zero by symmetry held small on both sides)."""
    from equivariant_nn_zoo_tpu_torch.run import sde_utils

    _, card, cpu, gb = diffusion
    sde = sde_utils.VPSDE({"pos": 3}, N=1000)
    loss_fn = sde_utils.get_sde_loss_fn(sde, True, reduce_mean=True)
    shapes = [(gb.n_graphs, 1), (gb.node_capacity, 3)]

    def step(m, dev):
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, gb.to(dev), _Replay(shapes, 52, dev, True))
        loss.backward()
        return loss.item(), {
            n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
            for n, p in m.named_parameters()}

    loss, got = step(card, cuda)
    want_loss, want = step(cpu, "cpu")
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    floor = 1e-12 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        if float(w.abs().max()) < floor:    # zero by symmetry: noise
            assert float(got[name].abs().max()) < floor, name
        else:
            assert _rel(got[name], w) <= TOL, (name, _rel(got[name], w))


def test_diffusion_outputs_repeat_bit_for_bit(diffusion, cuda):
    from equivariant_nn_zoo_tpu_torch.run.sde_utils import with_t

    _, card, _, gb = diffusion
    gb = with_t(gb.to(cuda), torch.linspace(0.05, 1.0, gb.n_graphs,
                                            device=cuda)[:, None])
    with torch.no_grad():
        a, b = card(gb)["score_pos"], card(gb)["score_pos"]
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)


# ------------------------------------------------------------------ dipole

def _dipole_molecules(n_mol, seed, edges=True):
    """``config_dipole``'s molecules as ``bench.py`` makes them: 8-23 atoms
    of 18 species, N(0, 1.4^2) positions, N(0, 1) per-node dipoles."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.integers(0, 18, size=(n, 1)),
             "dipole": rng.normal(size=(n, 3)).astype(np.float32)}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e"), "dipole": ("node", "1x1o")}
        if edges:
            out, attrs = computeEdgeIndex(d, attrs, r_max=5.0)
            d.update(out)
        mols.append(Data(attrs, **d))
    return mols


@pytest.fixture(scope="module")
def dipole(cuda):
    cfg = get_config("config_dipole")
    mc = cfg["model_config"]
    card = build_model(mc, cuda, torch.Generator().manual_seed(0))
    cpu = build_model(mc, "cpu", torch.Generator().manual_seed(0))
    host = Batch.from_data_list(_dipole_molecules(24, 5))
    gb = GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                               int(host["_n_edges"].sum()), 24, "cpu")
    return cfg, card, cpu, gb


def test_dipole_step_gradients_match_cpu(dipole, cuda):
    """Full-width ``config_dipole``: one step's loss (1e3 MSE on N(0, 1)
    dipoles) and every parameter's gradient on the card against the CPU
    plain path."""
    cfg, card, cpu, gb = dipole
    loss_fn = Loss(cfg["loss_coeffs"])

    def step(m, dev):
        m.zero_grad(set_to_none=True)
        b = gb.to(dev)
        out = m(b)
        loss, _ = loss_fn(out.data, b.data)
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    before = (FullConv.launches, SpeciesScalarFCTP.backward_launches)
    loss, got = step(card, cuda)
    torch.cuda.synchronize()
    assert (FullConv.launches - before[0],
            SpeciesScalarFCTP.backward_launches - before[1]) == (5, 5)
    want_loss, want = step(cpu, "cpu")
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    floor = 1e-12 * max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        if float(w.abs().max()) < floor:    # zero by symmetry: noise
            assert float(got[name].abs().max()) < floor, name
        else:
            assert _rel(got[name], w) <= TOL, (name, _rel(got[name], w))


def test_species_tables_repeat_at_18_species(dipole, cuda):
    """K3 and K3b at ``config_dipole``'s 18 species on every layer's
    operands: each output repeats bit for bit and agrees with the plain
    version."""
    _, card, _, gb = dipole
    seen = []
    hooks = [getattr(card, f"layer{i}").conv.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0]))) for i in range(5)]
    with torch.no_grad():
        card(gb.to(cuda))
    for h in hooks:
        h.remove()
    for conv, data in seen:
        ssc = conv.species_sc
        assert ssc.num_types == 18
        x, attrs = data["input_features"], data["node_attrs"]
        spec = data["species"].reshape(-1)
        order = species_order.shared(spec, 18)
        with torch.no_grad():
            tables = ssc.tables(conv.sc, attrs, spec)
            g = torch.randn(x.shape[0], ssc.irreps_out.dim,
                            generator=torch.Generator().manual_seed(3)).to(cuda)
            outs = [species_sc_mod.launch_forward(ssc, x, spec, tables,
                                                  order=order)
                    for _ in range(2)]
            grads = [species_sc_mod.launch_backward(ssc, x, spec, tables, g,
                                                    order=order)
                     for _ in range(2)]
            plain = ssc.table_product(x, spec, tables)
            plain_grads = ssc.plain_backward(x, spec, tables, g)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        assert _rel(outs[0], plain) <= TOL
        for a, b in zip(grads[0], plain_grads):
            assert _rel(a, b) <= TOL


def test_dipole_trainer_trains_and_resumes_on_the_card(cuda, tmp_path):
    """``CondensedDataset`` (in memory) -> ``set_dataset`` -> ``train`` for
    two epochs through the pinned loader and the copy stream, then
    ``from_file`` with ``max_epochs`` 3: the state comes back bit for bit
    and the third epoch runs; the kernels launch on every step."""
    from equivariant_nn_zoo_tpu_torch.data import CondensedDataset
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    cfg = get_config("config_dipole")
    mc = cfg["model_config"]
    host = Batch.from_data_list(_dipole_molecules(80, 6, edges=False))
    dc = dict(cfg["data_config"], n_train=64, n_val=16)
    ds = CondensedDataset(data=host.data, attrs=host.attrs,
                          preprocess=dc["preprocess"],
                          type_names=dc["type_names"],
                          cache_preprocessed=True)
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    settings.update(max_epochs=2, batch_size=16, data_config=dc,
                    workdir=str(tmp_path))
    first = Trainer(build_model(mc, cuda, torch.Generator().manual_seed(0)),
                    **settings)
    first.set_dataset(ds)
    assert first.dl_train.pin_memory
    # the steps are captured (the default on the card): a replay runs the
    # kernels without their wrappers, so the device's launches are
    # counted by kernel name from the profiler
    from torch.profiler import ProfilerActivity, profile

    before = (FullConv.launches, FullConv.backward_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first.train()
        torch.cuda.synchronize()
    ran = {}
    for e in prof.key_averages():
        for name in ("k1_walk_kernel", "k2_walk_kernel"):
            if name in e.key and str(e.device_type).endswith("CUDA"):
                ran[name] = ran.get(name, 0) + e.count
    assert ran == {"k1_walk_kernel": 5 * 10, "k2_walk_kernel": 5 * 8}
    assert FullConv.launches > before[0]
    assert FullConv.backward_launches > before[1]
    assert np.isfinite(first.mae_dict["validation_loss"])
    resumed = Trainer.from_file(
        first.trainer_save_path, max_epochs=3,
        model=build_model(mc, cuda, torch.Generator().manual_seed(1)))
    for (n, a), b in zip(first.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(first.ema_model.parameters(),
                    resumed.ema_model.parameters()):
        assert torch.equal(a, b)
    sa = first.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][key].cpu(), sb[i][key].cpu()), (i, key)
    resumed.set_dataset(ds)
    resumed.train()
    assert resumed.iepoch == 3 and resumed.stop_arg == "max epochs"


# ------------------------------------------------------ the compiled step

def _energy_trainers(cuda, **kw):
    """A captured (the default on the card) and an eager ``Trainer`` of
    full-width ``config_energy`` from one seed."""
    from equivariant_nn_zoo_tpu_torch.run import Trainer

    cfg = get_config("config_energy")
    settings = {k: v for k, v in cfg.items()
                if k not in ("model_config", "data_config", "batch_size")}
    return [Trainer(build_model(cfg["model_config"], cuda,
                                torch.Generator().manual_seed(0)),
                    capture=c, **settings, **kw) for c in (None, False)]


def _energy_batches(cuda, n):
    """``n`` batches of 16 molecules at one capacity, N(0, 1) labels."""
    hosts = [Batch.from_data_list(_molecules(16, seed=s)) for s in range(n)]
    node_cap = max(int(h["_n_nodes"].sum()) for h in hosts) + 1
    edge_cap = max(int(h["_n_edges"].sum()) for h in hosts) + 64
    out = []
    for i, h in enumerate(hosts):
        gb = GraphBatch.from_batch(h, node_cap, edge_cap, 16, cuda)
        out.append(gb.replace(total_energy=torch.randn(
            16, 1, generator=torch.Generator().manual_seed(i)).to(cuda)))
    return out


def test_captured_step_equals_eager_on_two_batches(cuda):
    """Past its warm-up and capture, the captured step replayed on two
    different batches equals the eager step on each (loss, outputs and
    every parameter after the step) at 1e-4, and the two batches' outputs
    differ."""
    cap, eager = _energy_trainers(cuda)
    a, b = _energy_batches(cuda, 2)
    seen = {}
    for i, gb in enumerate([a, a, a, b, a, b]):
        outs = []
        for tr in (cap, eager):
            tr.batch_step(gb)
            outs.append(tr.batch_losses["loss"])
        assert _rel(outs[0], outs[1]) <= TOL, i
        for (n, p), q in zip(cap.model.named_parameters(),
                             eager.model.parameters()):
            assert _rel(p.detach(), q.detach()) <= TOL, (i, n)
        with torch.no_grad():
            seen[i] = cap.model(gb)["total_energy"].cpu()
    assert cap._steps["train"].captures == 1
    assert not torch.allclose(seen[4], seen[5])


def test_captured_run_repeats_bit_for_bit(cuda):
    """Two captured runs from one seed over the same batches end equal
    bit for bit (PyTorch's deterministic algorithms on: the segment sums'
    ``index_add_`` otherwise sums by atomics)."""
    batches = _energy_batches(cuda, 3)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for _ in range(2):
            tr = _energy_trainers(cuda)[0]
            for i in range(7):
                tr.batch_step(batches[i % 3])
            runs.append(tr)
    finally:
        torch.use_deterministic_algorithms(False)
    for (n, p), q in zip(runs[0].model.named_parameters(),
                         runs[1].model.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(runs[0].ema_model.parameters(),
                    runs[1].ema_model.parameters()):
        assert torch.equal(p, q)


def test_kernels_off_step_matches_the_kernels(cuda):
    """One ``config_energy`` training step of a model built with
    ``kernels=False`` (every wrapper's plain version on CUDA tensors)
    launches no kernel, and its loss and every gradient equal those of the
    default model, which launches K1, K2, K3 and K3b once a layer, at
    1e-4."""
    gb = _energy_batches(cuda, 1)[0]
    n_layers = get_config("config_energy")["model_config"]["num_layers"]
    counters = ((FullConv, "launches"), (FullConv, "backward_launches"),
                (SpeciesScalarFCTP, "launches"),
                (SpeciesScalarFCTP, "backward_launches"))
    runs = {}
    for kernels in (False, True):
        model = build_model(get_config("config_energy")["model_config"],
                            cuda, torch.Generator().manual_seed(0),
                            kernels=kernels)
        before = [getattr(c, a) for c, a in counters]
        runs[kernels] = _step_gradients(model, gb)
        torch.cuda.synchronize()
        launched = [getattr(c, a) - b for (c, a), b in zip(counters, before)]
        assert launched == ([n_layers] * 4 if kernels else [0] * 4), launched
    (loss, got), (want_loss, want) = runs[True], runs[False]
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.isfinite(want[name]).all(), name
        assert _rel(got[name], want[name]) <= TOL, (name, _rel(got[name],
                                                               want[name]))


BF16_STEP_SHARE = 0.75
# the least relative L2 distance that float32 resolves between two steps:
# two roundings of one place each (2^-23 relative at most)
F32_RESOLUTION = 2.0 ** -22


def test_bf16_step_matches_its_plain_version(cuda):
    """One bfloat16 ``config_energy`` training step on the card through the
    bfloat16 K1, K2, K3 and K3b (once a layer each) against the same step
    through their bfloat16 plain contracts on the card (``kernels=False``):
    the loss and every gradient within ``BF16_STEP_SHARE`` of the plain
    step's own distance from the float32 plain step, relative L2 per
    tensor.  Each kernel alone is held to half of it (``chip_smoke.py``
    phase 42); through five layers and back, a rounding that one order's
    float32 sum flips moves the next layer's operands by a bfloat16 place,
    so a whole step's two orders part by about half the precision's
    distance (the node energies: 0.48 of it, measured on one H100), where a
    card model that dropped a rounding point would part by about all of
    it.  The losses are compared as computed in float64 from each step's
    float32 node energies (the model's tail, per-species shifts of order
    -1e3 an atom and the sum over a graph's atoms, redone in float64): the
    float32 energies of order -2e4 carry one place of 0.002, as much as
    the whole bfloat16-vs-float32 difference of a graph's energy, so the
    float32 loss (about 4e11, one place 32768) compares the last places of
    the tail's sums, not the kernels."""
    gb = _energy_batches(cuda, 1)[0]
    mc = get_config("config_energy")["model_config"]
    n_layers = mc["num_layers"]
    counters = ((FullConv, "bf16_launches"),
                (FullConv, "bf16_backward_launches"),
                (SpeciesScalarFCTP, "bf16_launches"),
                (SpeciesScalarFCTP, "bf16_backward_launches"))
    runs = {}
    for dtype, kernels in (("bfloat16", True), ("bfloat16", False),
                           ("float32", False)):
        model = build_model(dict(mc, compute_dtype=dtype), cuda,
                            torch.Generator().manual_seed(0),
                            kernels=kernels)
        before = [getattr(c, a) for c, a in counters]
        runs[dtype, kernels] = _step_gradients(model, gb, loss64=True)
        torch.cuda.synchronize()
        launched = [getattr(c, a) - b for (c, a), b in zip(counters, before)]
        want = n_layers if kernels else 0
        assert launched == [want] * 4, (dtype, kernels, launched)
    (loss, got), (loss16, p16), (loss32, p32) = (
        runs["bfloat16", True], runs["bfloat16", False],
        runs["float32", False])
    assert got.keys() == p16.keys() == p32.keys()

    def share(err, bar):
        return err / bar if bar else (0.0 if not err else float("inf"))

    def rel2(a, b):
        return share(float((a - b).norm()), float(b.norm()))

    shares = {"loss": share(abs(loss - loss16), abs(loss16 - loss32))}
    for name in p16:
        assert torch.isfinite(got[name]).all(), name
        shares[name] = share(rel2(got[name], p16[name]),
                             rel2(p16[name], p32[name]))
    print(f"bf16 step, losses {loss!r} (card), {loss16!r} (plain bf16), "
          f"{loss32!r} (plain f32); the card's distance from the plain step "
          f"over the plain step's distance from float32:", shares)
    over = {k: v for k, v in shares.items() if not v <= BF16_STEP_SHARE}
    assert not over, over


def _rel2(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _bf16_conv(cuda, name):
    """A bfloat16 conv layer: ``layer3`` of a full-width config, or
    (``l4``) the hamiltonian trunk's widths, irreps up to l = 4 and sh up
    to l = 3 at 64 channels (two m1 blocks, eight j pairs)."""
    from equivariant_nn_zoo_tpu_torch.nn.message_passing import (
        FactorizedConvolution,
    )
    from equivariant_nn_zoo_tpu_torch.utils import init_parameters

    if name != "l4":
        mc = dict(get_config(name)["model_config"], compute_dtype="bfloat16")
        return build_model(mc, cuda,
                           torch.Generator().manual_seed(0)).layer3.conv
    feats = "+".join(f"64x{l}{p}" for l in range(5) for p in "eo")
    conv = FactorizedConvolution(
        input_features=feats, output_features=feats, node_attrs="4x0e",
        edge_radial="8x0e", edge_spherical="1x0e+1x1o+1x2e+1x3o",
        invariant_layers=2, invariant_neurons=64, avg_num_neighbors=5.0,
        sc_species_types=5, compute_dtype="bfloat16")
    init_parameters(conv, torch.Generator().manual_seed(1))
    return conv.to(cuda)


@pytest.mark.parametrize("name", ["config_energy", "config_dipole", "l4"])
def test_bf16_walks_match_plain_on_a_ragged_batch(cuda, name):
    """The bfloat16 K1 and K2 (``k1_bf16_walk_kernel``,
    ``k2_bf16_walk_kernel``) at full width (``layer3``, and at l = 4)
    against their bfloat16 plain contracts on a ragged batch: 5,001 edges
    (not a multiple of the walk's 16-edge stage), a node with no incoming
    and one with no outgoing edge, and 2,000 padded edges at the dummy
    node, a run walked in pieces each way.  Each output within half of the plain
    contract's own distance from the float32 contract (relative L2: the
    tensor cores sum in another order, which may flip a bfloat16 rounding),
    and every output equal bit for bit over two launches."""
    conv = _bf16_conv(cuda, name)
    fc = conv.full_conv
    N, g = 211, torch.Generator().manual_seed(40)
    src = torch.randint(0, N - 1, (3001,), generator=g)
    dst = torch.randint(0, N - 1, (3001,), generator=g)
    dst[dst == 7], src[src == 9] = 8, 10
    src = torch.cat([src, torch.full((2000,), N - 1)])
    dst = torch.cat([dst, torch.full((2000,), N - 1)])
    perm = torch.randperm(src.shape[0], generator=g)
    src, dst = src[perm].to(cuda), dst[perm].to(cuda)
    E = src.shape[0]
    bf = torch.bfloat16
    x = torch.randn(N, fc.fused.irreps_in.dim, generator=g).to(cuda, bf)
    sh = torch.randn(E, fc.fused.J_dim, generator=g).to(cuda, bf)
    er = torch.randn(E, fc.fc_dims[0], generator=g)
    er[perm >= 3001] = 0.0
    er = er.to(cuda)
    gout = torch.randn(N, fc.out_dim, generator=g).to(cuda, bf)
    with torch.no_grad():
        w16 = [t.detach() for t in fc.flat_weights(conv.fc, conv.tp.linear,
                                                   0.3)]
        fc.compute_dtype = torch.float32
        w32 = [t.detach() for t in fc.flat_weights(conv.fc, conv.tp.linear,
                                                   0.3)]
        fc.compute_dtype = bf
        args = (x, er, sh, src, dst)
        f32_args = (x.float(), er, sh.float(), src, dst)
        out, scratch = full_conv_mod.launch_forward(fc, *args, *w16, N)
        again = full_conv_mod.launch_forward(fc, *args, *w16, N)
        p16, _ = fc.plain_forward_bf16(*args, *w16, N)
        p32, scratch32 = fc.plain_forward(*f32_args, *w32, N)
        got = full_conv_mod.launch_backward(fc, *args, *w16, N, scratch,
                                            gout)
        got2 = full_conv_mod.launch_backward(fc, *args, *w16, N, scratch,
                                             gout)
        q16 = fc.plain_backward_bf16(*args, *w16, N, scratch, gout)
        q32 = fc.plain_backward(*f32_args, *w32, N, scratch32, gout.float())
    torch.cuda.synchronize()
    assert FullConv.bf16_launches and FullConv.bf16_backward_launches
    assert torch.equal(out, again[0]) and torch.equal(scratch, again[1])
    for a, b in zip(got, got2):
        assert torch.equal(a, b)
    checks = [("out", out, p16, p32)] + list(zip(K2_OUT, got, q16, q32))
    for what, a, b, c in checks:
        assert torch.isfinite(a.float()).all(), what
        assert _rel2(a, b) <= 0.5 * _rel2(b, c), (what, _rel2(a, b),
                                                  _rel2(b, c))


EXT_BF16_OUT = {"K4f": ("out",), "K4b": ("dx", "dsh", "dw", "dwsel"),
                "K4g": ("c_x", "c_s", "c_w", "c_m", "c_g")}


def test_bf16_ext_kernels_match_plain_on_a_ragged_batch(cuda):
    """The bfloat16 K4f, K4b (on K4f's saved scratch and recomputed) and
    K4g at full width (``config_energy_force``'s ``layer3``) against their
    bfloat16 plain contracts on a ragged batch: 5,001 edges, a node with no
    incoming and one with no outgoing edge, and 2,000 padded slots at the
    dummy node with unmasked operands (the second-order rule substitutes
    cotangents there).  Each output within half of the plain contract's own
    distance from the float32 contract (relative L2), and every output
    equal bit for bit over two launches."""
    mc = dict(get_config("config_energy_force")["model_config"],
              compute_dtype="bfloat16")
    conv = build_model(mc, cuda, torch.Generator().manual_seed(0)).func.\
        layer3.conv
    fc = conv.full_conv
    N, g = 211, torch.Generator().manual_seed(41)
    src = torch.randint(0, N - 1, (3001,), generator=g)
    dst = torch.randint(0, N - 1, (3001,), generator=g)
    dst[dst == 7], src[src == 9] = 8, 10
    src = torch.cat([src, torch.full((2000,), N - 1)])
    dst = torch.cat([dst, torch.full((2000,), N - 1)])
    perm = torch.randperm(src.shape[0], generator=g)
    src, dst = src[perm].to(cuda), dst[perm].to(cuda)
    E = src.shape[0]
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    x, cx = rnd(N, fc.fused.irreps_in.dim), rnd(N, fc.fused.irreps_in.dim)
    sh, csh = rnd(E, fc.fused.J_dim), rnd(E, fc.fused.J_dim)
    w, cw = rnd(E, fc.fused.weight_numel), rnd(E, fc.fused.weight_numel)
    gout = rnd(N, fc.out_dim)
    with torch.no_grad():
        ws16 = fc.flat_wsel(conv.tp.linear, 0.3)
        fc.compute_dtype = torch.float32
        ws32 = fc.flat_wsel(conv.tp.linear, 0.3)
        fc.compute_dtype = bf
    b16 = [t.to(bf) for t in (x, cx, sh, csh, w, cw, gout)]
    x16, cx16, sh16, csh16, w16, cw16, g16 = b16
    fa = (x16, sh16, w16, ws16, src, dst, N)
    fa32 = (x, sh, w, ws32, src, dst, N)
    ga = (x16, cx16, sh16, csh16, w16, cw16, ws16, src, dst, N, g16)
    ga32 = (x, cx, sh, csh, w, cw, ws32, src, dst, N, gout)
    with torch.no_grad():
        saved = ext_mod.launch_forward(fc, *fa)[1]
        calls = {
            "K4f": (lambda: ext_mod.launch_forward(fc, *fa)[:1],
                    lambda: fc.plain_forward_bf16(*fa)[:1],
                    lambda: (fc.plain_forward(*fa32),), "K4f"),
            "K4b": (lambda: ext_mod.launch_backward(fc, *fa, g16,
                                                    scratch=saved),
                    lambda: fc.plain_backward_bf16(*fa, g16),
                    lambda: fc.plain_backward(*fa32, gout), "K4b"),
            "K4b recomputed": (lambda: ext_mod.launch_backward(fc, *fa, g16),
                               lambda: fc.plain_backward_bf16(*fa, g16),
                               lambda: fc.plain_backward(*fa32, gout),
                               "K4b"),
            "K4g": (lambda: ext_mod.launch_grad2(fc, *ga),
                    lambda: fc.plain_grad2_bf16(*ga),
                    lambda: fc.plain_grad2(*ga32), "K4g"),
        }
        for name, (kern, p16, p32, kind) in calls.items():
            got, again = kern(), kern()
            torch.cuda.synchronize()
            for a, b in zip(got, again):
                assert torch.equal(a, b), name
            for what, a, b, c in zip(EXT_BF16_OUT[kind], got, p16(), p32()):
                assert torch.isfinite(a.float()).all(), (name, what)
                assert _rel2(a, b) <= 0.5 * _rel2(b, c), (
                    name, what, _rel2(a, b), _rel2(b, c))
    assert FullConvExt.bf16_launches_fwd and FullConvExt.bf16_launches_bwd \
        and FullConvExt.bf16_launches_grad2


def test_bf16_force_step_matches_its_plain_version(cuda):
    """One bfloat16 ``config_energy_force`` training step on the card
    through the bfloat16 K4f, K4b and K4g against the same step through
    their bfloat16 plain contracts on the card (``kernels=False``): the loss
    and every gradient within ``BF16_STEP_SHARE`` of the plain step's own
    distance from the float32 plain step (relative L2 per tensor; see
    ``test_bf16_step_matches_its_plain_version``).  N(0, 1) labels: the
    loss is a sum of squared residuals of order 1.  A plain distance below
    ``F32_RESOLUTION`` counts as that: the output bias's gradient (the
    energy term's alone, about 2.9e6) lands one float32 place apart
    between two card runs of the same step (PyTorch's scatter atomics), and
    the plain bf16 and f32 steps may round it alike."""
    cfg = get_config("config_energy_force")
    mc = cfg["model_config"]
    gb = _batch(_fragments(16), cuda)
    n_layers = mc["num_layers"]
    counters = ((FullConvExt, "bf16_launches_fwd"),
                (FullConvExt, "bf16_launches_bwd"),
                (FullConvExt, "bf16_launches_grad2"))
    runs = {}
    for dtype, kernels in (("bfloat16", True), ("bfloat16", False),
                           ("float32", False)):
        model = build_model(dict(mc, compute_dtype=dtype), cuda,
                            torch.Generator().manual_seed(0),
                            kernels=kernels)
        before = [getattr(c, a) for c, a in counters]
        model.zero_grad()
        out = model(gb)
        loss, _ = Loss(cfg["loss_coeffs"])(out.data, gb.data)
        loss.backward()
        runs[dtype, kernels] = (loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        torch.cuda.synchronize()
        launched = [getattr(c, a) - b for (c, a), b in zip(counters, before)]
        # layer 0 pairs (2 K4b + 2 K4f); the others take K4g
        want = [n_layers + 2, 2 * n_layers + 2, n_layers - 1] if kernels \
            else [0, 0, 0]
        assert launched == want, (dtype, kernels, launched)
    (loss, got), (loss16, p16), (loss32, p32) = (
        runs["bfloat16", True], runs["bfloat16", False],
        runs["float32", False])
    assert got.keys() == p16.keys() == p32.keys()

    def share(err, bar):
        return err / max(bar, F32_RESOLUTION)

    shares = {"loss": share(abs(loss - loss16) / abs(loss16),
                            abs(loss16 - loss32) / abs(loss16))}
    for name in p16:
        assert torch.isfinite(got[name]).all(), name
        shares[name] = share(_rel2(got[name], p16[name]),
                             _rel2(p16[name], p32[name]))
    print(f"bf16 force step, losses {loss!r} (card), {loss16!r} (plain "
          f"bf16), {loss32!r} (plain f32); the card's distance from the "
          f"plain step over the plain step's distance from float32:", shares)
    over = {k: v for k, v in shares.items() if not v <= BF16_STEP_SHARE}
    assert not over, over
