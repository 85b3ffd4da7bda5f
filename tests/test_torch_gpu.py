"""On-card checks of the port's CUDA kernels against their plain PyTorch
versions, at full ``config_energy`` width.

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
from equivariant_nn_zoo_tpu_torch.ops.cuda import FullConv, SpeciesScalarFCTP

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model_and_batch(cuda):
    model = build_model(get_config("config_energy")["model_config"], cuda,
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mols = []
    for _ in range(16):
        n = int(rng.integers(8, 24))
        d = {"pos": rng.normal(size=(n, 3)) * 1.4,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1))}
        d["atom_types"] = d["species"]
        attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
                 "atom_types": ("node", "1x0e")}
        out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    host = Batch.from_data_list(mols)
    gb = GraphBatch.from_batch(host, int(host["_n_nodes"].sum()) + 1,
                               int(host["_n_edges"].sum()) + 64, 16, cuda)
    return model, gb


def _layer3_inputs(model, gb):
    """The data dict as it reaches layer3's convolution."""
    seen = {}
    hook = model.layer3.conv.register_forward_pre_hook(
        lambda mod, args: seen.update(data=args[0]))
    with torch.inference_mode():
        model(gb)
    hook.remove()
    return seen["data"]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


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


def _small_conv(cuda, n_dim):
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
        sc_species_types=5)
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
