"""The pairwise expansion (K5, ``ops/cuda/pairwise_tp.py``) on the CPU, at
a small size (8 channels of l <= 2, the specs of
``tests/test_pairwise_kernel.py``, a ragged batch of 41 elements):

- the port's ``TensorProductExpansion.expand`` (the mid-fused lowering, the
  kernel's plain version) against JAX ``tpe.expand`` and against the TPU
  kernel ``PallasPairwiseTP`` in interpret mode (``tile=16``, float32), on
  parameters made by the JAX ``init``; rel-linf 1e-5 (float32, different
  summation orders);
- the ``PairwiseTP`` wrapper on CPU tensors (it takes the plain version);
- the card path (stage 1, the kernel's tables, the mix layout, the chunks
  and the launch counter) with the launch routed to ``plain_forward``, a
  plain PyTorch walk over the kernel's own non-zero tables;
- a call that would need a gradient raises on that path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.nn.pointwise import \
    TensorProductExpansion as JTPE
from equivariant_nn_zoo_tpu.ops.irreps import Irreps
from equivariant_nn_zoo_tpu.ops.pallas.pairwise import PallasPairwiseTP
from equivariant_nn_zoo_tpu_torch.nn.pointwise import \
    TensorProductExpansion as TTPE
from equivariant_nn_zoo_tpu_torch.ops.cuda import pairwise_tp as pairwise_mod
from equivariant_nn_zoo_tpu_torch.ops.cuda.pairwise_tp import PairwiseTP
from equivariant_nn_zoo_tpu_torch.utils.params import load_jax_params

TOL = 1e-5
SPECS = [
    # square case (the Pairwise head: features x features -> features)
    ("8x0e+8x0o+8x1e+8x1o+8x2e+8x2o",) * 3,
    # rectangular right multiplicity (v contracted per path)
    ("8x0e+8x1o+8x2e", "4x0e+4x1o+4x1e", "8x0e+8x1o+8x1e+8x2e"),
]
IDS = ["square", "rectangular"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def make(spec_a, spec_b, spec_o, seed=0, M=41, internal_weight=True):
    """A JAX expansion, its port on the same parameters, and inputs."""
    jtpe = JTPE(spec_a, spec_b, spec_o, "uvu",
                internal_weight=internal_weight)
    params = jtpe.init(jax.random.PRNGKey(seed))
    ttpe = TTPE(spec_a, spec_b, spec_o, "uvu",
                internal_weight=internal_weight)
    load_jax_params(ttpe, params)
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, Irreps(spec_a).dim)).astype(np.float32)
    b = rng.normal(size=(M, Irreps(spec_b).dim)).astype(np.float32)
    return jtpe, params, ttpe, a, b


@pytest.fixture
def routed(monkeypatch):
    """Send ``PairwiseTP`` down its card path with the launch replaced by
    the plain contract; count the launches."""
    calls = []

    def launch(tpk, a, bw, wsel):
        calls.append(a.shape[0])
        return tpk.plain_forward(a, bw, wsel)

    monkeypatch.setattr(PairwiseTP, "forward", PairwiseTP.launch)
    monkeypatch.setattr(pairwise_mod, "launch_forward", launch)
    return calls


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_expand_matches_jax(spec):
    jtpe, params, ttpe, a, b = make(*spec)
    assert ttpe._fuse_plan is not None
    ref = jtpe.expand(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = ttpe.expand(torch.tensor(a), torch.tensor(b))
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_wrapper_matches_interpret_mode_kernel(spec):
    jtpe, params, ttpe, a, b = make(*spec, seed=1)
    kern = PallasPairwiseTP(jtpe, compute_dtype=jnp.float32, tile=16)
    ref = kern(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = PairwiseTP(ttpe)(ttpe, torch.tensor(a), torch.tensor(b))
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_kernel_contract_matches_expand(spec, routed):
    """Stage 1, the non-zero tables, the scratch rows and the mix problems
    reproduce ``expand``."""
    _, _, ttpe, a, b = make(*spec, seed=2)
    tpk = PairwiseTP(ttpe)
    a, b = torch.tensor(a), torch.tensor(b)
    with torch.no_grad():
        got = tpk(ttpe, a, b)
        want = ttpe.expand(a, b)
    assert routed == [41]
    assert _rel(got.numpy(), want.numpy()) < TOL


def test_kernel_tables_sizes():
    """The paths the mix reads, non-zeros fewer than the dense operator,
    one scratch row per (path, component)."""
    _, _, ttpe, _, _ = make(*SPECS[1])
    tpk = PairwiseTP(ttpe)
    tp = ttpe.tp
    reach = [ins for ins in tp.instructions
             if tp.irreps_out[ins.i_out].ir in
             {mo.ir for mo in ttpe.linear.irreps_out}]
    assert 0 < tpk.n_paths == len(reach) <= len(tp.instructions)
    assert tpk.KM == tpk.mul * sum(
        tp.irreps_out[ins.i_out].ir.dim for ins in reach)
    assert tpk.R == sum(tp.irreps_in2[ins.i_in2].ir.dim for ins in reach)
    dense = sum(tp.irreps_in1[i.i_in1].ir.dim * tp.irreps_in2[i.i_in2].ir.dim
                * tp.irreps_out[i.i_out].ir.dim for i in reach)
    assert 0 < tpk.nz_count < dense
    assert tpk.covers_output


def test_launch_runs_in_chunks(routed, monkeypatch):
    _, _, ttpe, a, b = make(*SPECS[0], seed=3)
    monkeypatch.setattr(PairwiseTP, "CHUNK", 16)
    a, b = torch.tensor(a), torch.tensor(b)
    with torch.no_grad():
        got = PairwiseTP(ttpe)(ttpe, a, b)
        want = ttpe.expand(a, b)
    assert routed == [16, 16, 9]
    assert _rel(got.numpy(), want.numpy()) < TOL


def test_one_instance_serves_two_parameter_sets(routed):
    """``tp`` and ``tp_off`` of the head share the tables; the parameters
    are those of the expansion passed at call time."""
    _, _, tpe_a, a, b = make(*SPECS[0], seed=4)
    _, _, tpe_b, _, _ = make(*SPECS[0], seed=5)
    tpk = PairwiseTP(tpe_a)
    a, b = torch.tensor(a), torch.tensor(b)
    with torch.no_grad():
        got = tpk(tpe_b, a, b)
        assert _rel(got.numpy(), tpe_b.expand(a, b).numpy()) < TOL
        assert _rel(got.numpy(), tpe_a.expand(a, b).numpy()) > 1e-2


@pytest.mark.parametrize("needs", ["parameter", "left", "right"])
def test_launch_raises_when_a_gradient_is_needed(routed, needs):
    _, _, ttpe, a, b = make(*SPECS[0], seed=6)
    tpk = PairwiseTP(ttpe)
    ttpe.requires_grad_(needs == "parameter")
    a = torch.tensor(a, requires_grad=needs == "left")
    b = torch.tensor(b, requires_grad=needs == "right")
    with pytest.raises(NotImplementedError, match="no backward"):
        tpk(ttpe, a, b)
    assert routed == []
    with torch.no_grad():
        assert torch.isfinite(tpk(ttpe, a, b)).all()
    assert routed == [41]


def test_rejects_structures_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="uniform left multiplicity"):
        PairwiseTP(TTPE("8x0e+4x1o", "4x0e+4x1o", "8x0e+4x1o", "uvu"))
    with pytest.raises(ValueError, match="internal-weight"):
        PairwiseTP(TTPE("8x0e+8x1o", "1x0e+1x1o", "8x0e+8x1o", "uvu",
                        internal_weight=False))


@pytest.mark.parametrize("internal_weight", [True, False],
                         ids=["internal", "external"])
def test_unfused_expand_matches_jax(internal_weight):
    """Few paths, or external per-element weights: ``tp`` then the mix."""
    spec = ("4x0e+4x1o", "1x0e+1x1o", "4x0e+4x1o")
    jtpe, params, ttpe, a, b = make(*spec, seed=7,
                                    internal_weight=internal_weight)
    if internal_weight:
        assert len(ttpe.tp.instructions) <= 4 and ttpe._fuse_plan is None
        w = wt = None
    else:
        w = np.random.default_rng(8).normal(
            size=(41, ttpe.tp.weight_numel)).astype(np.float32)
        wt = torch.tensor(w)
    ref = jtpe.expand(params, jnp.asarray(a), jnp.asarray(b),
                      None if w is None else jnp.asarray(w))
    with torch.no_grad():
        got = ttpe.expand(torch.tensor(a), torch.tensor(b), wt)
    assert _rel(got.numpy(), ref) < TOL
