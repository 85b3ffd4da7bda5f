"""The pairwise expansion (K5 and its backward K5m, K5a, K5b,
``ops/cuda/pairwise_tp.py``) on the CPU, at a small size (8 channels of l <= 2, the specs of
``tests/test_pairwise_kernel.py``, a ragged batch of 41 elements):

- the port's ``TensorProductExpansion.expand`` (the mid-fused lowering, the
  kernel's plain version) against JAX ``tpe.expand`` and against the TPU
  kernel ``PallasPairwiseTP`` in interpret mode (``tile=16``, float32), on
  parameters made by the JAX ``init``; rel-linf 1e-5 (float32, different
  summation orders);
- the ``PairwiseTP`` wrapper on CPU tensors (it takes the plain version);
- the card path (stage 1, the kernel's tables, the mix layout, the chunks
  and the launch counters) with the launches routed to ``plain_forward``, a
  plain PyTorch walk over the kernel's own non-zero tables, and
  ``plain_backward``;
- gradients: ``d left``, ``d right``, ``d tp.weight`` and ``d linear``
  through ``PairwiseTPFunction`` (routed) against the VJPs of the TPU
  kernel in interpret mode (as ``tests/test_pairwise_kernel.py``
  differentiates it) at rel-linf 2e-4 and against JAX ``expand`` at 1e-4;
  ``plain_backward`` (``d left``, ``dbw``, ``dwsel``) against autograd of
  ``expand``; ``dwsel`` summed over chunks; the backward's left-irrep table
  walked as the K5a kernel walks it.
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
from equivariant_nn_zoo_tpu_torch.utils.params import (
    load_jax_params,
    params_from_jax,
)

TOL = 1e-5
GRAD_TOL = 1e-4        # gradients: longer sums, other orders
INTERPRET_TOL = 2e-4   # against the interpret-mode kernels' own VJPs
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
    """Send ``PairwiseTP`` down its card path with the launches replaced by
    the plain contracts.  The returned list holds the element count of
    every forward launch; its ``backward`` attribute holds those of the
    backward launches."""

    class Calls(list):
        pass

    calls = Calls()
    calls.backward = []

    def launch(tpk, a, bw, wsel):
        calls.append(a.shape[0])
        return tpk.plain_forward(a, bw, wsel)

    def launch_backward(tpk, *args):
        calls.backward.append(args[0].shape[0])
        return tpk.plain_backward(*args)

    monkeypatch.setattr(PairwiseTP, "forward", PairwiseTP.launch)
    monkeypatch.setattr(pairwise_mod, "launch_forward", launch)
    monkeypatch.setattr(pairwise_mod, "launch_backward", launch_backward)
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
    # every output column belongs to a mix problem
    cols = {c_off + cs * w for _, _, _, wo, c_off, cs in tpk.prob_rows
            for w in range(wo)}
    assert cols == set(range(tpk.out_dim))


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


def _cos_loss_np(shape):
    return np.cos(np.arange(int(np.prod(shape)))).reshape(shape).astype(
        np.float32)


def _port_grads(fn, ttpe, a, b):
    """Gradients of ``sum(fn(a, b) * cos(arange))`` with respect to left,
    right and every parameter of the expansion, by name."""
    a = torch.tensor(a, requires_grad=True)
    b = torch.tensor(b, requires_grad=True)
    out = fn(a, b)
    named = dict(ttpe.named_parameters())
    grads = torch.autograd.grad(out, [a, b, *named.values()],
                                torch.tensor(_cos_loss_np(out.shape)))
    return dict(zip(("left", "right", *named), (g.numpy() for g in grads)))


def _jax_grads(fn, params, a, b):
    def loss(p, a_, b_):
        o = fn(p, a_, b_)
        return jnp.sum(o * jnp.cos(jnp.arange(o.size).reshape(o.shape)))

    gp, ga, gb = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(a), jnp.asarray(b))
    out = {k: v.numpy() for k, v in
           params_from_jax(jax.device_get(gp)).items()}
    out.update(left=np.asarray(ga), right=np.asarray(gb))
    return out


@pytest.mark.parametrize("ref_kind", ["interpret_kernel", "expand"])
@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_gradients_match_jax(spec, ref_kind, routed):
    """Every gradient leg through the routed ``PairwiseTPFunction``:
    against the TPU kernel's three backward passes in interpret mode, and
    against JAX ``expand``."""
    jtpe, params, ttpe, a, b = make(*spec, seed=1)
    if ref_kind == "interpret_kernel":
        ref_fn = PallasPairwiseTP(jtpe, compute_dtype=jnp.float32, tile=16)
        tol = INTERPRET_TOL
    else:
        ref_fn, tol = jtpe.expand, GRAD_TOL
    want = _jax_grads(ref_fn, params, a, b)
    tpk = PairwiseTP(ttpe)
    got = _port_grads(lambda a_, b_: tpk(ttpe, a_, b_), ttpe, a, b)
    assert routed == [41] and routed.backward == [41]
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name], want[name]) < tol, name


@pytest.mark.parametrize("needs", ["parameter", "left", "right"])
def test_routed_function_gradients_match_plain(routed, needs):
    """Whatever asks for a gradient, the card path goes through
    ``PairwiseTPFunction`` (one K5, one backward launch) and returns
    autograd's gradient of ``expand``; without grad mode it launches K5
    alone."""
    _, _, ttpe, a, b = make(*SPECS[0], seed=6)
    tpk = PairwiseTP(ttpe)

    def grads(fn):
        ttpe.requires_grad_(needs == "parameter")
        a_ = torch.tensor(a, requires_grad=needs == "left")
        b_ = torch.tensor(b, requires_grad=needs == "right")
        out = fn(a_, b_)
        wanted = [t for t in (a_, b_, *ttpe.parameters()) if t.requires_grad]
        return torch.autograd.grad(
            out, wanted, torch.tensor(_cos_loss_np(out.shape)))

    got = grads(lambda a_, b_: tpk(ttpe, a_, b_))
    assert routed == [41] and routed.backward == [41]
    want = grads(ttpe.expand)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < GRAD_TOL
    with torch.no_grad():
        assert torch.isfinite(tpk(ttpe, torch.tensor(a),
                                  torch.tensor(b))).all()
    assert routed == [41, 41] and routed.backward == [41]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_plain_backward_matches_autograd_of_expand(spec):
    """The backward kernels' plain contract on ``(left, bw, wsel)``,
    carried through stage 1 and ``flat_wsel`` by autograd, against autograd
    of ``expand``."""
    _, _, ttpe, a, b = make(*spec, seed=8)
    tpk = PairwiseTP(ttpe)
    want = _port_grads(ttpe.expand, ttpe, a, b)
    a_ = torch.tensor(a)
    b_ = torch.tensor(b, requires_grad=True)
    bw = tpk.weighted_right(ttpe.tp.weight, b_)
    wsel = tpk.flat_wsel(ttpe.linear)
    gout = torch.tensor(_cos_loss_np((41, tpk.out_dim)))
    da, dbw, dwsel = tpk.plain_backward(a_, bw, wsel, gout)
    assert da.shape == a_.shape and dbw.shape == (41, tpk.R, tpk.mul)
    assert dwsel.shape == (tpk.wsel_len,)
    named = dict(ttpe.named_parameters())
    rest = torch.autograd.grad([bw, wsel], [b_, *named.values()],
                               [dbw, dwsel], allow_unused=True)
    got = dict(zip(("right", *named), rest), left=da)
    for name, w in want.items():
        assert got[name] is not None, name
        assert _rel(got[name].numpy(), w) < GRAD_TOL, name


def test_backward_runs_in_chunks_and_sums_dwsel(routed, monkeypatch):
    """Each chunk is one forward and one backward launch; the chunks'
    ``dwsel`` and ``d tp.weight`` add up to the unchunked gradients."""
    _, _, ttpe, a, b = make(*SPECS[0], seed=3)
    tpk = PairwiseTP(ttpe)
    whole = _port_grads(lambda a_, b_: tpk(ttpe, a_, b_), ttpe, a, b)
    assert routed == [41] and routed.backward == [41]
    monkeypatch.setattr(PairwiseTP, "CHUNK", 16)
    chunked = _port_grads(lambda a_, b_: tpk(ttpe, a_, b_), ttpe, a, b)
    assert routed == [41, 16, 16, 9]
    assert sorted(routed.backward) == [9, 16, 16, 41]
    for name, w in whole.items():
        assert _rel(chunked[name], w) < TOL, name


def test_backward_tables_reproduce_d_left():
    """The left-irrep table of the backward (one block row per left irrep,
    summing over that irrep's paths, as the K5a kernel walks it) gives
    ``d left`` of the plain contract: every path sits in exactly one
    irrep's list, and the irreps tile the left columns."""
    _, _, ttpe, a, b = make(*SPECS[1], seed=9)
    tpk = PairwiseTP(ttpe)
    M, mul = a.shape[0], tpk.mul
    with torch.no_grad():
        bw = tpk.weighted_right(ttpe.tp.weight, torch.tensor(b))
        wsel = tpk.flat_wsel(ttpe.linear)
    gout = torch.tensor(_cos_loss_np((M, tpk.out_dim)))
    want, _, _ = tpk.plain_backward(torch.tensor(a), bw, wsel, gout)
    # dS = mix backward, per problem
    dS = np.zeros((M, tpk.KM), np.float32)
    for a_col, kdim, b_off, wo, c_off, c_stride in tpk.prob_rows:
        W = wsel[b_off: b_off + kdim * wo].reshape(kdim, wo).numpy()
        dS[:, a_col: a_col + kdim] += \
            gout[:, c_off: c_off + wo * c_stride: c_stride].numpy() @ W.T
    dS = dS.reshape(M, -1, mul)
    slots = tpk.slot_table.numpy().reshape(-1, 4)
    slot_paths = tpk.slot_paths.numpy()
    assert sorted(slot_paths) == list(range(tpk.n_paths))
    assert sum(d1 * mul for _, d1, _, _ in slots) == tpk.irreps_a.dim
    got = np.zeros_like(a)
    nz_c = tpk.nz_c.numpy()
    for x_off, d1, k0, k1 in slots:
        dal = np.zeros((M, mul, d1), np.float32)
        for p in slot_paths[k0:k1]:
            px, pd1, r0, _, row_base, row_stride, _, nz0, nz1 = \
                tpk.path_rows[p]
            assert (px, pd1) == (x_off, d1)
            for z in range(nz0, nz1):
                code = int(tpk.nz_codes[z])
                m1, m2, m3 = code & 0xff, (code >> 8) & 0xff, code >> 16
                dal[:, :, m1] += nz_c[z] * dS[:, row_base + m3 * row_stride] \
                    * bw[:, r0 + m2].numpy()
        got[:, x_off: x_off + mul * d1] = dal.reshape(M, -1)
    assert _rel(got, want.numpy()) < GRAD_TOL


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
