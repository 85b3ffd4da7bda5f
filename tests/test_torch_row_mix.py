"""The host side of the tensor-core GEMM of the mix and the backward's
products (``ops/cuda/row_mix.py``, the plan of ``csrc/row_mix.cuh``), on
the CPU in plain PyTorch and numpy:

- the plan of each product kind — its owners (one product per problem,
  per scratch block, per mix matrix), their reduction members and the row
  splits of the weight product — built from the real problem tables of the
  three configs' conv and pairwise kernels at narrow width, and run with
  ``torch.matmul`` in float32, reproduces ``full_conv.mix_rows`` and
  autograd's dS and dwsel of it (rel-linf 1e-5: float32 sums in another
  order), at 0, 1, 63, 65 and 4097 rows;
- every output column, scratch column and mix-matrix entry has exactly one
  owner, and the row splits cover the rows once, in order;
- the 3xTF32 split the kernel computes with (x = hi + lo, each rounded to
  TF32 with ties away from zero), emulated in numpy, keeps a product of
  depth 2176 and 24386 within 1e-6 of float64; one TF32 product does not.
"""

import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.ops.cuda import row_mix as rm
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv import mix_rows
from equivariant_nn_zoo_tpu_torch.utils.utils import build
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5
CONFIGS = ("config_energy", "config_energy_force", "config_hamiltonian")
ROWS = (0, 1, 63, 65, 4097)


def _narrow_tables(name):
    """``(kind, prob_rows, KM, out_dim, wsel_len)`` of every conv and
    pairwise kernel of the config's model, at n_dim 4 and 3 layers."""
    mod = importlib.import_module(f"equivariant_nn_zoo_tpu_torch.models.{name}")
    real = mod.featureModel
    with mock.patch.object(mod, "featureModel", lambda **kw: real(
            **{**kw, "n_dim": 4, "num_layers": 3})):
        model = build(mod.get_config()["model_config"])
    return [(type(m).__name__, m.prob_rows, m.KM, m.out_dim, m.wsel_len)
            for m in model.modules() if hasattr(m, "prob_rows")]


@pytest.fixture(scope="module")
def tables():
    return {name: _narrow_tables(name) for name in CONFIGS}


def test_the_configs_give_the_kernels_their_tables(tables):
    kinds = {name: sorted({t[0] for t in tabs})
             for name, tabs in tables.items()}
    assert kinds == {"config_energy": ["FullConv"],
                     "config_energy_force": ["FullConvExt"],
                     "config_hamiltonian": ["FullConv", "PairwiseTP",
                                            "UVUConv"]}
    strides = {int(s) for tabs in tables.values() for t in tabs
               for s in t[1][:, 5]}
    assert strides == {1, 3, 5, 7, 9}


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_reproduces_mix_rows_and_its_gradients(tables, name, rows):
    rng = np.random.default_rng(rows)
    for kind, pr, KM, out_dim, wsel_len in tables[name]:
        S = torch.tensor(rng.standard_normal((rows, KM)), dtype=torch.float32,
                         requires_grad=True)
        wsel = torch.tensor(rng.standard_normal(wsel_len),
                            dtype=torch.float32, requires_grad=True)
        gout = torch.tensor(rng.standard_normal((rows, out_dim)),
                            dtype=torch.float32)
        out = mix_rows(S, wsel, pr, out_dim)
        if rows:
            dS, dwsel = torch.autograd.grad(out, (S, wsel), gout)
        else:
            dS, dwsel = torch.zeros(0, KM), torch.zeros(wsel_len)
        S, wsel = S.detach(), wsel.detach()
        got = {
            "out": rm.run_plan(rm.FORWARD, pr, rows, KM, out_dim, S=S,
                               wsel=wsel),
            "dS": rm.run_plan(rm.ROWS, pr, rows, KM, out_dim, wsel=wsel,
                              gout=gout),
            "dwsel": rm.run_plan(rm.WEIGHTS, pr, rows, KM, out_dim, S=S,
                                 gout=gout, wsel_len=wsel_len),
        }
        for what, want in (("out", out.detach()), ("dS", dS),
                           ("dwsel", dwsel)):
            assert got[what].shape == want.shape, (kind, what)
            if want.numel():
                assert _rel(got[what], want) <= TOL, (kind, what)
            else:
                assert not got[what].any()


@pytest.mark.parametrize("name", CONFIGS)
def test_every_output_has_exactly_one_owner(tables, name):
    for kind, pr, KM, out_dim, wsel_len in tables[name]:
        rows = 7
        owned = {rm.FORWARD: np.zeros(out_dim, int),
                 rm.ROWS: np.zeros(KM, int),
                 rm.WEIGHTS: np.zeros(wsel_len, int)}
        for which, count in owned.items():
            for launch in rm.plan(pr, which, rows):
                assert len(launch) <= rm.MAX_JOBS
                assert sum(len(j.members) for j in launch) <= rm.MAX_MEMBERS
                for job in launch:
                    a_col, kdim, b_off, wo, c_off, cs = pr[job.members[0]]
                    # the members of a product share its output
                    for q in job.members:
                        if which == rm.ROWS:
                            assert (pr[q][0], pr[q][1]) == (a_col, kdim)
                        if which == rm.WEIGHTS:
                            assert (pr[q][1:4] == (kdim, b_off, wo)).all()
                    if which == rm.FORWARD:
                        assert len(job.members) == 1
                        count[c_off + cs * np.arange(wo)] += 1
                    elif which == rm.ROWS:
                        count[a_col: a_col + kdim] += 1
                    else:
                        count[b_off: b_off + kdim * wo] += 1
            assert (count == 1).all(), (kind, which)
        # every problem is a member of exactly one product of each kind
        for which in owned:
            members = sorted(q for launch in rm.plan(pr, which, rows)
                             for job in launch for q in job.members)
            assert members == list(range(len(pr))), (kind, which)


@pytest.mark.parametrize("rows", ROWS)
def test_row_splits_cover_the_rows_once_in_order(tables, rows):
    _, pr, KM, out_dim, wsel_len = tables["config_hamiltonian"][-1]
    for launch in rm.plan(pr, rm.WEIGHTS, rows):
        chunks = rm.split_rows(launch, rows)
        assert chunks[0].start == 0 and chunks[-1].stop == rows
        for a, b in zip(chunks, chunks[1:]):
            assert a.stop == b.start
        for ch in chunks[:-1]:
            assert len(ch) % rm.DEPTH == 0 and len(ch) >= rm.MIN_SPLIT_ROWS
        mn = sum(j.M * j.N for j in launch)
        assert len(chunks) * mn <= rm.WORKSPACE_FLOATS
        if len(chunks) > 1:
            assert rm.tiles(launch) * (len(chunks) - 1) < rm.TARGET_BLOCKS


# ------------------------------------------------------------------ 3xTF32

def _tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna):
    the low 13 mantissa bits rounded off."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_products(a, b):
    """``(3xTF32, 1xTF32)`` products of float32 a [M, K] and b [K, N], as the
    kernel's MMAs form them: TF32 operands, exact products, float32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    return three, a_hi @ b_hi


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                  -(1 + 2.0 ** -11), 1 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                     -(1 + 2.0 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    r = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32(r)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(hi - r) <= np.abs(r) * 2.0 ** -11).all()


@pytest.mark.parametrize("K", [2176, 24386])
def test_three_tf32_products_hold_float32_accuracy(K):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    b = rng.standard_normal((K, 64)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three, one = _split_products(a, b)
    scale = np.abs(exact).max()
    rel3 = np.abs(three - exact).max() / scale
    rel1 = np.abs(one - exact).max() / scale
    print(f"K={K}: 3xTF32 rel-linf {rel3:.2e}, 1xTF32 {rel1:.2e}")
    assert rel3 <= 1e-6
    # one TF32 product keeps ~3 digits: far outside the kernels' 1e-4 gate
    assert rel1 > 1e-4
