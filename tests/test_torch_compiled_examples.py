"""The calculator, the MD block and the constrained-SDE step compiled
(``run.capture``), on the CPU through ``test_torch_capture``'s stand-in
for ``torch.cuda.CUDAGraph`` (``captured``: the function runs again on the
static inputs at each replay):

- ``E3Calculator.potential`` is one ``Step`` per node capacity: two
  different position sets, each after the capture, equal the eager
  calculator's energy and forces bit for bit;
- ``run_md``'s block of ``steps_per_block`` steps is one ``Step`` whose
  state (positions, velocities, forces, energy, largest pair count) stays
  in its static buffers: ten steps in blocks of one and of two equal the
  eager run bit for bit, the graph replayed once a block;
- one step of ``constrained_sde.sample`` is one ``Step`` with the time
  copied in and the noise generator registered: equal to the eager
  sampler bit for bit;
- the pair count is checked on the host after the call, never inside it:
  ``compute`` and ``run_md`` raise when the radius graph outgrows the edge
  capacity, eager and captured, ``run_md`` also after a replayed block.
"""

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.examples import calculator as tcalc
from equivariant_nn_zoo_tpu_torch.examples import constrained_sde as tsde
from equivariant_nn_zoo_tpu_torch.examples import md_dynamics as tmd
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.run.sde_utils import VPSDE, Noise
from test_torch_capture import captured  # noqa: F401  (a fixture)
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

# tests/test_torch_examples.py's narrow model and capacities
TINY = dict(n_dim=8, l_max=2, edge_spherical="1x0e+1x1o+1x2e",
            node_attrs="4x0e", edge_radial="4x0e", num_types=10,
            num_layers=2, r_max=4.0)
N_CAP, E_CAP = 32, 512


def calculator(capture=None, edge_capacity=E_CAP):
    model = build_model(tlc.addEnergyOutput(tlc.featureModel(**TINY),
                                            shifts=[0.0] * 10), "cpu",
                        torch.Generator().manual_seed(0))
    return tcalc.E3Calculator(model, 4.0, edge_capacity=edge_capacity,
                              node_capacity=N_CAP, device="cpu",
                              capture=capture)


def molecule(seed=0, n=8):
    rng = np.random.default_rng(seed)
    Z = rng.choice([1, 6, 8], size=n, p=[0.5, 0.3, 0.2])
    return Z, rng.normal(size=(n, 3)) * 2.0


def only_step(made, name):
    (step,) = [s for s in made if s.name == name]
    return step


def test_captured_calculator_equals_eager(captured):
    eager, calc = calculator(False), calculator()
    Z, a = molecule(0)
    _, b = molecule(1)
    for i, pos in enumerate([a, a, a, b, a]):
        e_want, f_want = eager.compute(Z, pos)
        e_got, f_got = calc.compute(Z, pos)
        assert e_got == e_want, i
        np.testing.assert_array_equal(f_got, f_want)
    step = only_step(captured, "calculator")
    assert step.captures == 1 and len(step.graphs) == 1
    (entry,) = step.graphs.values()
    assert entry.graph.replays == 3           # the capture's own, then 2
    assert eager.compute(Z, a)[0] != eager.compute(Z, b)[0]


@pytest.mark.parametrize("steps_per_block", [1, 2])
def test_captured_md_equals_eager(captured, steps_per_block):
    Z, pos = molecule(2)
    kw = dict(dt_fs=0.05, n_steps=10, T=100.0, seed=0,
              steps_per_block=steps_per_block, log=None)
    calc = calculator()
    want = tmd.run_md(calc, Z, pos, capture=False, **kw)
    got = tmd.run_md(calc, Z, pos, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].shape == (10 // steps_per_block + 1, 2)
    step = only_step(captured, "md_block")
    assert step.captures == 1
    (entry,) = step.graphs.values()
    assert entry.graph.replays == 10 // steps_per_block - 2


def test_captured_constrained_sde_equals_eager(captured):
    model = build_model(get_config("config_diffusion")["model_config"],
                        "cpu").eval()
    sde = VPSDE(dict(get_config("config_diffusion")["diffusion_keys"]),
                N=100)
    out = [tsde.sample(model, sde, tsde.system("cpu"), Noise("cpu", 2),
                       steps=5, capture=c)["pos"] for c in (False, None)]
    assert torch.isfinite(out[0]).all()
    assert torch.equal(out[0], out[1])
    step = only_step(captured, "constrained_sde")
    assert step.captures == 1
    (entry,) = step.graphs.values()
    assert entry.graph.replays == 5 - 2
    assert entry.graph.generators == []      # a CPU generator: none


@pytest.mark.parametrize("mode", ["eager", "captured"])
def test_pairs_past_the_capacity_raise(captured, mode):
    """A graph of more pairs than the edge capacity raises in ``compute``
    and at the start of ``run_md``; the pair count comes back from the
    device and is read after the call."""
    c = False if mode == "eager" else None
    calc = calculator(c, edge_capacity=8)
    Z, pos = molecule()
    for _ in range(3):                  # past the warm-up, into a replay
        with pytest.raises(RuntimeError, match="edge capacity"):
            calc.compute(Z, pos)
    with pytest.raises(RuntimeError, match="edge capacity"):
        tmd.run_md(calc, Z, pos, n_steps=4, steps_per_block=1, log=None,
                   capture=c)


@pytest.mark.parametrize("mode", ["eager", "captured"])
def test_md_checks_the_largest_pair_count_of_each_block(captured,
                                                        monkeypatch, mode):
    """The block keeps the largest pair count on the device, and the host
    holds it to the capacity after each block: with a count that grows
    by one an evaluation past a capacity of 5, the block of the sixth
    evaluation raises (in the captured run, a replay)."""
    calc = calculator()
    calc.edge_capacity = 5
    count = torch.zeros((), dtype=torch.int64)
    real = calc.energy_forces

    def growing(*args):
        e, f, _ = real(*args)
        count.add_(1)
        return e, f, count.clone()

    monkeypatch.setattr(calc, "energy_forces", growing)
    Z, pos = molecule()
    with pytest.raises(RuntimeError, match="6 pairs .* edge capacity 5"):
        tmd.run_md(calc, Z, pos, dt_fs=0.05, n_steps=8, steps_per_block=1,
                   log=None, capture=False if mode == "eager" else None)
    if mode == "captured":
        step = only_step(captured, "md_block")
        (entry,) = step.graphs.values()
        assert step.captures == 1 and entry.graph.replays == 3
