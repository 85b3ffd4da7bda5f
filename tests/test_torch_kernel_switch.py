"""``models.build_model(..., kernels=False)`` on the CPU: the switch that
runs a whole model through its kernels' plain versions on the card
(``ops.cuda.build.KernelSwitch``).

- The option reaches every module that holds a kernel wrapper (K1/K2's
  ``FullConv``, K3/K3b's ``SpeciesScalarFCTP``, the K4 family's
  ``FullConvExt``, K6/K6b's ``UVUConv``, the K5 family's ``PairwiseTP``;
  the mix GEMM runs inside their C entries), and
  ``E3Calculator.from_config`` passes it through.
- With the tensors taken for the card's (``uses_kernel`` stubbed to read
  the option alone), one training step's forward and backward of a model
  built with ``kernels=False`` reaches no wrapper's ``launch``, and one
  built with the default reaches every wrapper it holds (each launch
  stubbed to count and run the plain version), with equal loss and
  gradients: a narrow hamiltonian model (K1, K3, K5, K6; l_max 2, the
  sum of squares of its matrix blocks as the loss) and the narrow force
  model (K4).
- On the CPU the plain versions run whatever the option says.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu_torch.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo_tpu_torch.examples.calculator import E3Calculator
from equivariant_nn_zoo_tpu_torch.models import build_model
from equivariant_nn_zoo_tpu_torch.models import layer_configs as tlc
from equivariant_nn_zoo_tpu_torch.ops.cuda import (
    FullConv,
    PairwiseTP,
    SpeciesScalarFCTP,
    UVUConv,
)
from equivariant_nn_zoo_tpu_torch.ops.cuda.build import KernelSwitch
from equivariant_nn_zoo_tpu_torch.ops.cuda.full_conv_ext import FullConvExt
from equivariant_nn_zoo_tpu_torch.run import Loss
from test_torch_edge_order import torch_threads_per_worker
from test_torch_hamiltonian import _molecules, _port_batch

torch_threads_per_worker()

WRAPPERS = (FullConv, FullConvExt, SpeciesScalarFCTP, UVUConv, PairwiseTP)
# tests/test_torch_examples.py's narrow model
TINY = dict(n_dim=8, l_max=2, edge_spherical="1x0e+1x1o+1x2e",
            node_attrs="4x0e", edge_radial="4x0e", num_types=10,
            num_layers=2, r_max=4.0)
FORCE_ATTRS = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
               "atom_types": ("node", "1x0e"), "energy": ("graph", "1x0e"),
               "forces": ("node", "1x1o")}
FORCE_LOSS = {"energy": [1.0, "MSELoss"], "forces": [1.0, "MSELoss"]}
# the fewest layers whose features reach every irrep the head reads
HAMILTONIAN = dict(n_dim=4, l_max=2, edge_spherical="1x0e+1x1o+1x2e",
                   node_attrs="8x0e", edge_radial="8x0e", num_types=9,
                   num_layers=3, r_max=4.0)


def switches(model):
    return [m for m in model.modules() if isinstance(m, KernelSwitch)]


def hamiltonian_config():
    return tlc.addMatrixOutput(tlc.featureModel(**HAMILTONIAN),
                               "1x0e+1x1o", "1x0e+1x1o")


def hamiltonian_loss(out, gb):
    blocks = [out["hamiltonian_diagonal"], out["hamiltonian_off"]]
    return sum(t.square().sum() for b in blocks for t in b.values())


def force_loss(out, gb):
    return Loss(FORCE_LOSS)(out.data, gb.data)[0]


def force_config():
    return tlc.addForceOutput(tlc.addEnergyOutput(
        tlc.featureModel(**TINY), shifts=[0.0] * 10, output_key="energy"))


def force_batch(seed=0, n_mol=3):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(4, 8))
        d = {"pos": rng.normal(size=(n, 3)) * 1.2,
             "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
             "energy": rng.normal(size=(1, 1)),
             "forces": rng.normal(size=(n, 3))}
        d["atom_types"] = d["species"]
        out, attrs = computeEdgeIndex(d, dict(FORCE_ATTRS), r_max=4.0)
        d.update(out)
        mols.append(Data(attrs, **d))
    return GraphBatch.from_batch(Batch.from_data_list(mols), 32, 128,
                                 n_mol + 1, "cpu")


CASES = {
    "hamiltonian": (hamiltonian_config, lambda: _port_batch(_molecules()),
                    hamiltonian_loss,
                    {"FullConv", "SpeciesScalarFCTP", "UVUConv",
                     "PairwiseTP"}),
    "force": (force_config, force_batch, force_loss, {"FullConvExt"}),
}


def step(model, gb, loss_fn):
    model.zero_grad()
    loss = loss_fn(model(gb), gb)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}


@pytest.fixture
def on_card(monkeypatch):
    """Every wrapper takes its tensors for the card's, so that the option
    alone picks the path; each ``launch`` counts and runs the plain
    version in its place."""
    launched = Counter()

    def stub(cls):
        def launch(self, *args):
            launched[cls.__name__] += 1
            self.kernels = False
            try:
                return self.forward(*args)
            finally:
                self.kernels = True
        return launch

    monkeypatch.setattr(KernelSwitch, "uses_kernel",
                        lambda self, x: self.kernels)
    for cls in WRAPPERS:
        monkeypatch.setattr(cls, "launch", stub(cls))
    return launched


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_wrapper_sees_the_option(case, on_card):
    config, batch, loss_fn, held = CASES[case]
    gb = batch()
    runs = {}
    for kernels in (False, True):
        model = build_model(config(), "cpu",
                            torch.Generator().manual_seed(0),
                            kernels=kernels)
        assert {type(m).__name__ for m in switches(model)} == held
        assert all(m.kernels is kernels for m in switches(model))
        on_card.clear()
        runs[kernels] = step(model, gb, loss_fn)
        if kernels:
            assert set(on_card) == held, on_card
        else:
            assert not on_card, on_card
    (loss_off, grads_off), (loss_on, grads_on) = runs[False], runs[True]
    assert torch.equal(loss_off, loss_on)
    assert grads_off.keys() == grads_on.keys()
    for name, g in grads_off.items():
        assert torch.equal(g, grads_on[name]), name


def test_the_cpu_runs_the_plain_versions_either_way():
    """Unstubbed, no wrapper of a CPU model launches, whatever the option;
    a tensor on any other device asks for the kernel unless the option is
    off."""
    model = build_model(force_config(), "cpu", kernels=True)
    (module,) = {type(m): m for m in switches(model)}.values()
    cpu = torch.zeros(1)
    meta = torch.zeros(1, device="meta")
    assert not module.uses_kernel(cpu)
    assert module.uses_kernel(meta)
    module.kernels = False
    assert not module.uses_kernel(cpu) and not module.uses_kernel(meta)


def test_calculator_passes_the_option_through():
    for kernels in (False, True):
        calc = E3Calculator.from_config("config_energy", device="cpu",
                                        kernels=kernels, capture=False)
        found = switches(calc.model)
        assert {type(m).__name__ for m in found} == {"FullConv",
                                                    "SpeciesScalarFCTP"}
        assert all(m.kernels is kernels for m in found)
