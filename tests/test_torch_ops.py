"""Op-level parity of the PyTorch port against the JAX package (CPU, f32).

The same numpy inputs and parameters go through the JAX op and its port;
outputs agree to rel-linf 1e-5 of the reference (both float32; the ops sum
in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu import nn as jnn
from equivariant_nn_zoo_tpu import ops as jops
from equivariant_nn_zoo_tpu_torch import nn as tnn
from equivariant_nn_zoo_tpu_torch import ops as tops
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _np_params(specs, rng):
    """numpy parameters for a JAX op's param_specs (random, so that zero
    or constant initialisations do not hide a mapping error)."""
    return {name: rng.normal(size=shape).astype(np.float32)
            for name, (shape, _) in specs.items()}


def _load(module, params):
    module.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return module


def case_spherical_harmonics(rng):
    x = rng.normal(size=(40, 3)).astype(np.float32)
    ref = jops.spherical_harmonics([0, 1, 2, 3], jnp.asarray(x))
    got = tops.spherical_harmonics([0, 1, 2, 3], torch.tensor(x))
    return got, ref


def case_bessel_basis(rng):
    kw = dict(r_max=4.0, trainable=True, irreps_out=("8x0e", "edge_radial"),
              irreps_in=("1x0e", "edge_length"))
    length = rng.uniform(0.05, 4.5, size=(64, 1)).astype(np.float32)
    jmod = jnn.RadialBasisEncoding(**kw)
    freqs = (np.linspace(1, 8, 8) * np.pi
             + rng.normal(size=8) * 0.1).astype(np.float32)
    ref, _ = jmod.apply({"basis": {"bessel_weights": jnp.asarray(freqs)}},
                        {"input": jnp.asarray(length)},
                        {"input": ("edge", "1x0e")})
    tmod = tnn.RadialBasisEncoding(**kw)
    _load(tmod, {"basis.bessel_weights": freqs})
    got, _ = tmod({"input": torch.tensor(length)},
                  {"input": ("edge", "1x0e")})
    return got["radial_embedding"], ref["radial_embedding"]


def case_linear(rng):
    irreps_in, irreps_out = "8x0e+8x1o+4x2e+3x0e", "6x0e+5x1o+3x2e+2x0e"
    jlin = jops.Linear(irreps_in, irreps_out, biases=True)
    params = _np_params(jlin.param_specs(), rng)
    x = rng.normal(size=(16, jops.Irreps(irreps_in).dim)).astype(np.float32)
    ref = jlin.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    tlin = _load(tops.Linear(irreps_in, irreps_out, biases=True), params)
    return tlin(torch.tensor(x)), ref


def case_gate(rng):
    kw = dict(irreps_scalars="8x0e+4x0o", act_scalars=["silu", "tanhlu"],
              irreps_gates="3x0e+2x0e", act_gates=["silu", "silu"],
              irreps_gated="3x1o+2x2e")
    x = rng.normal(size=(16, 8 + 4 + 5 + 9 + 10)).astype(np.float32)
    ref = jops.Gate(**kw)(jnp.asarray(x))
    got = tops.Gate(**kw)(torch.tensor(x))
    return got, ref


def case_fully_connected_net(rng):
    dims = [8, 16, 16, 24]
    jnet = jnn.FullyConnectedNet(dims, jops.activations["ssp"])
    params = _np_params(jnet.param_specs(), rng)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    ref = jnet.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x), compute_dtype="float32")
    tnet = _load(tnn.FullyConnectedNet(dims, tops.activations["ssp"]),
                 params)
    return tnet(torch.tensor(x)), ref


def case_fully_connected_tp(rng):
    ir1, ir2, iro = "8x0e+8x1o+8x2e", "2x0e+1x1o", "4x0e+6x1o+5x2e+3x1e"
    jtp = jops.fully_connected_tp(ir1, ir2, iro)
    params = _np_params(jtp.param_specs(), rng)
    x1 = rng.normal(size=(12, jops.Irreps(ir1).dim)).astype(np.float32)
    x2 = rng.normal(size=(12, jops.Irreps(ir2).dim)).astype(np.float32)
    ref = jtp.apply({k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(x1), jnp.asarray(x2))
    ttp = _load(tops.fully_connected_tp(ir1, ir2, iro), params)
    return ttp(torch.tensor(x1), torch.tensor(x2)), ref


CASES = {
    "spherical_harmonics": case_spherical_harmonics,
    "bessel_basis": case_bessel_basis,
    "linear": case_linear,
    "gate": case_gate,
    "fully_connected_net": case_fully_connected_net,
    "fully_connected_tp": case_fully_connected_tp,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    got, ref = CASES[name](np.random.default_rng(0))
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, (name, _rel(got, ref))


def test_activation_normalization_matches_jax():
    """normalize2mom constants agree, so every gate and MLP activation has
    the JAX package's scale."""
    for act in ("ssp", "silu", "tanhlu"):
        x = np.linspace(-4, 4, 101).astype(np.float32)
        ref = np.asarray(jops.normalize2mom(act)(jnp.asarray(x)))
        got = tops.normalize2mom(act)(torch.tensor(x)).numpy()
        assert _rel(got, ref) <= TOL, act


def test_sh_equivariance():
    """Y(R x) = D(R) Y(x) with the port's own Wigner matrices."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10, 3))
    R = tops.rand_matrix(rng)
    D = tops.irreps_d("1x0e+1x1o+1x2e+1x3o", R)
    y = tops.spherical_harmonics([0, 1, 2, 3],
                                 torch.tensor(x, dtype=torch.float32))
    y_rot = tops.spherical_harmonics(
        [0, 1, 2, 3], torch.tensor(x @ R.T, dtype=torch.float32))
    assert _rel(y_rot.numpy(), y.numpy() @ D.T) <= TOL
