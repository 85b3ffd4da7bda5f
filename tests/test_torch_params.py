"""The JAX parameter pytree of full-width ``config_energy`` maps onto the
PyTorch port's parameters name for name and shape for shape."""

import jax
import numpy as np
import pytest
import torch

from equivariant_nn_zoo_tpu.models import get_config as jax_get_config
from equivariant_nn_zoo_tpu.utils import build as jax_build
from equivariant_nn_zoo_tpu_torch.models import build_model, get_config
from equivariant_nn_zoo_tpu_torch.utils import (
    init_parameters,
    load_jax_params,
    params_from_jax,
)


@pytest.fixture(scope="module")
def full_width():
    jparams = jax_build(jax_get_config("config_energy").model_config).init(
        jax.random.PRNGKey(0))
    model = build_model(get_config("config_energy")["model_config"], "cpu")
    return jparams, model


def test_params_from_jax_covers_config_energy(full_width):
    jparams, model = full_width
    state = params_from_jax(jparams)
    leaves = jax.tree_util.tree_leaves(jparams)
    assert len(state) == len(leaves)
    own = dict(model.named_parameters())
    assert sorted(state) == sorted(own)
    for name, value in state.items():
        assert tuple(value.shape) == tuple(own[name].shape), name
    assert sum(v.numel() for v in state.values()) == sum(
        int(np.prod(x.shape)) for x in leaves)
    load_jax_params(model, jparams)
    for name, value in state.items():
        assert torch.equal(own[name].detach(), value), name


def test_load_jax_params_rejects_mismatch(full_width):
    jparams, model = full_width
    missing = dict(jparams)
    missing.pop("layer4")
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    bad = {**jparams, "embedding": {"linear": {
        "b0": np.zeros(3, np.float32),
        "w0_0": np.asarray(jparams["embedding"]["linear"]["w0_0"]),
    }}}
    with pytest.raises(ValueError):
        load_jax_params(model, bad)


def test_seeded_init_is_device_independent():
    """One generator seed gives the same weights whatever the module's
    device or build order, and different seeds differ."""
    mc = get_config("config_energy")["model_config"]
    a = build_model(mc, "cpu", torch.Generator().manual_seed(7))
    b = init_parameters(build_model(mc, "cpu"),
                        torch.Generator().manual_seed(7))
    c = build_model(mc, "cpu", torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layer3.conv.fc.w3"], sc["layer3.conv.fc.w3"])
    assert torch.equal(
        sa["radial_basis.basis.bessel_weights"],
        torch.tensor(np.linspace(1.0, 8.0, 8) * np.pi, dtype=torch.float32))


def test_entry_points_default_to_the_card():
    """``build_model`` and ``GraphBatch.from_batch`` aim at the card unless
    the caller asks for the CPU; without a card the default raises instead
    of running on the CPU."""
    import inspect

    from equivariant_nn_zoo_tpu_torch.data import Batch, Data, GraphBatch

    for fn in (build_model, GraphBatch.from_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    d = {"pos": np.zeros((2, 3)), "species": np.ones((2, 1), np.int64)}
    host = Batch.from_data_list([Data(
        {"pos": ("node", "1x1o"), "species": ("node", "1x0e")}, **d)])
    with pytest.raises((AssertionError, RuntimeError)):
        GraphBatch.from_batch(host, 4, 4, 1)
    with pytest.raises((AssertionError, RuntimeError)):
        build_model(get_config("config_energy")["model_config"])


def _c_entries():
    """``{name: parameter kinds}`` of every ``extern "C"`` entry point in
    ``csrc/``: P for a pointer, F for a float, I for an int."""
    import re

    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import CSRC_DIR

    src = "".join(p.read_text() for p in sorted(CSRC_DIR.glob("*.cu")))
    common = re.search(r"#define EXT_COMMON\s+\\\n((?:.*\\\n)*.*)\n",
                       src).group(1).replace("\\\n", " ")
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(\s*(.*?)\)\s*\{',
                                   src, re.S):
        params = params.replace("EXT_COMMON", common)
        entries[name] = "".join(
            "P" if "*" in p else "F" if p.strip().startswith("float") else "I"
            for p in params.split(",") if p.strip())
    return entries


def test_ctypes_signatures_match_the_c_entries():
    """A pointer passed where ``argtypes`` ends is cut to 32 bits: every C
    entry point has a signature of its own length and kinds."""
    import ctypes

    from equivariant_nn_zoo_tpu_torch.ops.cuda.build import SIGNATURES

    kinds = {ctypes.c_void_p: "P", ctypes.c_float: "F", ctypes.c_int: "I"}
    entries = _c_entries()
    assert set(entries) == set(SIGNATURES)
    for name, want in entries.items():
        assert "".join(kinds[t] for t in SIGNATURES[name]) == want, name
