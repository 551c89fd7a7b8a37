"""The port's engine API (upside_md_torch/engine.py) and System parameter
derivatives against the JAX package's `Upside` on the same specs.

Two trp-cage bundles, float64 on the CPU, perturbed positions from a numpy
seed:

* no env: built here by tools/export_torch_bundle.py without the
  environment chain (as build_full_system builds a system without an
  environment library), so the port's fused block runs without its env
  band and differentiates through the plain K3;
* env: the committed bundle, with the burial coupling's spline offset
  moved to -4 in both packages so that the coverages fall on the
  coupling spline's sloped part (with the synthetic library's offset 0
  they sit on its clamped flat start and every burial gradient is 0).

The JAX package evaluates its XLA formulation on the CPU.  Energy rel
1e-4, forces and sensitivities as RMS relative error 1e-4, and each
node's get_param_deriv at rel 1e-4 of its largest entry: the rotamer
table, both coverage tables, the hbond energy and (env bundle) the
environment table.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import TRP, jax_params64, jax_specs
from upside_md_tpu.engine import Upside as JUpside
from upside_md_tpu.system import System as JSystem
from upside_md_torch.config import bundle
from upside_md_torch.engine import Upside, _flatten_node_params
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DERIV_NODES = {
    "noenv": ("rotamer", "hbond_coverage", "hbond_coverage_hydrophobe",
              "hbond_energy"),
    "env": ("rotamer", "environment_coverage", "hbond_coverage"),
}


def export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def noenv_path(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bundles"))
    return export_tool().build_bundle("trp_cage_noenv_synth", out, out)


def _pair(records, pos):
    js = JSystem(len(pos), jax_specs(records))
    ts = System(len(pos), records, "cpu", torch.float64)
    P = pos.astype(np.float64) \
        + 0.05 * np.random.default_rng(3).normal(size=pos.shape)
    return js, jax_params64(js), ts, P


@pytest.fixture(scope="module", params=["noenv", "env"])
def engines(request, noenv_path):
    if request.param == "noenv":
        records, pos = bundle.load(noenv_path)
    else:
        records, pos = bundle.load(TRP)
        for r in records:
            if r.type_name == "nonlinear_coupling":
                r.consts["spline_offset"] = np.float32(-4.0)
    js, jp, ts, P = _pair(records, pos)
    ju = JUpside(js, jp, jnp.asarray(P))
    tu = Upside(ts)
    return request.param, ju, tu, P


def _rms_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


def test_energy_and_deriv_match_jax(engines):
    kind, ju, tu, P = engines
    assert (tu.system.pair_fusion.env is None) == (kind == "noenv")
    # JUpside.energy and .deriv jit the same function; one compile here
    e_j, g_j = jax.jit(jax.value_and_grad(ju.system.energy))(
        jnp.asarray(P), ju.params)
    e_t = tu.energy(P)
    assert abs(e_t - float(e_j)) <= 1e-4 * abs(float(e_j))
    assert _rms_rel(tu.deriv(P), g_j) < 1e-4


def test_param_deriv_matches_jax(engines):
    kind, ju, tu, P = engines
    tu.energy(P)
    # every node's JAX get_param_deriv at once: one gradient of the whole
    # parameter pytree, flattened per node in sorted-key order as
    # JUpside.get_param_deriv flattens system.param_deriv
    grads = jax.jit(jax.grad(lambda p: ju.system.energy(jnp.asarray(P), p)))(
        ju.params)
    for node in DERIV_NODES[kind]:
        want = _flatten_node_params(
            {k: torch.as_tensor(np.array(v)) for k, v in
             grads[node].items()})
        got = tu.get_param_deriv(node)
        assert got.shape == want.shape, node
        assert np.abs(want).max() > 0, node
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), node


def test_sens_outputs_and_param_roundtrip(engines):
    kind, ju, tu, P = engines
    tu.energy(P)
    n_bead = len(tu.system.by_name["rotamer"].consts["index"])
    assert tu.get_output_dims("hbond_coverage") == (n_bead, 1)
    assert tu.get_output(
        "placement_fixed_point_vector_only").shape[-1] == 6
    # JUpside.get_sens is System.get_sens at its stored pos, jitted here
    sens_j = jax.jit(lambda x: ju.system.get_sens(x, ju.params,
                                                  "hbond_coverage"))(
        jnp.asarray(P))
    sens_t = tu.get_sens("hbond_coverage")
    assert np.abs(np.asarray(sens_j)).max() > 0
    assert _rms_rel(sens_t, sens_j) < 1e-4

    nodes = ["rotamer", "hbond_energy", "placement_fixed_point_vector_only",
             "placement_fixed_point_vector_scalar"]
    if kind == "env":
        nodes.append("nonlinear_coupling_environment")
    for node in nodes:
        flat = tu.get_param(node)
        np.testing.assert_array_equal(flat, ju.get_param(node))
        e0 = tu.energy(P)
        new = (flat * 1.01 + 0.001).astype(np.float32)
        tu.set_param(new, node)
        np.testing.assert_array_equal(tu.get_param(node), new)
        assert tu.energy(P) != e0, node
        tu.set_param(flat, node)
        assert abs(tu.energy(P) - e0) <= 1e-6 * abs(e0), node
    # a bundle has no raw Rama map: get_param rebuilds it from the
    # coefficients, and set_param refits it as the JAX hook does
    saved = dict(tu.params["rama_map_pot"]), dict(ju.params["rama_map_pot"])
    raw = tu.get_param("rama_map_pot")
    e0 = tu.energy(P)
    tu.set_param(raw, "rama_map_pot")
    ju.set_param(raw, "rama_map_pot")
    np.testing.assert_array_equal(
        tu.params["rama_map_pot"]["coeffs"].numpy(),
        np.asarray(ju.params["rama_map_pot"]["coeffs"], np.float64))
    np.testing.assert_array_equal(tu.get_param("rama_map_pot"),
                                  ju.get_param("rama_map_pot"))
    assert abs(tu.energy(P) - e0) <= 1e-6 * abs(e0)
    tu.params["rama_map_pot"], ju.params["rama_map_pot"] = saved
    with pytest.raises(ValueError, match="bad param size"):
        tu.set_param(np.zeros(3), "dist_spring")

