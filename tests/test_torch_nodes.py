"""Each ported node against its JAX twin on the trp-cage bundle.

The JAX graph is evaluated once (float64, XLA path on the CPU, so the
coverage and environment nodes take their unfused formulations).  Every
node then runs in both frameworks on the same inputs: outputs must agree,
and so must the vector-Jacobian products under a seeded random cotangent
(the per-node force contract).  Tolerance: rel 1e-4, the BASELINE.md
contract for per-term energies and forces; in float64 the two agree far
tighter.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.nodes.base import NodeSpec as JNodeSpec
from upside_md_tpu.nodes.base import resolve_node_type
from upside_md_tpu.system import System as JSystem
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.system import EvalContext, System

TRP = os.path.join(DATA_DIR, "trp_cage_full_synth.npz")
TOL = dict(rtol=1e-4, atol=1e-9)

NODES = [
    "affine_alignment", "angle_spring", "dihedral_spring", "dist_spring",
    "infer_H_O", "rama_coord", "backbone_pairs",
    "placement_fixed_point_vector_only",
    "placement_fixed_point_vector_only_CB",
    "placement_fixed_point_vector_scalar", "placement_scalar",
    "protein_hbond", "rama_map_pot", "hbond_coverage",
    "hbond_coverage_hydrophobe", "hbond_energy", "weighted_pos",
    "environment_coverage", "nonlinear_coupling_environment",
]


def jax_specs(records):
    """JAX NodeSpecs from bundle records (the bundle drops the rotamer
    one-hots, which the JAX XLA path reads; rebuild them)."""
    out = []
    for s in records:
        c = dict(s.consts)
        if s.type_name == "rotamer":
            res, rot = np.asarray(c["res"]), np.asarray(c["rot"])
            n = len(res)
            c["onehot"] = np.zeros((n, c["n_res"] * 6), np.float32)
            c["onehot"][np.arange(n), res * 6 + rot] = 1.0
            c["onehot_res"] = np.zeros((n, c["n_res"]), np.float32)
            c["onehot_res"][np.arange(n), res] = 1.0
        out.append(JNodeSpec(s.name, resolve_node_type(s.type_name),
                             list(s.args), c, dict(s.params)))
    return out


def jax_params64(js):
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.asarray(a).dtype.kind == "f" else jnp.asarray(a),
        js.make_params())


def load_pair(path, dtype=torch.float64):
    """(bundle records, pos, JAX System, its float64 params, port System)."""
    records, pos = bundle.load(path)
    js = JSystem(len(pos), jax_specs(records))
    return records, pos, js, jax_params64(js), System(len(pos), records,
                                                      device="cpu",
                                                      dtype=dtype)


@pytest.fixture(scope="module")
def trp():
    records, pos, js, jp, ts = load_pair(TRP)
    rng = np.random.default_rng(3)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)

    @jax.jit
    def coordinates(x):
        outs = {"pos": x}
        for s in js.specs:
            if not s.node_type.is_potential:
                outs[s.name] = s.node_type.compute(
                    s.consts, jp.get(s.name, {}), [outs[a] for a in s.args],
                    {"_node_name": s.name})
        return outs

    return dict(js=js, jp=jp, ts=ts, jouts=coordinates(jnp.asarray(P)))


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] + 1e-7 * scale)


@pytest.mark.parametrize("name", NODES)
def test_node_matches_jax(trp, name):
    js, jp, ts, jouts = trp["js"], trp["jp"], trp["ts"], trp["jouts"]
    spec = js.by_name[name]
    tspec = {s.name: s for s in ts.specs}[name]
    assert tspec.node_type.name == spec.node_type.name
    inputs_j = [jouts[a] for a in spec.args]

    def jfun(*ins):
        return spec.node_type.compute(spec.consts, jp.get(name, {}),
                                      list(ins), {"_node_name": name})

    w = np.random.default_rng(len(name)).normal(
        size=jax.eval_shape(jfun, *inputs_j).shape)

    @jax.jit
    def fwd_vjp(ins, cot):
        out, vjp = jax.vjp(jfun, *ins)
        return out, vjp(cot)

    out_j, g_j = fwd_vjp(inputs_j, jnp.asarray(w))
    inputs_t = [torch.tensor(np.asarray(x))[None].requires_grad_(True)
                for x in inputs_j]
    ctx = EvalContext()
    ctx.node_name = name
    out_t = tspec.node_type.compute(ts.consts[name], ts.params[name],
                                    inputs_t, ctx)[0]
    assert tuple(out_t.shape) == tuple(np.shape(out_j))
    _close(out_t.detach().numpy(), out_j)

    g_t = torch.autograd.grad((out_t * torch.as_tensor(w)).sum(), inputs_t,
                              allow_unused=True)
    for a, gt, gj in zip(spec.args, g_t, g_j):
        gt = np.zeros(np.shape(gj)) if gt is None else gt[0].numpy()
        _close(gt, gj)
