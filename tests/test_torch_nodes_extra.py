"""The node types of the extras slice against their JAX twins.

Graph: `trp_cage_extras_synth` (trp-cage built with `dynamic_1body=False`
and every config-builder extra) plus the hand-built nodes of
`upside_md_torch.config.extras_graph` (the types no builder method
writes).  The JAX graph is evaluated once (float64, its XLA formulation
on the CPU) at positions perturbed by a seeded 0.05 normal; every node of
the 24 types the port lacked then runs in both frameworks on the same
inputs: outputs and vector-Jacobian products under a seeded cotangent at
rel 1e-4 (the per-node contract of tests/test_torch_nodes.py), AFM at the
force-evaluation counter 7 in both.  Also: the registries, get/set_param
flat vectors, the fusion plan, stacked tables against per-slot evaluation
(rel 1e-5) and the membrane potential's burial read through the fused
block's env band.  The whole evaluation, the MD loop's counter and the
bundles' rebuild are in tests/test_torch_slice_extras.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import _close, jax_params64, jax_specs
from upside_md_tpu.nodes.base import NODE_REGISTRY as JAX_REGISTRY
from upside_md_tpu.nodes.fusion import plan_pair_fusion as jax_plan
from upside_md_tpu.system import System as JSystem
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.config.extras_graph import EXTRAS_NODES, extras_graph
from upside_md_torch.md.sim import stack_param_ensembles
from upside_md_torch.nodes.base import NODE_REGISTRY
from upside_md_torch.system import EvalContext, System, slot_params

EXTRAS = os.path.join(DATA_DIR, "trp_cage_extras_synth.npz")
RADIAL = os.path.join(DATA_DIR, "ubiquitin_radial_synth.npz")
UBQ = os.path.join(DATA_DIR, "ubiquitin_full_synth.npz")
N_EVALS = 7

def graph_records():
    records, pos = bundle.load(EXTRAS)
    return extras_graph(records, pos), pos


@pytest.fixture(scope="module")
def extras():
    records, pos = graph_records()
    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    ts = System(len(pos), records, device="cpu", dtype=torch.float64)
    P = pos.astype(np.float64) \
        + 0.05 * np.random.default_rng(3).normal(size=pos.shape)

    @jax.jit
    def coordinates(x):
        outs = {"pos": x}
        for s in js.specs:
            if not s.node_type.is_potential:
                outs[s.name] = s.node_type.compute(
                    s.consts, jp.get(s.name, {}), [outs[a] for a in s.args],
                    {"_node_name": s.name})
        return outs

    return dict(js=js, jp=jp, ts=ts, P=P, records=records, pos=pos,
                jouts=coordinates(jnp.asarray(P)))


def test_registry_matches_jax():
    assert set(NODE_REGISTRY) == set(JAX_REGISTRY)
    assert len(NODE_REGISTRY) == 42
    for name, nt in NODE_REGISTRY.items():
        assert nt.is_potential == JAX_REGISTRY[name].is_potential, name


def test_graph_holds_every_new_type(extras):
    by = {s.name: s.node_type.name for s in extras["ts"].specs}
    assert {t: by[n] for t, n in EXTRAS_NODES.items()} == \
        {t: t for t in EXTRAS_NODES}


@pytest.mark.parametrize("type_name", sorted(EXTRAS_NODES))
def test_node_matches_jax(extras, type_name):
    name = EXTRAS_NODES[type_name]
    js, jp, ts, jouts = extras["js"], extras["jp"], extras["ts"], \
        extras["jouts"]
    spec = js.by_name[name]
    tspec = ts.by_name[name]
    assert tspec.node_type.name == spec.node_type.name == type_name
    inputs_j = [jouts[a] for a in spec.args]

    def jfun(*ins):
        return spec.node_type.compute(spec.consts, jp.get(name, {}),
                                      list(ins), {"_node_name": name,
                                                  "n_deriv_evals": N_EVALS})

    w = np.random.default_rng(len(name)).normal(
        size=jax.eval_shape(jfun, *inputs_j).shape)

    @jax.jit
    def fwd_vjp(ins, cot):
        out, vjp = jax.vjp(jfun, *ins)
        return out, vjp(cot)

    out_j, g_j = fwd_vjp(inputs_j, jnp.asarray(w))
    inputs_t = [torch.tensor(np.asarray(x))[None].requires_grad_(True)
                for x in inputs_j]
    ctx = EvalContext(n_replica=1, n_deriv_evals=N_EVALS)
    ctx.node_name = name
    out_t = tspec.node_type.compute(ts.consts[name], ts.params[name],
                                    inputs_t, ctx)[0]
    assert tuple(out_t.shape) == tuple(np.shape(out_j))
    _close(out_t.detach().numpy(), out_j)
    assert np.abs(np.asarray(out_j)).max() > 0, "a vacuous comparison"
    if not out_t.requires_grad:
        # the output does not depend on the inputs (a fixed scalar
        # placement passes its table through): JAX's VJP is 0
        for gj in g_j:
            assert not np.asarray(gj).any()
        return
    g_t = torch.autograd.grad((out_t * torch.as_tensor(w)).sum(), inputs_t,
                              allow_unused=True)
    for a, gt, gj in zip(spec.args, g_t, g_j):
        gt = np.zeros(np.shape(gj)) if gt is None else gt[0].numpy()
        _close(gt, gj)
    assert max(np.abs(np.asarray(g)).max() for g in g_j) > 0


HOOKED = sorted(n for t, n in EXTRAS_NODES.items()
                if JAX_REGISTRY[t].get_param is not None)


@pytest.mark.parametrize("name", HOOKED)
def test_get_set_param_match_jax(extras, name):
    """The flat vector equals the JAX hook's, in its order; set_param of a
    scaled vector reads back, in both packages alike."""
    js, jp, ts = extras["js"], extras["jp"], extras["ts"]
    jspec, tspec = js.by_name[name], ts.by_name[name]
    tt = tspec.node_type
    assert tt.get_param is not None and tt.set_param is not None
    flat_j = np.asarray(jspec.node_type.get_param(jspec.consts, jp[name]))
    flat_t = tt.get_param(ts.consts[name], ts.params[name])
    assert flat_t.shape == flat_j.shape and flat_t.dtype == flat_j.dtype
    np.testing.assert_allclose(flat_t, flat_j, rtol=1e-6, atol=0)
    new = (1.25 * flat_j + 0.01).astype(np.float32)
    _, jq = jspec.node_type.set_param(jspec.consts, jp[name], new)
    tq = tt.set_param(ts.consts[name], ts.params[name], new)
    assert set(tq) == set(jq)
    for k in jq:
        assert tuple(tq[k].shape) == np.shape(jq[k])
        assert tq[k].dtype == ts.params[name][k].dtype
    np.testing.assert_allclose(tt.get_param(ts.consts[name], tq),
                               jspec.node_type.get_param(jspec.consts, jq),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", [EXTRAS, RADIAL, "hand_built"])
def test_fusion_plan_matches_jax(path):
    """The port's plan names the same nodes as the JAX plan, with the env
    band: radial, the CB placement and the membrane potential enter the
    node order without moving the fused group."""
    if path == "hand_built":
        records, pos = graph_records()
    else:
        records, pos = bundle.load(path)
    js = JSystem(len(pos), jax_specs(records))
    ts = System(len(pos), records, device="cpu", dtype=torch.float64)

    def names(plan):
        return (plan.cov1.name, plan.cov2.name, plan.rot.name,
                None if plan.env is None else plan.env.name)
    assert names(ts.pair_fusion) == names(jax_plan(js.specs)) == (
        "hbond_coverage", "hbond_coverage_hydrophobe", "rotamer",
        "environment_coverage")


def test_config2_is_ubiquitin_plus_radial():
    """BASELINE config 2's bundle is the ubiquitin full force field plus
    `radial` on the CB placement: the same positions, the same fused group
    and every other term equal."""
    rec_r, pos_r = bundle.load(RADIAL)
    rec_u, pos_u = bundle.load(UBQ)
    np.testing.assert_array_equal(pos_r, pos_u)
    sys_r = System(len(pos_r), rec_r, device="cpu", dtype=torch.float64)
    sys_u = System(len(pos_u), rec_u, device="cpu", dtype=torch.float64)
    added = {s.name for s in sys_r.specs} - {s.name for s in sys_u.specs}
    assert added == {"radial", "placement_fixed_point_only_CB"}
    plan = [getattr(sys_r.pair_fusion, k).name
            for k in ("cov1", "cov2", "rot", "env")]
    assert plan == [getattr(sys_u.pair_fusion, k).name
                    for k in ("cov1", "cov2", "rot", "env")]
    x = torch.tensor(pos_r, dtype=torch.float64)[None]
    per_r = sys_r.evaluate(x)[2]
    per_u = sys_u.evaluate(x)[2]
    assert set(per_r) == set(per_u) | {"radial"}
    for k, v in per_u.items():
        np.testing.assert_allclose(per_r[k].numpy(), v.numpy(), rtol=1e-12)
    assert float(per_r["radial"][0]) < 0.0


def _stacked_against_slots(ts, node, key, P, factors):
    base = ts.params
    slots = [{**base, node: {**base[node], key: base[node][key] * f}}
             for f in factors]
    mixed, spec = stack_param_ensembles(slots)
    assert spec == {(node, key)}
    x = torch.tensor(P).expand(len(factors), -1, -1).contiguous()
    g, e, _ = ts.deriv(x, None, None, mixed, n_deriv_evals=N_EVALS)
    for i in range(len(factors)):
        gi, ei, _ = ts.deriv(x[i:i + 1], None, None,
                             slot_params(mixed, spec, i),
                             n_deriv_evals=N_EVALS)
        np.testing.assert_allclose(e[i:i + 1].numpy(), ei.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(g[i].numpy(), gi[0].numpy(), rtol=1e-5,
                                   atol=1e-9)
    assert np.ptp(e.numpy()) > 1e-6


@pytest.mark.parametrize("node,key", [
    ("radial", "interaction_param"),
    ("fixed_hmm", "transition_energy"),
    ("uniform_transform_burial", "bspline_coeff"),
    ("conv1d_hidden", "weights"),
])
def test_stacked_leaf_matches_per_slot(extras, node, key):
    """A leaf stacked over replicas (a Hamiltonian ensemble) evaluates
    each slot under its own value: energies and forces rel 1e-5 of each
    slot alone."""
    _stacked_against_slots(extras["ts"], node, key, extras["P"],
                           (0.9, 1.0, 1.15))


def test_membrane_reads_the_fused_env_band(extras):
    """On the fused path the burial the membrane potential reads is the
    env band's output, with its cotangent path: its coverage and the
    gradient it sends back equal those of the unfused environment node."""
    ts = extras["ts"]
    assert ts.pair_fusion.env.name == "environment_coverage"
    ref = System(len(extras["pos"]), extras["records"], device="cpu",
                 dtype=torch.float64)
    ref.pair_fusion = None
    x = torch.tensor(extras["P"])[None]
    outs = ts.evaluate(x)[1]
    outs_ref = ref.evaluate(x)[1]
    np.testing.assert_allclose(outs["environment_coverage"].numpy(),
                               outs_ref["environment_coverage"].numpy(),
                               rtol=1e-9, atol=1e-12)
    grads = []
    for s in (ts, ref):
        xs = x.clone().requires_grad_(True)
        term = s.evaluate(xs)[2]["membrane_potential"]
        grads.append(torch.autograd.grad(term.sum(), xs)[0].numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-8, atol=1e-10)
    assert np.abs(grads[0]).max() > 0


@pytest.mark.parametrize("act", ["ReLU", "Tanh", "Identity", "Softplus"])
def test_conv1d_activations(act):
    """conv1d's three activations against numpy; any other raises, as the
    JAX node does."""
    node = NODE_REGISTRY["conv1d"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 3))
    w = rng.normal(size=(4, 3, 2))
    b = rng.normal(size=2)
    ctx = EvalContext(n_replica=2)
    args = ({"activation": act}, {"weights": torch.tensor(w),
                                  "bias": torch.tensor(b)},
            [torch.tensor(x)], ctx)
    if act == "Softplus":
        with pytest.raises(ValueError, match="unknown activation"):
            node.compute(*args)
        return
    y = sum(np.einsum("bnc,co->bno", x[:, i:i + 6], w[i]) for i in range(4))
    y = y + b
    y = {"ReLU": np.maximum(y, 0.0), "Tanh": np.tanh(y),
         "Identity": y}[act]
    np.testing.assert_allclose(node.compute(*args).numpy(), y, rtol=1e-12)


def test_contact_energy_per_bead_sums_to_contact(extras):
    from upside_md_torch.nodes.radial import contact_energy_per_bead
    ts = extras["ts"]
    outs = ts.evaluate(torch.tensor(extras["P"])[None])
    per_bead = contact_energy_per_bead(
        ts.consts["contact"], ts.params["contact"],
        [outs[1]["placement_fixed_point_only_CB"]])
    np.testing.assert_allclose(float(per_bead.sum()),
                               float(outs[2]["contact"][0]), rtol=1e-12)


@pytest.mark.parametrize("stacked", [False, True])
def test_radial_neighbour_list_keeps_every_partner(extras, monkeypatch,
                                                   stacked):
    """Above the threshold radial takes the fixed-K neighbour list; with
    K at least the probe count it keeps every partner, so energy and
    gradients equal the dense grid's (rel 1e-12), stacked table or not."""
    from upside_md_torch.nodes import radial
    ts = extras["ts"]
    spec = ts.by_name["radial"]
    x = torch.tensor(extras["P"]) + 0.2 * torch.tensor(
        np.random.default_rng(6).normal(size=(3,) + extras["P"].shape))
    cb = ts.evaluate(x)[1]["placement_fixed_point_only_CB"]
    table = ts.params["radial"]["interaction_param"]
    if stacked:
        table = torch.stack([table * f for f in (0.9, 1.0, 1.2)])
    ctx = EvalContext(n_replica=3)
    ctx.stacked = frozenset({"interaction_param"} if stacked else ())

    def run():
        inp = cb.detach().requires_grad_(True)
        e = spec.node_type.compute(ts.consts["radial"],
                                   {"interaction_param": table}, [inp], ctx)
        return e.detach(), torch.autograd.grad(e.sum(), inp)[0]
    e_dense, g_dense = run()
    monkeypatch.setattr(radial, "NEIGHBOR_LIST_THRESHOLD", 8)
    e_nl, g_nl = run()
    np.testing.assert_allclose(e_nl.numpy(), e_dense.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_nl.numpy(), g_dense.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert (e_dense < 0).all() and np.ptp(e_dense.numpy()) > 0


def test_node_diagnostics_match_jax(extras):
    """`rotamer_marginals`, `hmm_energy_decomposition` and
    `contact_energy_per_bead` against the JAX functions at the same
    inputs: rel 1e-6 of each result's largest entry."""
    from upside_md_torch.nodes import hmm, radial, rotamer
    from upside_md_tpu.nodes import hmm as jhmm
    from upside_md_tpu.nodes import radial as jradial
    from upside_md_tpu.nodes import rotamer as jrot
    js, jp, ts, jouts = extras["js"], extras["jp"], extras["ts"], \
        extras["jouts"]

    def both(name, jfn, tfn):
        spec = js.by_name[name]
        ins = [jouts[a] for a in spec.args]
        want = jfn(spec.consts, jp.get(name, {}), ins)
        got = tfn(ts.consts[name], ts.params[name],
                  [torch.tensor(np.asarray(v))[None] for v in ins])
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            w = np.asarray(w)
            np.testing.assert_allclose(g[0].numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
    both("rotamer", jrot.rotamer_marginals, rotamer.rotamer_marginals)
    both("fixed_hmm", jhmm.hmm_energy_decomposition,
         lambda c, p, i: tuple(t[None] if t.dim() == 1 else t for t in
                               hmm.hmm_energy_decomposition(c, p, i)))
    both("contact", jradial.contact_energy_per_bead,
         radial.contact_energy_per_bead)
