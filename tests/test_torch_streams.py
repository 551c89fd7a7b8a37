"""The port's per-node logging streams (`upside_md_torch.io.streams`)
against the JAX package's (`upside_md_tpu.io.streams`).

* `stream_plan`: names and order equal at the three levels, on the
  trp-cage bundle and on the extras graph (`trp_cage_extras_synth` plus
  `config/extras_graph.py`), which between them reach every entry of
  STREAM_BUILDERS: AFM, rama, rama map, hbond, virtual, placement (with
  its collision suffixes), environment coverage, rotamer, contact,
  fixed_hmm, both linear couplings and the nonlinear coupling.
* `make_frame_fn` at the extensive level on the extras graph, float64 on
  the CPU, at positions perturbed by a seeded 0.05 normal and the
  force-evaluation counter 7: a Hamiltonian ensemble of three slots whose
  stream-read leaves (AFM, rama map, contact, fixed_hmm, both couplings,
  the nonlinear coupling, the rotamer table) differ by a +-2% ladder.
  Every stream, the potential and the hbond count of each slot equal the
  JAX package's vmapped frame function at rel 1e-5 (relative to the
  stream's largest value), both from the port's one stacked evaluation
  and from each slot evaluated alone under its own parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import TRP, jax_params64, jax_specs
from test_torch_nodes_extra import graph_records
from upside_md_tpu.io import streams as jstreams
from upside_md_tpu.md.sim import stack_param_ensembles as jstack
from upside_md_tpu.system import System as JSystem
from upside_md_torch.config import bundle
from upside_md_torch.io import streams
from upside_md_torch.md.sim import stack_param_ensembles
from upside_md_torch.system import System, slot_params

N_EVALS = 7
N_SLOT = 3
# one parameter leaf a stream reads, by node type
STACKED = {"AFM": "pulling_vel", "rama_map_pot": "coeffs",
           "contact": "energy", "fixed_hmm": "transition_energy",
           "linear_coupling_uniform": "couplings",
           "linear_coupling_with_inactivation": "couplings",
           "nonlinear_coupling": "coeff", "rotamer": "interaction_param"}


def _pair(records, n_atom):
    js = JSystem(n_atom, jax_specs(records))
    ts = System(n_atom, records, device="cpu", dtype=torch.float64)
    return js, jax_params64(js), ts


@pytest.fixture(scope="module")
def extras():
    records, pos = graph_records()
    js, jp, ts = _pair(records, len(pos))
    P = pos.astype(np.float64) + 0.05 * np.random.default_rng(3).normal(
        size=(N_SLOT,) + pos.shape)
    return dict(records=records, js=js, jp=jp, ts=ts, P=P)


@pytest.mark.parametrize("level", ["basic", "detailed", "extensive"])
def test_stream_plan_matches_jax(extras, level):
    trp_records, trp_pos = bundle.load(TRP)
    pairs = [(extras["js"], extras["ts"]),
             _pair(trp_records, len(trp_pos))[::2]]
    covered, present = set(), set()
    for js, ts in pairs:
        want = [name for name, _ in jstreams.stream_plan(js, level)]
        got = streams.stream_plan(ts, level)
        assert [name for name, _, _ in got] == want
        covered |= {s.node_type.name for _, s, _ in got}
        present |= {s.node_type.name for s in ts.specs}
    assert set(streams.STREAM_BUILDERS) == set(jstreams.STREAM_BUILDERS)
    if level == "extensive":
        # every builder the two graphs hold, every one but three of the
        # seven placement variants
        assert covered == set(streams.STREAM_BUILDERS) & present
        assert len(set(streams.STREAM_BUILDERS) - covered) <= 3
        assert all(t.startswith("placement_")
                   for t in set(streams.STREAM_BUILDERS) - covered)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_frame_streams_match_jax_per_slot(extras):
    js, jp, ts, P = extras["js"], extras["jp"], extras["ts"], extras["P"]
    by_type = {}
    for s in ts.specs:
        if s.node_type.name in STACKED:
            by_type.setdefault(s.node_type.name, []).append(s.name)
    leaves = [(n, STACKED[t]) for t, names in by_type.items() for n in names]
    assert len(by_type) == len(STACKED)
    port, ref = [], []
    for i in range(N_SLOT):
        f = 1.0 + 0.04 * (i / (N_SLOT - 1) - 0.5)
        p = {k: dict(v) for k, v in ts.params.items()}
        q = {k: dict(v) for k, v in jp.items()}
        for node, leaf in leaves:
            p[node][leaf] = ts.params[node][leaf] * f
            q[node][leaf] = jp[node][leaf] * f
        port.append(p)
        ref.append(q)
    mixed, spec = stack_param_ensembles(port)
    jmixed, jspec = jstack(ref)
    assert spec == frozenset(leaves)

    jfn, j_has_hb = jstreams.make_frame_fn(js, "extensive",
                                           params_batched=jspec)
    j_pot, j_streams, j_hb = jfn(jnp.asarray(P), jmixed,
                                 {"n_deriv_evals": N_EVALS})
    fn, has_hb = streams.make_frame_fn(ts, "extensive")
    assert has_hb and j_has_hb
    x = torch.tensor(P)
    pot, got, hb = fn(x, mixed, N_EVALS)
    assert set(got) == set(j_streams)
    assert _rel(pot.numpy(), j_pot) < 1e-5
    assert _rel(hb.numpy(), j_hb) < 1e-5
    for name, v in got.items():
        assert _rel(v.numpy(), j_streams[name]) < 1e-5, name
    # each slot alone under its own parameters
    for i in range(N_SLOT):
        pot_i, got_i, hb_i = fn(x[i:i + 1], slot_params(mixed, spec, i),
                                N_EVALS)
        assert _rel(pot_i.numpy(), j_pot[i:i + 1]) < 1e-5
        assert _rel(hb_i.numpy(), j_hb[i:i + 1]) < 1e-5
        for name, v in got_i.items():
            assert _rel(v.numpy(), np.asarray(j_streams[name])[i:i + 1]) \
                < 1e-5, (i, name)
