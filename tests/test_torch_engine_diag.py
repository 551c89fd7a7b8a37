"""The engine's diagnostics channel (`Upside.get_value_by_name`, with
`count_edges_by_type`) against the JAX package's `Upside` on
`trp_cage_extras_synth`, float64 on the CPU at positions perturbed by a
seeded 0.05 normal.

The rotamer channels come from the cold `_bp_solve` of both packages at
the bundle's BP tol 1e-3: rel 1e-6 of each channel's largest entry; the
edge counts and the adjacency exactly.  Channels neither package serves
raise in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import jax_params64, jax_specs
from test_torch_nodes_extra import EXTRAS
from upside_md_tpu.engine import Upside as JUpside
from upside_md_tpu.system import System as JSystem
from upside_md_torch.config import bundle
from upside_md_torch.engine import Upside
from upside_md_torch.system import System

ROTAMER_CHANNELS = [
    "node_marginal", "edge_marginal", "edge_marginal_in_graph_order",
    "node_energy", "edge_energy", "node_free_energy", "edge_free_energy",
    "rotamer_free_energy", "bead_marginal", "adjacency", "n_node",
    "rotamer_1body_energy", "rotamer_1body_energy1",
    "rotamer_1body_energy2"]
EDGE_NODES = ["rotamer", "hbond_coverage", "hbond_coverage_hydrophobe",
              "environment_coverage"]


@pytest.fixture(scope="module")
def engines():
    records, pos = bundle.load(EXTRAS)
    js = JSystem(len(pos), jax_specs(records))
    P = pos.astype(np.float64) \
        + 0.05 * np.random.default_rng(3).normal(size=pos.shape)
    # the JAX engine evaluates the graph op by op; compiled once, the
    # same function answers every channel in a fraction of the time
    js.evaluate = jax.jit(js.evaluate)
    ju = JUpside(js, jax_params64(js), jnp.asarray(P))
    ts = System(len(pos), records, "cpu", torch.float64)
    return ju, Upside(ts, initial_pos=torch.tensor(P))


def _same(got, want):
    want = np.asarray(want)
    assert np.shape(got) == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind == "b":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("channel", ROTAMER_CHANNELS)
def test_rotamer_channel_matches_jax(engines, channel):
    ju, tu = engines
    _same(tu.get_value_by_name("rotamer", channel),
          ju.get_value_by_name("rotamer", channel))


@pytest.mark.parametrize("node", EDGE_NODES)
def test_count_edges_by_type_matches_jax(engines, node):
    ju, tu = engines
    want = ju.get_value_by_name(node, "count_edges_by_type")
    got = tu.get_value_by_name(node, "count_edges_by_type")
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


@pytest.mark.parametrize("node,channel", [
    ("radial", "count_edges_by_type"), ("rotamer", "no_such_channel"),
    ("membrane_potential", "node_marginal")])
def test_unserved_channels_raise(engines, node, channel):
    ju, tu = engines
    for engine in (ju, tu):
        with pytest.raises(ValueError):
            engine.get_value_by_name(node, channel)
