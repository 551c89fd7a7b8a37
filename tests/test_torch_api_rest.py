"""Three public functions of the JAX package and their ports, on the CPU,
on the systems the JAX package's own tests build:

* `freeze_static_nodes` (upside_md_torch/system.py against
  upside_md_tpu/system.py:159-189) on tests/test_engine_api.py's
  `small_config`: the same nodes become `constant` in both packages, and
  the port's frozen system's energy equals the unfrozen one's within
  1e-5 abs, its forces within rel 1e-5 (float32, as the JAX test); on
  the extras graph (`config/extras_graph.py`), whose `constant_anchor`
  is the one node that does not depend on the positions, the port alone
  (the JAX package's freeze evaluates that whole graph op by op, over a
  minute on a CPU): that node frozen, energy and forces as above;
* `make_stream_fn` (io/streams.py; tests/test_streams.py's trp-cage
  backbone system, BASELINE config 1): every stream of one configuration
  at the extensive level, and of a batch of two at the detailed level,
  equals the JAX package's within 1e-5 of the larger of the stream's
  largest value and 1 (its hbond probabilities are all near 0 at this
  structure);
* `log_standard_frame` (io/logger.py): two frames of one replica and two
  of a batch of three, through the port's `H5Logger` and the JAX
  package's; read back with h5py, every dataset has the same shape, the
  copied values (pos, time, temperature, replica_index) are equal and the
  computed ones (kinetic, potential) equal within rel 1e-5.  The port
  writes float32 values and a float64 time, as its command line does.

The JAX package's evaluations here are jitted on their System objects
(`evaluate`, `energy`); run op by op they took most of a minute.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli_and_analysis import small_config
from test_torch_nodes_extra import graph_records
from torch_threads import one_thread  # noqa: F401
from upside_md_torch import bench_systems as pbs
from upside_md_torch.engine import Upside
from upside_md_torch.io import logger as plogger
from upside_md_torch.io import streams as pstreams
from upside_md_torch.md.sim import SimState, Simulation
from upside_md_torch.system import System, freeze_static_nodes
from upside_md_tpu import bench_systems as jbs
from upside_md_tpu.engine import Upside as JUpside
from upside_md_tpu.io import logger as jlogger
from upside_md_tpu.io import streams as jstreams
from upside_md_tpu.md.sim import SimState as JSimState
from upside_md_tpu.md.sim import Simulation as JSimulation
from upside_md_tpu.system import freeze_static_nodes as jfreeze


def _frozen_names(system):
    return sorted(s.name for s in system.specs
                  if s.node_type.name == "constant")


def _small_config(tmp_path):
    """(port System, positions, the JAX package's frozen node names)."""
    path = small_config(tmp_path)
    engine = JUpside(path)
    js = engine.system
    js.evaluate = jax.jit(js.evaluate)
    jfrozen, _ = jfreeze(js, engine.params)
    return (Upside(path, device="cpu").system, np.asarray(engine._pos),
            _frozen_names(jfrozen))


def _extras_graph(tmp_path):
    records, pos = graph_records()
    return System(len(pos), records, device="cpu"), pos, ["constant_anchor"]


@pytest.mark.parametrize("build", [_small_config, _extras_graph],
                         ids=["small_config", "extras_graph"])
def test_freeze_static_nodes(tmp_path, build):
    ts, pos, want = build(tmp_path)
    frozen, fparams = freeze_static_nodes(ts)
    assert _frozen_names(frozen) == want
    assert set(fparams) == set(ts.params)
    x = torch.as_tensor(pos, dtype=torch.float32)[None]
    g0, e0, _ = ts.deriv(x)
    g1, e1, _ = frozen.deriv(x, params=fparams)
    assert abs(float(e1[0]) - float(e0[0])) < 1e-5
    assert (g1 - g0).abs().max() <= 1e-5 * g0.abs().max()


@pytest.fixture(scope="module")
def backbone():
    js, jp, jpos, _ = jbs.build_backbone_system(seq=jbs.TRP_CAGE)
    js.energy = jax.jit(js.energy)
    ts, _, tpos, _ = pbs.build_backbone_system(seq=pbs.TRP_CAGE,
                                               device="cpu")
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    return js, jp, ts, np.asarray(jpos, np.float32)


def _assert_streams(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g - w).max() <= 1e-5 * scale, name


@pytest.mark.parametrize("level,batched", [("extensive", False),
                                           ("detailed", True)])
def test_make_stream_fn_matches_jax(backbone, level, batched):
    js, jp, ts, pos = backbone
    x = np.stack([pos, pos * 1.001]) if batched else pos
    want = jstreams.make_stream_fn(js, level, batched)(jnp.asarray(x), jp)
    got = pstreams.make_stream_fn(ts, level, batched)(torch.as_tensor(x))
    _assert_streams(got, want)
    assert pstreams.make_stream_fn(ts, -1) is None
    assert jstreams.make_stream_fn(js, -1) is None


def _states(pos, n, seed):
    """The same state in both packages: (JAX, port) of n replicas (one
    unbatched JAX state when n is None)."""
    rng = np.random.default_rng(seed)
    B = n or 1
    P = (pos + 0.05 * rng.normal(size=(B,) + pos.shape)).astype(np.float32)
    M = rng.normal(size=P.shape).astype(np.float32)
    T = (0.8 + 0.1 * np.arange(B)).astype(np.float32)
    r = 40 + seed
    one = (lambda a: a[0]) if n is None else (lambda a: a)
    zeros = np.zeros((B, 2), np.int32)
    jstate = JSimState(
        pos=jnp.asarray(one(P)), mom=jnp.asarray(one(M)),
        round_num=jnp.asarray(r if n is None else [r] * B, jnp.int32),
        seed=jnp.asarray(one(np.arange(B, dtype=np.uint32))),
        temperature=jnp.asarray(one(T)),
        initial_temperature=jnp.asarray(one(T)),
        pivot_stats=jnp.asarray(one(zeros)),
        jump_stats=jnp.asarray(one(zeros)))
    tstate = SimState(pos=torch.as_tensor(P), mom=torch.as_tensor(M),
                      round_num=r, temperature=torch.as_tensor(T))
    return jstate, tstate


@pytest.mark.parametrize("n", [None, 3], ids=["one_replica", "batched"])
def test_log_standard_frame_matches_jax(backbone, tmp_path, n):
    js, jp, ts, pos = backbone
    jsim, tsim = JSimulation(js, dt=0.009), Simulation(ts, dt=0.009)
    jpath, tpath = tmp_path / "jax.h5", tmp_path / "port.h5"
    jlog, tlog = jlogger.H5Logger(str(jpath)), plogger.H5Logger(str(tpath))
    batched = n is not None
    for seed in (0, 1):
        jstate, tstate = _states(pos, n, seed)
        index = np.arange(n or 1)[::-1].copy() + seed
        jlogger.log_standard_frame(jlog, jsim, jstate, jp, batched, index)
        plogger.log_standard_frame(tlog, tsim, tstate, None, batched,
                                   torch.as_tensor(index))
    jlog.close()
    tlog.close()
    with h5py.File(jpath, "r") as jf, h5py.File(tpath, "r") as tf:
        names = set(jf["output"])
        assert names == set(tf["output"]) == {
            "pos", "kinetic", "potential", "time", "temperature",
            "replica_index"}
        for name in names:
            want, got = jf["output"][name][:], tf["output"][name][:]
            assert got.shape == want.shape, name
            if name in ("kinetic", "potential"):
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
