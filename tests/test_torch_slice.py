"""The port's main path as a whole against the JAX package, on the trp-cage
bundle, plus the bundle pin and the import isolation of the port.

* energy, per-term energies and forces of the whole graph: port (fused
  block and BP on their plain versions) vs the JAX System on the CPU (XLA
  path), both in float64: rel 1e-4, forces as RMS relative error;
* one 3-stage Verlet round with the BP cache threaded through the stages,
  from the same positions and momenta: positions and momenta at rel 1e-4;
* the OU thermostat formula on the noise JAX draws;
* the trp-cage, RNase A, no-env ubiquitin and cytochrome c bundles
  regenerated by tools/export_torch_bundle.py match the committed ones to
  1e-6 (cytochrome c's Monte Carlo move tables exactly);
* `import upside_md_torch` (a short MD run, one exchange round of a
  Hamiltonian ensemble and one pivot step, the engine and training
  modules, one parameter derivative; the extras slice's node modules, the
  hand-built graph on the extras bundle, a diagnostics channel and a chi1
  prediction; the command line writing two slots' HDF5 files, read back
  by the trajectory and analysis tools; the committed ubiquitin `.up`
  read by `config.load` and the engine, and `rama_map_pot`'s
  get_param/set_param round trip on it; a trp-cage `.up` built by
  `upside_config` from the committed libraries and evaluated, the edit,
  merge and library tools, `run.upside_config` and chi1 from a PDB; the
  replica mesh and dry-run modules and config 1 built by `bench_systems`;
  and, in a second process, the flagship entry point's forward step,
  `bench_torch.py` at one replica and one round, one row of
  `tools/bench_all_torch.py` and `examples/replica_exchange_torch.py`)
  with jax, h5py and upside_md_tpu blocked.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import TRP, load_pair
from upside_md_tpu.md.integrator import integration_cycle as jax_cycle
from upside_md_tpu.md.thermostat import OUThermostat as JaxOU
from upside_md_tpu.md.thermostat import stream_key
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.md.integrator import integration_cycle
from upside_md_torch.md.sim import Simulation
from upside_md_torch.md.thermostat import OUThermostat, thermalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trp():
    records, pos, js, jp, ts = load_pair(TRP)
    rng = np.random.default_rng(11)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    mom = rng.normal(size=pos.shape)
    return dict(js=js, jp=jp, ts=ts, P=P, mom=mom)


def _rms_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


def test_energy_terms_and_forces_match_jax(trp):
    js, jp, ts, P = trp["js"], trp["jp"], trp["ts"], trp["P"]

    @jax.jit
    def jax_eval(x):
        def total(y):
            e, _, per = js.evaluate(y, jp)
            return e, per
        (e, per), g = jax.value_and_grad(total, has_aux=True)(x)
        return e, per, g

    e_j, per_j, g_j = jax_eval(jnp.asarray(P))
    x = torch.tensor(P[None], requires_grad=True)
    total, _, per_t, _ = ts.evaluate(x)
    (g_t,) = torch.autograd.grad(total.sum(), x)
    assert ts.pair_fusion is not None            # the fused block ran
    assert set(per_t) == set(per_j)
    for name, v in per_t.items():
        assert abs(v.item() - float(per_j[name])) <= \
            1e-4 * max(1.0, abs(float(per_j[name]))), name
    assert abs(total.item() - float(e_j)) <= 1e-4 * abs(float(e_j))
    assert _rms_rel(g_t[0].numpy(), g_j) < 1e-4


def test_verlet_round_with_cache_matches_jax(trp):
    js, jp, ts, P, mom = trp["js"], trp["jp"], trp["ts"], trp["P"], \
        trp["mom"]
    dt = 0.009

    def jax_deriv(p, stage, cache):
        return jax.grad(lambda q: js.energy_and_cache(q, jp, cache=cache),
                        has_aux=True)(p)

    pos_j, mom_j, cache_j = jax.jit(
        lambda p, m, c: jax_cycle(jax_deriv, p, m, dt, cache=c))(
        jnp.asarray(P), jnp.asarray(mom), js.init_cache())

    def deriv(p, stage, cache):
        g, _, cache = ts.deriv(p, cache)
        return g, cache

    pos_t, mom_t, cache_t = integration_cycle(
        deriv, torch.tensor(P[None]), torch.tensor(mom[None]), dt,
        ts.init_cache(1))
    assert np.abs(pos_t[0].numpy() - np.asarray(pos_j)).max() \
        <= 1e-4 * np.abs(np.asarray(pos_j)).max()
    assert _rms_rel(mom_t[0].numpy(), mom_j) < 1e-4
    # the threaded BP beliefs agree too (JAX caches (nb, eb, prev nb))
    nb_t = cache_t["rotamer"]["nb"][0].numpy()
    assert np.abs(nb_t - np.asarray(cache_j["rotamer"][0])).max() < 1e-4


def test_replicas_are_independent(trp):
    """Two replicas advanced together equal each advanced alone (the
    replica axis is a plain batch; BP stops per replica)."""
    ts, P = trp["ts"], trp["P"]
    noise = np.random.default_rng(5).normal(size=(2,) + P.shape)

    def run(idx):
        sim = Simulation(ts, thermostat_interval=0.027)
        st = sim.initial_state(np.stack([P, P + 0.01])[idx], len(idx))
        st.mom = torch.zeros_like(st.mom)
        return sim.advance(st, 1, noise=lambda nr: torch.tensor(noise[idx]))

    both = run([0, 1])
    for i in (0, 1):
        one = run([i])
        np.testing.assert_allclose(both.pos[i].numpy(), one.pos[0].numpy(),
                                   rtol=0, atol=1e-12)


def test_thermostat_matches_jax():
    rng = np.random.default_rng(2)
    mom = rng.normal(size=(3, 17, 3))
    temps = np.array([0.85, 1.0, 1.2])
    th_j = JaxOU(5.0, 0.135)
    got_j = []
    noise = []
    for r in range(3):
        key = stream_key(r, 0, 4)
        got_j.append(np.asarray(th_j.apply(key, jnp.asarray(mom[r]),
                                           temps[r])))
        noise.append(np.asarray(jax.random.normal(key, mom[r].shape,
                                                  dtype=jnp.float64)))
    got_t = OUThermostat(5.0, 0.135).apply(
        torch.tensor(mom), torch.tensor(temps), noise=torch.tensor(
            np.stack(noise)))
    np.testing.assert_allclose(got_t.numpy(), np.stack(got_j), rtol=1e-12)



def test_thermalize_on_the_cpu_scales_with_temperature():
    """`thermalize` runs on the CPU when the caller asks (its default is the
    card, as `System`'s): momenta of the requested shape whose variance per
    replica is the replica's temperature."""
    gen = torch.Generator().manual_seed(4)
    temps = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    mom = thermalize((3, 4000, 3), temps, gen, torch.float64, device="cpu")
    assert mom.shape == (3, 4000, 3) and mom.device.type == "cpu"
    var = mom.reshape(3, -1).var(1)
    np.testing.assert_allclose((var / temps).numpy(), 1.0, rtol=0.05)
    assert var[2] > 3.0 * var[0]

def test_regenerated_bundle_matches_committed(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in ("trp_cage_full_synth", "rnase_a_full_synth",
                 "ubiquitin_noenv_synth", "cytochrome_c_full_synth"):
        path = tool.build_bundle(name, str(tmp_path), str(tmp_path))
        new, pos_new = bundle.load(path)
        old, pos_old = bundle.load(os.path.join(DATA_DIR, name + ".npz"))
        np.testing.assert_allclose(pos_new, pos_old, rtol=0, atol=1e-6)
        assert [(s.name, s.type_name, s.args) for s in new] == \
            [(s.name, s.type_name, s.args) for s in old]
        for a, b in zip(new, old):
            for part in ("consts", "params"):
                da, db = getattr(a, part), getattr(b, part)
                assert set(da) == set(db), (name, a.name, part)
                for k in da:
                    va, vb = np.asarray(da[k]), np.asarray(db[k])
                    assert va.dtype == vb.dtype and va.shape == vb.shape
                    if va.dtype.kind == "f":
                        np.testing.assert_allclose(
                            va, vb, rtol=1e-6, atol=1e-6,
                            err_msg=f"{name}/{a.name}/{k}")
                    else:
                        np.testing.assert_array_equal(va, vb)
        if name == "cytochrome_c_full_synth":
            # its Monte Carlo move tables, float tables in float32
            new_aux = bundle.load_aux(path)
            old_aux = bundle.load_aux(os.path.join(DATA_DIR, name + ".npz"))
            assert set(old_aux) == {"pivot_moves"}
            assert set(old_aux["pivot_moves"]) == {
                "proposal_pot", "pivot_atom", "pivot_restype", "pivot_range"}
            for sec, tables in old_aux.items():
                assert set(new_aux[sec]) == set(tables)
                for k, v in tables.items():
                    np.testing.assert_array_equal(new_aux[sec][k], v)
            assert old_aux["pivot_moves"]["proposal_pot"].dtype == np.float32
    sizes = [os.path.getsize(os.path.join(DATA_DIR, f))
             for f in ("trp_cage_full_synth.npz",
                       "ubiquitin_full_synth.npz")]
    assert sum(sizes) < 3e6
    assert os.path.getsize(os.path.join(DATA_DIR,
                                        "rnase_a_full_synth.npz")) < 4e6
    assert os.path.getsize(os.path.join(DATA_DIR,
                                        "ubiquitin_noenv_synth.npz")) < 2.5e6
    assert os.path.getsize(os.path.join(
        DATA_DIR, "cytochrome_c_full_synth.npz")) < 5e6


BLOCKED_IMPORT = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "h5py", "upside_md_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import torch
import upside_md_torch
from upside_md_torch import training
from upside_md_torch.engine import Upside
from upside_md_torch.md.sim import Simulation
from upside_md_torch.system import System
system, pos = System.from_bundle(sys.argv[2], device="cpu")
sim = Simulation(system, seed=0)
state = sim.advance(sim.initial_state(pos, 1), 1)
assert bool(torch.isfinite(state.pos).all())
# one exchange round of a Hamiltonian ensemble and one pivot step, with
# pivot tables from the Rama nodes and a flat proposal map
from upside_md_torch.config import bundle
from upside_md_torch.md.mc import PivotSampler, metropolis_step
from upside_md_torch.md.replica import ReplicaExchange, even_odd_swap_sets
from upside_md_torch.md.sim import stack_param_ensembles
k = system.params["angle_spring"]["spring_const"]
params, spec = stack_param_ensembles([
    {**system.params, "angle_spring": {**system.params["angle_spring"],
                                       "spring_const": k * f}}
    for f in (0.99, 1.01)])
state = sim.initial_state(pos, 2, [0.8, 0.816])
state = sim.advance(state, 1, params, spec)
pos2, ridx, stats, energies, cache = ReplicaExchange(
    even_odd_swap_sets(2), 2).attempt_swaps(
    state.pos, torch.arange(2), 1.0 / state.temperature, sim.energy_fn(params),
    aux=state.cache, generator=sim.generator)
assert sorted(ridx.tolist()) == [0, 1] and stats[0][0, 1] == 1
by = {r.name: r for r in bundle.load(sys.argv[2])[0]}
rc = by["rama_coord"].consts["id"]
inner = ~by["rama_coord"].consts["dummy"].any(1)
layer = by["rama_map_pot"].consts["rama_map_id"][inner]
pivot = PivotSampler.from_tables(
    rc[inner], [[a + 1, len(pos)] for a in rc[inner, 4]], layer,
    [[[0.0] * 72] * 72] * (layer.max() + 1), device="cpu")
moved, accepted = metropolis_step(pos2, state.temperature,
                                  sim.energy_fn(params), pivot, sim.generator)
assert moved.shape == pos2.shape and accepted.shape == (2,)
engine = Upside(system, initial_pos=pos)
assert engine.get_param_deriv("hbond_energy").shape == (1,)
assert training.rotamer_packings(system.params)["rotamer"].symmetric
# the extras slice: every node type, chi1 prediction, the diagnostics
from upside_md_torch import chi1
from upside_md_torch.config.extras_graph import extras_graph
from upside_md_torch.nodes import hmm, membrane, nn, radial
from upside_md_torch.nodes.base import NODE_REGISTRY
assert len(NODE_REGISTRY) == 42
recs, p0 = bundle.load(sys.argv[3])
extras = System(len(p0), extras_graph(recs, p0), device="cpu")
assert bool(torch.isfinite(extras.energy(torch.as_tensor(p0)[None])).all())
diag = Upside(extras, initial_pos=torch.as_tensor(p0))
assert diag.get_value_by_name("rotamer", "n_node")[0] == 20
prob, seq, _ = chi1.predict_chi1_from_bundle(sys.argv[4], "cpu")
assert prob.shape == (1, len(seq), 3)
# the command line, its HDF5 files and the tools that read them
import tempfile
from upside_md_torch import analysis, cli, run
from upside_md_torch.io import h5, logger, pdb, streams, trajectory
with tempfile.TemporaryDirectory() as tmp:
    assert cli.main(["--duration=0.054", "--frame-interval=0.027",
                     "--device=cpu", "--log-level=extensive",
                     f"--output-dir={tmp}", sys.argv[2], sys.argv[2]]) == 0
    out = cli.output_path(tmp, sys.argv[2], 1)
    seq, t, traj = trajectory.load_upside_traj(out)
    assert seq is None and traj.shape == (2, len(pos), 3)
    assert analysis.sim_timeseries(out)["potential"].shape == (2, 1)
    with h5.File(out) as f:
        assert "rotamer_free_energy" in f["output"]
# a .up configuration read without h5py, and rama_map_pot's hooks on it
import os
from upside_md_torch import config
from upside_md_torch.chi1 import Chi1Predict
from upside_md_torch.config import reader
up = os.path.join(upside_md_torch.DATA_DIR, "ubiquitin_full_synth.up")
assert len(config.load(up)[0]) == 20
eng = Upside(up, device="cpu")
raw = eng.get_param("rama_map_pot")
e0 = eng.energy(eng._pos.numpy())
eng.set_param(raw, "rama_map_pot")
assert abs(eng.energy(eng._pos.numpy()) - e0) <= 1e-5 * abs(e0)
# building a .up: upside_config on the committed libraries, the edit and
# merge tools, run.upside_config, param_gen, chi1 from a PDB
import numpy as np
from upside_md_torch import LIB_DIR, param_gen, sidechain_topology
from upside_md_torch.config import builder, cli as config_cli, edit, merge
sc = os.path.join(LIB_DIR, "sidechain_synth.h5")
seq = "NLYIQWLKDGGPSSGRPPPS"
with tempfile.TemporaryDirectory() as tmp:
    fasta, out = os.path.join(tmp, "trp.fasta"), os.path.join(tmp, "trp.up")
    with open(fasta, "w") as f:
        f.write(">trp\n" + seq + "\n")
    assert config_cli.main([
        "--fasta", fasta, "--output", out, "--rotamer-placement", sc,
        "--rotamer-interaction", sc, "--dynamic-rotamer-1body",
        "--rotamer-solve-damping", "0.1", "--hbond-energy", "-2.1119",
        "--environment-potential",
        os.path.join(LIB_DIR, "environment_synth.h5")]) == out
    built, p = System.from_up(out, device="cpu")
    assert bool(torch.isfinite(built.energy(p[None])).all())
    with h5.File(out) as f:
        assert f["input/args"].attrs["dynamic_rotamer_1body"]
    two = run.upside_config(fasta, os.path.join(tmp, "two.up"),
                            rama_maps=np.zeros((20, 12, 12)))
    edit.break_chains(two, [10])
    edit.add_target_information(two, p.numpy())
    merge.merge_configs(two, [two], os.path.join(tmp, "merged.up"))
    assert len(config.load(os.path.join(tmp, "merged.up"))[0]) >= 6
    rng = np.random.default_rng(0)
    param_gen.generate_sidechain_library(os.path.join(tmp, "lib.h5"), {
        rt: dict(chi=rng.uniform(-3, 3, (9, 4)), phi=rng.uniform(-3, 3, 9),
                 psi=rng.uniform(-3, 3, 9), rotamer=np.arange(9) % 3)
        for rt in ("ALA", "LEU")}, n_bin=6)
    pdb_path = os.path.join(tmp, "trp.pdb")
    trajectory.write_pdb(pdb_path, [builder.THREE_LETTER_AA[a] for a in seq],
                         p.numpy()[None])
    with open(pdb_path) as f:
        prob, info, _ = chi1.predict_chi1_from_pdb(f.read(), sc,
                                                   device="cpu")
    assert prob.shape == (20, 3) and info["fasta"] == seq
# the replica mesh, the multi-rank dry run and the BASELINE builders
from upside_md_torch import bench_systems
from upside_md_torch.parallel import dryrun, mesh
s1, p1, x1, _ = bench_systems.build_backbone_system(device="cpu")
assert bool(torch.isfinite(s1.energy(x1)))
assert mesh.ReplicaMesh(1, 2, "cpu", "gloo").rows(8) == slice(4, 8)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "h5py", "upside_md_tpu")]
assert not bad, bad
print("isolated ok")
"""


BLOCKED_SCRIPTS = BLOCKED_IMPORT[:BLOCKED_IMPORT.index("import torch")] + r"""
# the repo-level scripts: the flagship entry point, the bench, one row of
# the every-config table and one example
import importlib.util
import os
import tempfile
import torch
from upside_md_torch import bench_systems, entry
fwd, (x0, prm) = entry.entry(small=True, device="cpu")
assert bool(torch.isfinite(fwd(x0, prm)[1]).all())


def script(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(sys.argv[1], *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


os.environ.update(BENCH_REPLICAS="1", BENCH_ROUNDS="1")
assert script("bench_torch", "bench_torch.py").main("cpu")["value"] > 0
table = script("bench_all_torch", "tools", "bench_all_torch.py")
s1, p1, x1, _ = bench_systems.build_backbone_system(device="cpu")
assert table.md_steps_per_sec(s1, p1, x1, 1, 1) > 0
rex_example = script("replica_exchange_torch", "examples",
                     "replica_exchange_torch.py")
with tempfile.TemporaryDirectory() as tmp:
    assert len(rex_example.main([tmp, "--n-replica", "2", "--duration",
                                 "0.054", "--device", "cpu"])) == 2
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "h5py", "upside_md_tpu")]
assert not bad, bad
print("isolated ok")
"""


def test_port_imports_without_jax_h5py_or_reference():
    r = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT, ROOT, TRP,
                        os.path.join(DATA_DIR, "trp_cage_extras_synth.npz"),
                        os.path.join(DATA_DIR, "ubiquitin_chi1_synth.npz")],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "isolated ok" in r.stdout
    # the repo-level scripts, in a process of their own
    r = subprocess.run([sys.executable, "-c", BLOCKED_SCRIPTS, ROOT],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu",
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "isolated ok" in r.stdout
