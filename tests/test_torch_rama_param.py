"""`rama_map_pot`'s flat-parameter hooks (`upside_md_torch/nodes/rama.py`)
against the JAX package's (rama.py:57-68), on the CPU in float64.

The flat parameters are the raw Rama map.  A system read from a `.up`
keeps the file's map; one read from a bundle, which drops it, rebuilds it
from the float32 coefficients by the spline's interpolation identity.

* `get_param`: equal to JAX's `Upside.get_param` from a `.up`, within rel
  1e-6 of the map's largest |value| from the exported bundle;
* `set_param` of a new map: the coefficients equal JAX's, the energy
  within rel 1e-6 of JAX's, and `get_param` returns the new map, from
  either input; `set_param(get_param())` on a bundle leaves the energy
  within rel 1e-6;
* the command line's `--set-param` with a `rama_map_pot` entry, written
  by `io/h5.Writer`, refits as JAX's `set_param` does;
* the host fits and the knot values: `periodic_bspline_2d_knot_values`
  inverts `fit_periodic_bspline_2d`, and each fit of `ops/spline.py`
  equals the JAX package's bit for bit.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.config.reader import load_system
from upside_md_tpu.engine import Upside as JUpside
from upside_md_tpu.ops import spline as jspline
from upside_md_torch import cli
from upside_md_torch.engine import Upside
from upside_md_torch.io import h5
from upside_md_torch.ops import spline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "rama_map_pot"


@pytest.fixture(scope="module")
def trp(tmp_path_factory):
    """(trp-cage's .up, the bundle exported from it, a perturbed
    structure)."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tmp = tmp_path_factory.mktemp("rama")
    (tmp / "lib").mkdir()
    npz = tool.build_bundle("trp_cage_full_synth", str(tmp),
                            str(tmp / "lib"), keep_up=True)
    up = npz[:-len(".npz")] + ".up"
    _, _, jpos, _ = load_system(up)
    P = np.asarray(jpos, np.float64) + 0.05 * np.random.default_rng(1) \
        .normal(size=jpos.shape)
    return up, npz, P


def jax_engine(up):
    js, jp, _, _ = load_system(up)
    return JUpside(js, jp)


def port_engine(path):
    return Upside(path, device="cpu", dtype=torch.float64)


def test_get_param_from_up_is_jax_raw_map(trp):
    up, _, _ = trp
    want = jax_engine(up).get_param(NODE)
    got = port_engine(up).get_param(NODE)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_get_param_from_bundle_rebuilds_raw_map(trp):
    up, npz, _ = trp
    want = jax_engine(up).get_param(NODE)
    got = port_engine(npz).get_param(NODE)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("source", ["up", "bundle"])
def test_set_param_matches_jax(trp, source):
    up, npz, P = trp
    jeng = jax_engine(up)
    raw = jeng.get_param(NODE)
    new = raw + 0.2 * np.random.default_rng(3).normal(size=raw.shape)
    jeng.set_param(new, NODE)
    e_want = jeng.energy(jnp.asarray(P))
    eng = port_engine(up if source == "up" else npz)
    eng.set_param(new, NODE)
    np.testing.assert_array_equal(
        eng.params[NODE]["coeffs"].numpy(),
        np.asarray(jeng.params[NODE]["coeffs"], np.float64))
    np.testing.assert_array_equal(eng.get_param(NODE), jeng.get_param(NODE))
    e_got = eng.energy(P)
    assert abs(e_got - e_want) <= 1e-6 * abs(e_want)


def test_set_param_of_get_param_keeps_the_energy(trp):
    _, npz, P = trp
    eng = port_engine(npz)
    e0 = eng.energy(P)
    eng.set_param(eng.get_param(NODE), NODE)
    assert abs(eng.energy(P) - e0) <= 1e-6 * abs(e0)


def test_cli_set_param_refits_the_map(trp, tmp_path):
    up, npz, _ = trp
    jeng = jax_engine(up)
    new = 1.1 * jeng.get_param(NODE)
    jeng.set_param(new, NODE)
    path = str(tmp_path / "p.h5")
    with h5.Writer(path) as w:
        w.create_dataset(NODE, new)
    args = cli.parser().parse_args(["--duration=1", "--frame-interval=1",
                                    "--device=cpu", f"--set-param={path}",
                                    up, npz])
    system, params, spec, _, _ = cli.load_ensemble(args)
    assert not spec and params is system.params
    np.testing.assert_array_equal(params[NODE]["coeffs"].numpy(),
                                  np.asarray(jeng.params[NODE]["coeffs"]))
    np.testing.assert_array_equal(system.consts[NODE]["raw_map"].ravel(),
                                  jeng.get_param(NODE))


def test_host_fits_equal_jax_bit_for_bit():
    rng = np.random.default_rng(7)
    maps = rng.normal(size=(3, 24, 18))
    c = spline.fit_periodic_bspline_2d(maps)
    np.testing.assert_array_equal(c, jspline.fit_periodic_bspline_2d(maps))
    np.testing.assert_allclose(spline.periodic_bspline_2d_knot_values(c),
                               maps, rtol=0, atol=1e-12)
    rows = rng.normal(size=(4, 30))
    np.testing.assert_array_equal(spline.fit_periodic_bspline_1d(rows),
                                  jspline.fit_periodic_bspline_1d(rows))
    np.testing.assert_array_equal(spline.fit_clamped_interp_bspline(rows),
                                  jspline.fit_clamped_interp_bspline(rows))
    # the clamped fit interpolates: its spline at the data points
    val, _ = spline.eval_clamped_interp(
        torch.as_tensor(spline.fit_clamped_interp_bspline(rows))[:, None],
        torch.arange(30, dtype=torch.float64)[None, :].expand(4, 30))
    np.testing.assert_allclose(val.numpy(), rows, atol=1e-12)
