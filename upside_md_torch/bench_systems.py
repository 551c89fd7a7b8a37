"""The BASELINE configurations, built by the port (counterpart of
upside_md_tpu/bench_systems.py).

Each builder assembles a `.up` with the port's `config/builder.py`, writes
it into a temporary directory, reads it back with `config.reader.load_up`
and returns (system, params, pos, aux): a `System` on the card unless
`device="cpu"`, its parameters, the initial positions (n_atom, 3) as a
tensor on that device, and the file's aux sections.  No jax or h5py.

Parameter libraries: the reference's under $UPSIDE_PARAM_DIR when it is
set and holds them (`have_reference_params`), otherwise the committed
synthetic libraries (`upside_md_torch/data/libs`, the real layout).  No
10 Å library is committed: without the reference's,
`synthetic_10A_library` writes one at run time from the synthetic
sidechain library.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import LIB_DIR
from .config.builder import ConfigBuilder, uniform_rama_maps_from_reference
from .config.reader import load_up
from .io import h5
from .ops.pairs import quadspline_family
from .system import System

PARAM_DIR = os.environ.get("UPSIDE_PARAM_DIR")


def _ref(*parts):
    return os.path.join(PARAM_DIR, *parts) if PARAM_DIR else None


RAMA_REF = _ref("common", "rama_reference.pkl")
SIDECHAIN = _ref("ff_1", "sidechain.h5")
SIDECHAIN_10A = _ref("packing", "sidechain_10A_cutoff.h5")
ENVIRONMENT = _ref("ff_1", "environment.h5")
SIDECHAIN_SYNTH = os.path.join(LIB_DIR, "sidechain_synth.h5")
ENVIRONMENT_SYNTH = os.path.join(LIB_DIR, "environment_synth.h5")

TRP_CAGE = "NLYIQWLKDGGPSSGRPPPS"                       # 1L2Y, 20 res
UBIQUITIN = ("MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQ"
             "QRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG")     # 1UBQ, 76 res
PROTEIN_G = "MTYKLILNGKTLKGETTTEAVDAATAEKVFKQYANDNGVDGEWTYDDATKTFTVTE"
# horse cytochrome c, 104 res: the "~100-res protein" of BASELINE config 4
CYT_C = ("GDVEKGKKIFVQKCAQCHTVEKGGKHKTGPNLHGLFGRKTGQAPGFTYTDANKNKGITW"
         "KEETLMEYLENPKKYIPGTKMIFAGIKKKTEREDLIAYLKKATNE")

# the PARAM_10A_CUTOFF family of directional-bead splines (ops/pairs.py)
FAMILY_10A = (8, 12, 1.0)
TABLES_10A = ("pair_interaction", "coverage_interaction",
              "hydrophobe_interaction")


def _exists(path):
    return path is not None and os.path.exists(path)


def have_reference_params():
    return _exists(SIDECHAIN) and _exists(RAMA_REF)


def _rama_maps(n_res):
    if _exists(RAMA_REF):
        return uniform_rama_maps_from_reference(n_res, RAMA_REF)
    rng = np.random.default_rng(0)
    base = 0.5 * rng.normal(size=(1, 72, 72))
    return np.tile(base, (n_res, 1, 1))


def smooth_rama_maps(n_res, rng, n_grid=72):
    """Synthetic Rama maps (n_res, n_grid, n_grid): the negative log of a
    mixture of three von Mises wells (helix, sheet, left-handed), with
    weights drawn per residue from `rng`; the maps the committed bundles
    were built with (tools/export_torch_bundle.py imports this)."""
    grid = -np.pi + 2 * np.pi * np.arange(n_grid) / n_grid
    phi, psi = np.meshgrid(grid, grid, indexing="ij")
    wells = np.array([[-1.1, -0.8], [-2.1, 2.3], [1.0, 0.8]])
    maps = np.empty((n_res, n_grid, n_grid))
    for r in range(n_res):
        w = rng.dirichlet([6.0, 5.0, 1.0])
        dens = sum(wk * np.exp(3.0 * (np.cos(phi - c[0]) - 1.0)
                               + 3.0 * (np.cos(psi - c[1]) - 1.0))
                   for wk, c in zip(w, wells))
        p = dens + 1e-3 * dens.max()
        maps[r] = -np.log(p / p.sum())      # negative log probability
    return maps


def example_rama_maps(n_res, seed=1):
    """The Rama maps of the examples: the reference's uniform maps when
    its libraries are present, otherwise `smooth_rama_maps` (never the
    white-noise map of `_rama_maps`, whose rama_map_pot is ~1e5)."""
    if _exists(RAMA_REF):
        return uniform_rama_maps_from_reference(n_res, RAMA_REF)
    return smooth_rama_maps(n_res, np.random.default_rng(seed))


def build_backbone_system(seq=TRP_CAGE, hbond_energy=-2.1119, seed=1,
                          device="cuda"):
    """BASELINE config 1: constant-T backbone potential (bonds + Rama map +
    HBond + steric)."""
    b = ConfigBuilder(f">x\n{seq}\n", seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(_rama_maps(b.n_res))
    b.add_backbone_pairs()
    b.add_hbond(hbond_energy=hbond_energy)
    return _write_and_load(b, device)


def build_full_system(seq=UBIQUITIN, hbond_energy=-2.1119, seed=1,
                      sidechain_lib=None, environment_lib=None,
                      device="cuda"):
    """BASELINE config 2: full forcefield with rotamer BP sidechains,
    hbond coverage + hydrophobes, and the environment/burial chain (when
    the environment library exists)."""
    return _write_and_load(full_builder(seq, hbond_energy, seed,
                                        sidechain_lib, environment_lib),
                           device)


def full_builder(seq=UBIQUITIN, hbond_energy=-2.1119, seed=1,
                 sidechain_lib=None, environment_lib=None, rama_maps=None):
    """The `ConfigBuilder` of `build_full_system`, not yet written; Rama
    maps `rama_maps` in place of `_rama_maps`' when given."""
    ref = have_reference_params()
    sidechain_lib = sidechain_lib or (SIDECHAIN if ref else SIDECHAIN_SYNTH)
    environment_lib = environment_lib or (ENVIRONMENT if ref
                                          else ENVIRONMENT_SYNTH)
    b = ConfigBuilder(f">x\n{seq}\n", seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(_rama_maps(b.n_res) if rama_maps is None
                       else rama_maps)
    b.add_backbone_pairs()
    # damping 0.1: the solver schedule of the JAX package's builds (the
    # same fixed point as the reference default 0.4)
    b.add_rotamer_sidechains(sidechain_lib, sidechain_lib, damping=0.1,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=hbond_energy, coverage_library=sidechain_lib)
    if _exists(environment_lib):
        b.add_environment(environment_lib)
    b.add_rotamer_node()
    return b


def build_10A_system(seq=PROTEIN_G, seed=1, device="cuda"):
    """BASELINE config 3: the 10-Angstrom-cutoff parameter family (the
    reference needs a PARAM_10A_CUTOFF rebuild; the family is inferred
    from the table shapes at run time).  Without the reference's 10 Å
    library, one written by `synthetic_10A_library` into a temporary
    directory."""
    environment_lib = ENVIRONMENT if have_reference_params() \
        else ENVIRONMENT_SYNTH
    if _exists(SIDECHAIN_10A):
        return build_full_system(seq=seq, seed=seed,
                                 sidechain_lib=SIDECHAIN_10A,
                                 environment_lib=environment_lib,
                                 device=device)
    with tempfile.TemporaryDirectory() as tmp:
        lib = synthetic_10A_library(os.path.join(tmp, "sidechain_10A.h5"))
        return build_full_system(seq=seq, seed=seed, sidechain_lib=lib,
                                 environment_lib=environment_lib,
                                 device=device)


def extend_to_10A(table):
    """A directional-bead spline table (..., 2 ka + 2 k) in the
    (8, 12, 1.0) family: the angular knots kept, each distance spline's
    knots (wide, then narrow) extended with zeros to 12."""
    ka, k, _ = quadspline_family(table.shape[-1])
    ka10, k10, _ = FAMILY_10A
    if ka != ka10 or k > k10:
        raise ValueError(f"a table of the family {(ka, k)} does not extend "
                         f"to {FAMILY_10A}")
    pad = [(0, 0)] * (table.ndim - 1) + [(0, k10 - k)]
    wide = table[..., 2 * ka:2 * ka + k]
    narrow = table[..., 2 * ka + k:]
    return np.concatenate([table[..., :2 * ka], np.pad(wide, pad),
                           np.pad(narrow, pad)], -1)


def synthetic_10A_library(path, source=SIDECHAIN_SYNTH):
    """Write a sidechain library in the PARAM_10A_CUTOFF family at `path`:
    `source`'s members, with its pair, coverage and hydrophobe interaction
    tables rewritten by `extend_to_10A` (40 parameters).  Returns path."""
    with h5.File(source) as src, h5.Writer(path) as out:
        for name, node in src.items():
            if name in TABLES_10A:
                out.create_dataset(name, extend_to_10A(np.asarray(node[()])),
                                   node.attrs)
            else:
                out.copy(node, name)
    return path


def _write_and_load(builder, device="cuda", dtype=torch.float32):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "system.up")
        builder.write(path)
        records, pos, aux = load_up(path)
    system, pos = System.from_records(records, pos, device, dtype)
    return system, system.params, pos, aux
