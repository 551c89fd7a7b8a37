"""Write the port's full-force-field system bundles from synthetic libraries.

The port (`upside_md_torch`) reads systems from numpy spec bundles, because
the machine that runs it has neither h5py nor jax.  This script builds each
system through the JAX package's own config builder and reader, exactly as
`upside_md_tpu.bench_systems.build_full_system` does (rotamer damping 0.1,
`dynamic_1body=True`, hbond energy -2.1119, hbond coverage and hydrophobes,
the environment/burial chain, the rotamer node), and converts the loaded
specs with `upside_md_torch.convert.from_jax_specs`.

The shipped parameter libraries are not part of the repository, so the
libraries are synthetic, made from a numpy seed in the real layout:

* sidechain library: the 20 standard restypes, one bead per rotamer, and
  1, 3 or 6 rotamers for residues with 0, 1 or >= 2 chi angles
  (`sidechain_topology.N_CHI`).  Bead centers sit along the CB direction
  with a seeded scatter; directions are unit vectors near it.  Rotamer
  probabilities on the 36x36 Rama grid are smooth (a softmax of low-order
  cosines of phi and psi), so the dynamic 1-body energies are smooth.
* pair table (20, 20, 2*8 + 2*9) in the default SC_SC knot family
  (8 angular knots, 9 distance knots, dx = 1): angular splines near 1, a
  repulsive `wide` and an attractive `narrow` distance profile whose last
  three knots are zero, so the energy reaches 0 at the cutoff.
* coverage (2, 20, 2*8 + 2*7) and hydrophobe (3, 20, 2*8 + 2*7) tables in
  the SC_BB family (7 distance knots), with positive coverage profiles, and
  a (3, 7) hydrophobe placement (point, unit vector, scalar).
* environment library: `coverage_param` (20, 1, 4) = (r0, r_sharp, dot0,
  dot_sharp), `energies` (20, 16) clamped-spline coefficients of burial
  with attrs `offset` 0 and `inv_dx` 0.5, and `restype_order`.
* Ramachandran maps: smooth per-residue mixtures of alpha, beta and
  left-handed wells on the 72x72 grid.  (White-noise maps, the bench
  fallback, give a Rama energy of order 1e5 on the initial structure.)
* the sidechain library also carries `rotamer_prob_fixed` (the fixed
  1-body energies `dynamic_1body=False` reads: -log of each rotamer's
  mean probability over the Rama grid) and `restype_and_chi_and_state`
  (rotamer state s of a restype at chi1 = 60, 180 or 300 degrees for s
  mod 3), the chi1 table; neither changes the older bundles.
* from a second seed: a sidechain-radial library (`names`, and
  `interaction_param` (20, 20, 17), symmetric rows [inv_dx 1.5, 16
  knots] of a repulsive core and an attractive well that reach 0 at the
  cutoff), a membrane library (`names` with NON, `cb_energy` (21, 101)
  and `uhb_energy` (2, 101) on z in [-25, 25] at thickness 30,
  `cov_midpoint`, `cov_sharpness`) and a torus-DBN library
  (`restype_order` with CPR, `basin_param` (6, 6), `aa_basin_energy`
  (21, 6), `transition_energy` (6, 6)).

Run from the repository root (needs jax and h5py):

    python tools/export_torch_bundle.py [--out DIR] [--only NAME ...]
        [--keep-up]
    python tools/export_torch_bundle.py --up CONFIG.up [--name NAME] [--out DIR]

The second form converts a `.up` config the user wrote (any system the
JAX reader loads) into `NAME.npz`, the same chain the synthetic systems
take: `load_system` -> `convert.from_jax_specs` -> `bundle.save`.
`--keep-up` keeps each built system's `.up` beside its bundle as
`NAME.up` (the committed `ubiquitin_full_synth.up` is that file of the
build that wrote the committed bundle; the port reads it with
`upside_md_torch/config/reader.py`, no h5py or jax needed).

The first form writes `ubiquitin_full_synth.npz` (76 residues),
`trp_cage_full_synth.npz` (20 residues), `rnase_a_full_synth.npz`
(124-residue bovine ribonuclease A, 543 sidechain beads: above the fused
block's 512-bead cap, so the port runs its unfused path),
`ubiquitin_noenv_synth.npz` and `cytochrome_c_full_synth.npz` (104-residue
horse cytochrome c, `bench_systems.CYT_C`, 489 beads: the system of the
Hamiltonian replica-exchange configuration, tools/bench_all.py:103-160),
`t4_lysozyme_full_synth.npz` (164-residue T4 lysozyme, 770 beads: the
unfused path with more than 128 rotamer residues) and `gfp_full_synth.npz`
(238-residue GFP, 1,143 beads: the neighbour-list pair path above 1,024
beads) into `upside_md_torch/data/`.  Each bundle carries the reader's Monte
Carlo move tables (`load_system`'s fourth value) as its aux section.  The
`_noenv` bundles are built the same way but without `add_environment`, as
`build_full_system` builds a system when the environment library is
absent: the fused pair block then runs without its env band, and its
backward is the recomputing one (K3).  `--only trp_cage_noenv_synth`
builds the trp-cage one, which the tests build for themselves.

Three more bundles carry the node types the older ones do not use:

* `ubiquitin_radial_synth.npz`: BASELINE config 2, the ubiquitin full
  force field with `add_sidechain_radial` on the CB placement;
* `ubiquitin_chi1_synth.npz`: BASELINE config 5, the prediction config of
  `chi1.predict_chi1_from_pdb` (chi1.py:96-105: rotamer damping 0.4,
  dynamic 1-body, loose hbond -1e-5 with coverage, the rotamer node) on
  ubiquitin, with the aux section `chi1` (the library's `restype_order`
  and `restype_and_chi_and_state`, and the sequence);
* `trp_cage_extras_synth.npz`: trp-cage built with `dynamic_1body=False`
  and every builder extra: `radial`, four `contact` pairs,
  `cavity_radial`, `z_flat_bottom`, `tension`, `AFM`,
  `membrane_potential` (thickness 30) and `torus_dbn` -> `fixed_hmm`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RESTYPES = ['ALA', 'ARG', 'ASN', 'ASP', 'CYS', 'GLN', 'GLU', 'GLY', 'HIS',
            'ILE', 'LEU', 'LYS', 'MET', 'PHE', 'PRO', 'SER', 'THR', 'TRP',
            'TYR', 'VAL']
KA, K_PAIR, K_COV = 8, 9, 7
N_BIN = 36
LIB_SEED = 2024

# bovine pancreatic ribonuclease A, mature chain (UniProt P61823, PDB 7RSA)
RNASE_A = ("KETAAAKFERQHMDSSTSAASSSNYCNQMMKSRNLTKDRCKPVNTFVHESLADVQAVCSQKNVA"
           "CKNGQTNCYQSYSTMSITDCRETGSSKYPNCAYKTTQANKHIIVACEGNPYVPVHFDASV")

# bacteriophage T4 lysozyme, wild type (UniProt P00720, PDB 2LZM)
T4_LYSOZYME = ("MNIFEMLRIDEGLRLKIYKDTEGYYTIGIGHLLTKSPSLNAAKSELDKAIGRNCNGVITKDEAEK"
               "LFNQDVDAAVRGILRNAKLKPVYDSLDAVRRCALINMVFQMGETGVAGFTNSLRMLQQKRWDEA"
               "AVNLAKSRWYNQTPNRAKRVITTFRTGTWDAYKNL")
# green fluorescent protein of Aequorea victoria (UniProt P42212)
GFP = ("MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSY"
       "GVQCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKED"
       "GNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHY"
       "LSTQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK")

# bundle name -> sequence, or the name of a sequence in bench_systems
SYSTEMS = {
    "ubiquitin_full_synth": "UBIQUITIN",
    "trp_cage_full_synth": "TRP_CAGE",
    "rnase_a_full_synth": RNASE_A,
    "ubiquitin_noenv_synth": "UBIQUITIN",
    "trp_cage_noenv_synth": "TRP_CAGE",
    "cytochrome_c_full_synth": "CYT_C",
    "t4_lysozyme_full_synth": T4_LYSOZYME,
    "gfp_full_synth": GFP,
    "ubiquitin_radial_synth": "UBIQUITIN",
    "ubiquitin_chi1_synth": "UBIQUITIN",
    "trp_cage_extras_synth": "TRP_CAGE",
}
# (residues, rotamer beads) the synthetic library gives the large systems:
# T4 lysozyme runs the dense unfused path past 128 residues, GFP the
# neighbour lists past 1,024 beads
SIZES = {"t4_lysozyme_full_synth": (164, 770),
         "gfp_full_synth": (238, 1143)}
# bundles built without the environment/burial chain, as build_full_system
# builds a system when no environment library exists
NO_ENV = {"ubiquitin_noenv_synth", "trp_cage_noenv_synth"}
# what `main` writes by default; the trp-cage no-env bundle is built by the
# tests where they need it
COMMITTED = ("ubiquitin_full_synth", "trp_cage_full_synth",
             "rnase_a_full_synth", "ubiquitin_noenv_synth",
             "cytochrome_c_full_synth", "t4_lysozyme_full_synth",
             "gfp_full_synth", "ubiquitin_radial_synth",
             "ubiquitin_chi1_synth", "trp_cage_extras_synth")
# the seed of the libraries the older bundles do not read
EXTRA_LIB_SEED = 2025
MEMBRANE_THICKNESS = 30.0


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def write_sidechain_library(path, rng):
    from upside_md_tpu.param_gen import write_placement_library
    from upside_md_tpu.sidechain_topology import N_CHI

    grid = -np.pi + 2 * np.pi * np.arange(N_BIN) / N_BIN
    phi, psi = np.meshgrid(grid, grid, indexing="ij")
    cb_dir = _unit(np.array([0.0, 0.94375626, 1.2068012]))
    data = {}
    for rt in RESTYPES:
        n_chi = N_CHI[rt]
        n_rot = 1 if n_chi == 0 else (3 if n_chi == 1 else 6)
        c = np.zeros((n_rot, 6))
        reach = 1.6 + 0.35 * min(n_chi, 4)
        c[:, 0:3] = reach * cb_dir + 0.7 * rng.normal(size=(n_rot, 3))
        c[:, 3:6] = _unit(cb_dir + 0.5 * rng.normal(size=(n_rot, 3)))
        amp = 0.8 * rng.normal(size=(n_rot, 4))
        logit = (amp[:, 0, None, None] * np.cos(phi)
                 + amp[:, 1, None, None] * np.sin(phi)
                 + amp[:, 2, None, None] * np.cos(psi)
                 + amp[:, 3, None, None] * np.sin(psi))
        p = np.exp(logit - logit.max(0))
        probs = np.moveaxis(p / p.sum(0), 0, -1)          # (36, 36, n_rot)
        # [chi1, chi2, state]: state s in the chi1 well of s mod 3
        chi = [[np.deg2rad(60.0 + 120.0 * (s % 3)), 0.0, s]
               for s in range(n_rot)]
        data[rt] = {"centers": c, "n_bead": 1, "probs": probs,
                    "chi_table": chi}
    write_placement_library(path, data)

    import h5py
    n_type = len(RESTYPES)
    with h5py.File(path, "a") as f:
        f.create_dataset("rotamer_prob_fixed", data=-np.log(
            np.asarray(f["rotamer_prob"]).mean((0, 1))))
        pair = np.zeros((n_type, n_type, 2 * KA + 2 * K_PAIR))
        pair[..., :2 * KA] = 1.0 + 0.15 * rng.normal(size=(n_type, n_type,
                                                            2 * KA))
        wide = np.array([3.0, 2.0, 1.0, 0.35, -0.15, -0.1, 0.0, 0.0, 0.0])
        narrow = np.array([-0.4, -0.7, -0.6, -0.35, -0.12, -0.03,
                           0.0, 0.0, 0.0])
        s = rng.uniform(0.5, 1.5, size=(n_type, n_type, 2))
        pair[..., 2 * KA:2 * KA + K_PAIR] = s[..., :1] * wide
        pair[..., 2 * KA + K_PAIR:] = s[..., 1:] * narrow
        f.create_dataset("pair_interaction", data=pair)

        def coverage_table(n_row):
            t = np.zeros((n_row, n_type, 2 * KA + 2 * K_COV))
            t[..., :2 * KA] = 1.0 + 0.15 * rng.normal(
                size=(n_row, n_type, 2 * KA))
            prof = np.array([1.0, 0.9, 0.7, 0.35, 0.0, 0.0, 0.0])
            sc = rng.uniform(0.1, 0.6, size=(n_row, n_type, 2))
            t[..., 2 * KA:2 * KA + K_COV] = sc[..., :1] * prof
            t[..., 2 * KA + K_COV:] = sc[..., 1:] * prof
            return t

        f.create_dataset("coverage_interaction", data=coverage_table(2))
        f.create_dataset("hydrophobe_interaction", data=coverage_table(3))
        hp = np.zeros((3, 7))
        hp[:, 0:3] = 1.2 * rng.normal(size=(3, 3))
        hp[:, 3:6] = _unit(rng.normal(size=(3, 3)))
        hp[:, 6] = rng.uniform(0.0, 1.0, 3)
        f.create_dataset("hydrophobe_placement", data=hp)
    return path


def write_environment_library(path, rng):
    import h5py
    n_type = len(RESTYPES)
    cov = np.zeros((n_type, 1, 4))
    cov[:, 0, 0] = rng.uniform(5.0, 6.5, n_type)      # r0
    cov[:, 0, 1] = rng.uniform(0.6, 1.0, n_type)      # r_sharp
    cov[:, 0, 2] = rng.uniform(0.0, 0.3, n_type)      # dot0
    cov[:, 0, 3] = rng.uniform(1.2, 2.0, n_type)      # dot_sharp
    n_coeff = 16
    x = np.arange(n_coeff)
    slope = rng.uniform(-0.08, 0.08, n_type)
    energies = slope[:, None] * (x[None, :] - 6.0) \
        + 0.05 * np.cos(0.5 * x[None, :] + rng.uniform(0, 2 * np.pi,
                                                         (n_type, 1)))
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("energies", data=energies)
        ds.attrs["offset"] = 0.0
        ds.attrs["inv_dx"] = 0.5
        f.create_dataset("restype_order", data=np.asarray(RESTYPES, "S"))
        f.create_dataset("coverage_param", data=cov)
    return path


def write_radial_library(path, rng):
    """Sidechain-radial library as `add_sidechain_radial` reads it:
    `names` and symmetric `interaction_param` rows [inv_dx, 16 knots]."""
    import h5py
    n_type = len(RESTYPES)
    knots = np.array([3.0, 1.6, 0.7, 0.15, -0.25, -0.45, -0.5, -0.42,
                      -0.3, -0.18, -0.09, -0.03, -0.01, 0.0, 0.0, 0.0])
    scale = rng.uniform(0.3, 1.0, size=(n_type, n_type))
    scale = 0.5 * (scale + scale.T)
    param = np.zeros((n_type, n_type, 17))
    param[..., 0] = 1.5                       # cutoff 14 / 1.5 = 9.3 A
    param[..., 1:] = scale[..., None] * knots
    with h5py.File(path, "w") as f:
        f.create_dataset("names", data=np.asarray(RESTYPES, "S"))
        f.create_dataset("interaction_param", data=param)
    return path


def write_membrane_library(path, rng):
    """Membrane library as `add_membrane_potential` reads it (the layout
    of tests/test_membrane_rescale.py)."""
    import h5py
    z = np.linspace(-25.0, 25.0, 101)
    names = RESTYPES + ["NON"]
    n = len(names)
    depth = rng.uniform(-0.6, 0.6, size=(n, 1))
    cb = depth * np.exp(-(z / 12.0) ** 2) \
        + 0.05 * np.sin(z / 6.0 + rng.uniform(0, np.pi, size=(n, 1)))
    uhb = np.stack([1.2 * np.exp(-(z / 10.0) ** 2),
                    0.9 * np.exp(-(z / 11.0) ** 2)])
    with h5py.File(path, "w") as f:
        f.create_dataset("names", data=np.asarray(names, "S"))
        for key, data in (("cb_energy", cb), ("uhb_energy", uhb)):
            d = f.create_dataset(key, data=data)
            d.attrs["z_min"], d.attrs["z_max"] = -25.0, 25.0
        f["cb_energy"].attrs["thickness"] = MEMBRANE_THICKNESS
        f.create_dataset("cov_midpoint", data=rng.uniform(1.0, 3.0, n))
        f.create_dataset("cov_sharpness", data=rng.uniform(0.5, 1.5, n))
    return path


def write_torus_library(path, rng):
    """Torus-DBN library as `add_torus_dbn` reads it: six basins of
    (phi, psi) with von-Mises concentrations."""
    import h5py
    order = RESTYPES + ["CPR"]
    centers = np.array([[-1.1, -0.8], [-2.1, 2.3], [1.0, 0.8],
                        [-1.4, 2.6], [-1.6, -0.4], [1.2, -2.9]])
    basin = np.zeros((6, 6))
    basin[:, 0] = rng.uniform(-1.0, 1.0, 6)            # log_norm
    basin[:, 1] = rng.uniform(1.0, 4.0, 6)             # kappa_phi
    basin[:, 2] = centers[:, 0]
    basin[:, 3] = rng.uniform(1.0, 4.0, 6)             # kappa_psi
    basin[:, 4] = centers[:, 1]
    basin[:, 5] = rng.uniform(-0.5, 0.5, 6)            # kappa_cor
    with h5py.File(path, "w") as f:
        f.create_dataset("restype_order", data=np.asarray(order, "S"))
        f.create_dataset("basin_param", data=basin)
        f.create_dataset("aa_basin_energy",
                         data=rng.normal(scale=0.5, size=(len(order), 6)))
        f.create_dataset("transition_energy",
                         data=rng.normal(scale=0.7, size=(6, 6)))
    return path


def smooth_rama_maps(n_res, rng, n_grid=72):
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


def build_bundle(name, out_dir, lib_dir, keep_up=False):
    """Build one system the way build_full_system does; write its bundle,
    and with `keep_up` the `.up` it was exported from beside it."""
    from upside_md_tpu import bench_systems
    from upside_md_tpu.config.builder import ConfigBuilder

    rng = np.random.default_rng(LIB_SEED)
    sidechain = write_sidechain_library(
        os.path.join(lib_dir, "sidechain_synth.h5"), rng)
    environment = write_environment_library(
        os.path.join(lib_dir, "environment_synth.h5"), rng)

    seq = SYSTEMS[name]
    seq = getattr(bench_systems, seq) if hasattr(bench_systems, seq) else seq
    b = ConfigBuilder(f">x\n{seq}\n", seed=1)
    aux = None
    if name == "ubiquitin_chi1_synth":
        # chi1.py:96-105: no springs or sterics, loose hbond criteria
        b.add_rotamer_sidechains(sidechain, sidechain, damping=0.4,
                                 dynamic_1body=True)
        b.add_hbond(hbond_energy=-1e-5, loose=True,
                    coverage_library=sidechain)
        b.add_rotamer_node()
        import h5py
        with h5py.File(sidechain, "r") as f:
            aux = {"chi1": {
                "restype_order": np.asarray(f["restype_order"]).astype(
                    str),
                "restype_and_chi_and_state": np.asarray(
                    f["restype_and_chi_and_state"])}}
    else:
        b.add_backbone_springs()
        b.add_rama_map_pot(smooth_rama_maps(b.n_res, rng))
        b.add_backbone_pairs()
        # the extras bundle takes the fixed 1-body placement_fixed_scalar
        fixed = name == "trp_cage_extras_synth"
        b.add_rotamer_sidechains(sidechain, sidechain, damping=0.1,
                                 dynamic_1body=not fixed)
        b.add_hbond(hbond_energy=-2.1119, coverage_library=sidechain)
        if name not in NO_ENV:
            b.add_environment(environment)
        b.add_rotamer_node()
    if name in ("ubiquitin_radial_synth", "trp_cage_extras_synth"):
        add_extras(b, name, lib_dir)
    up = os.path.join(lib_dir, f"{name}.up")
    b.write(up)
    if keep_up:
        shutil.copyfile(up, os.path.join(out_dir, f"{name}.up"))
    # the committed bundles carry no sequence section
    path = export_up(up, os.path.join(out_dir, f"{name}.npz"), aux,
                     sequence=False)
    if name in SIZES:
        got = (len(seq), rotamer_beads(path))
        if got != SIZES[name]:
            raise ValueError(f"{name}: {got} residues and rotamer beads, "
                             f"expected {SIZES[name]}")
    return path


def add_extras(b, name, lib_dir):
    """The builder extras of the radial and extras bundles, from libraries
    of EXTRA_LIB_SEED."""
    rng = np.random.default_rng(EXTRA_LIB_SEED)
    b.add_sidechain_radial(write_radial_library(
        os.path.join(lib_dir, "radial_synth.h5"), rng))
    if name != "trp_cage_extras_synth":
        return
    membrane = write_membrane_library(
        os.path.join(lib_dir, "membrane_synth.h5"), rng)
    torus = write_torus_library(os.path.join(lib_dir, "torus_synth.h5"), rng)
    n = b.n_res
    # the four closest CA pairs at sequence separation 3 or more, each
    # inside its sigmoid's transition
    ca = b.pos[1::3]
    d = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
    i, j = np.triu_indices(n, 3)
    ids = np.stack([i, j], 1)[np.argsort(d[i, j])[:4]]
    b.add_contacts(ids, energy=rng.uniform(-1.5, -0.5, len(ids)),
                   distance=d[ids[:, 0], ids[:, 1]] + 0.5,
                   width=np.full(len(ids), 2.0))
    # a few atoms outside the cavity
    r = np.linalg.norm(b.pos, axis=-1)
    b.add_cavity_radial(radius=float(np.quantile(r, 0.9)),
                        spring_constant=5.0)
    b.add_z_flat_bottom([(3, 0.0, 2.0, 1.0), (n - 4, 1.0, 1.5, 1.0)])
    b.add_tension([(0, 0.05, 0.0, -0.02), (n - 1, -0.05, 0.0, 0.02)])
    tip = b.pos[3 * (n - 1) + 1] + np.array([1.0, 0.0, 0.0])
    b.add_afm([(n - 1, 2.0, *tip, 0.5, 0.0, 0.0)])
    b.add_membrane_potential(membrane, MEMBRANE_THICKNESS)
    b.add_torus_dbn(torus)


def export_up(up, path, extra_aux=None, sequence=True):
    """Convert the `.up` config `up` into the bundle `path`: the JAX
    reader's specs, initial positions and Monte Carlo move tables, with
    `sequence` the `.up`'s input/sequence (where it has one) as the aux
    section `input` (the command line writes it to each trajectory file),
    and the aux sections `extra_aux` as they are."""
    from upside_md_tpu.config.reader import load_system
    from upside_md_torch.config import bundle
    from upside_md_torch.config.reader import AUX_SECTIONS
    from upside_md_torch.convert import from_jax_specs

    system, _, pos, aux = load_system(up)
    records, pos = from_jax_specs(system.specs, pos)
    # float tables in float32, the precision the samplers keep them in
    # (mc.py:46-50): the float64 proposal map alone would double the file
    tables = {sec: {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                    for k, v in aux[sec].items()}
              for sec in AUX_SECTIONS if sec in aux}
    if sequence and "sequence" in aux:
        tables["input"] = {"sequence": np.asarray(aux["sequence"], "S")}
    if extra_aux:
        for sec, t in extra_aux.items():
            tables[sec] = dict(t)
        if "chi1" in extra_aux:
            tables["chi1"]["sequence"] = np.asarray(aux["sequence"])
    bundle.save(path, records, pos, tables)
    return path


def rotamer_beads(path):
    """Sidechain beads of the bundle's rotamer node (0 without one)."""
    from upside_md_torch.config import bundle
    return sum(len(s.consts["index"]) for s in bundle.load(path)[0]
               if s.type_name == "rotamer")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "upside_md_torch",
                                                  "data"))
    ap.add_argument("--only", nargs="*", choices=sorted(SYSTEMS))
    ap.add_argument("--up", help="export this .up config instead of the "
                    "synthetic systems")
    ap.add_argument("--name", help="bundle name of --up (default: the "
                    ".up file's name)")
    ap.add_argument("--keep-up", action="store_true",
                    help="also write each built system's .up beside its "
                    "bundle (NAME.up)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.up:
        if args.only:
            ap.error("--up and --only exclude each other")
        name = args.name or os.path.splitext(os.path.basename(args.up))[0]
        path = export_up(args.up, os.path.join(args.out, f"{name}.npz"))
        print(f"{path}: {os.path.getsize(path)} bytes")
        return
    with tempfile.TemporaryDirectory() as lib_dir:
        for name in args.only or COMMITTED:
            path = build_bundle(name, args.out, lib_dir, args.keep_up)
            print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
