"""The port's `upside_config` command line (`upside_md_torch/config/cli.py`)
against the JAX package's (`upside_md_tpu/config/cli.py`), on the CPU.

Each flag set (those of tests/test_config_cli.py and the rest of the flag
surface: chain breaks from a file with receptor/ligand chains, unbound
displacement, the heuristic cavity radius and the radius read from a
config, membrane, tension, AFM, sidechain radial, fixed rotamers, the
reference-state Rama map, a target structure) runs through both
command lines in process, to the same output path; the files must have
equal contents as h5py reads them back, /input/args included (the same
`sys.argv` gives the same invocation here).  Bad flag sets must exit
alike.
"""

import os
import pickle

import numpy as np
import pytest

from upside_md_torch.config import cli as pc
from upside_md_tpu.config import cli as jc

from test_torch_builder import TRP, assert_same_file, libs  # noqa: F401


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _pickle(tmp_path, name, a):
    p = tmp_path / name
    p.write_bytes(pickle.dumps(a))
    return str(p)


def _pos(n_res, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    n = 3 * n_res
    return (np.cumsum(rng.normal(size=(n, 3)), axis=0)
            + 3.0 * np.arange(n)[:, None] * np.array([1.0, 0, 0])
            + shift)[:, :, None].astype("f4")


def _flags(name, tmp_path, L):
    """(sequence, flags) of one flag set; files written in tmp_path."""
    sc, env = L["sidechain"], L["environment"]
    rot = ["--rotamer-placement", sc, "--rotamer-interaction", sc]
    n = len(TRP)
    if name == "backbone":
        return TRP, ["--hbond-energy", "-2.1"]
    if name == "full":
        bias = _write(tmp_path, "bias.dat",
                      "residue secstr energy\n2 helix -0.5\n4 sheet 0.3\n")
        return "ALGPALLGAL", [
            "--hbond-energy", "-2.1119", "--rama-library", L["rama"],
            "--rama-sheet-mixing-energy", "0.5", "--secstr-bias", bias,
            *rot, "--environment-potential", env,
            "--dynamic-rotamer-1body", "--rotamer-solve-damping", "0.4"]
    if name == "product_rule":
        return "ALGPALLGAL", [
            "--rama-library", L["rama"], "--rama-library-combining-rule",
            "product", "--loose-hbond-criteria", "--hbond-energy", "-1.0",
            "--hbond-exclude-residues", "2-3,7", "--seed", "3",
            "--bond-stiffness", "40", "--angle-stiffness", "150"]
    if name == "tables":
        zfb = _write(tmp_path, "zfb.dat",
                     "residue z0 radius spring_constant\n1 0.0 5.0 2.0\n")
        contacts = _write(tmp_path, "contacts.dat",
                          "residue1 residue2 energy distance "
                          "transition_width\n0 7 -1.5 8.0 2.0\n"
                          "2 12 -1.0 6.0 1.5\n")
        return TRP, ["--initial-structure", _pickle(tmp_path, "init.pkl",
                                                    _pos(n)),
                     "--z-flat-bottom", zfb, "--contact-energies", contacts,
                     "--restraint-group", "0-3", "--restraint-group",
                     "9-12,15", "--restraint-spring-constant", "3.0",
                     "--no-backbone"]
    if name == "torus_dbn":
        return TRP, ["--torus-dbn-library", L["torus"],
                     "--rama-sheet-library", L["torus"]]
    if name == "chains_unbound":
        breaks = _write(tmp_path, "breaks.dat", "7 14\n1 2\n")
        return TRP, ["--chain-break-from-file", breaks, "--hbond-energy",
                     "-2.0", "--initial-structure",
                     _pickle(tmp_path, "init.pkl", _pos(n, 1)),
                     "--apply-restraint-group-to-each-chain",
                     "--make-unbound", "--cavity-radius", "30"]
    if name == "chains_heuristic_cavity":
        breaks = _write(tmp_path, "breaks.dat", "10\n")
        return TRP, ["--chain-break-from-file", breaks,
                     "--debugging-only-heuristic-cavity-radius", "1.5",
                     "--apply-restraint-group-to-each-chain",
                     "--initial-structure",
                     _pickle(tmp_path, "init.pkl", _pos(n, 2)),
                     "--make-unbound"]
    if name == "tension":
        t = _write(tmp_path, "tension.dat", "residue tension_x tension_y "
                   "tension_z\n0 0.1 0 0\n19 -0.1 0 0\n")
        return TRP, ["--tension", t, "--debugging-only-disable-basic-springs"]
    if name == "afm":
        a = _write(tmp_path, "afm.dat", "residue spring_const tip_pos_x "
                   "tip_pos_y tip_pos_z pulling_vel_x pulling_vel_y "
                   "pulling_vel_z\n19 2.0 1.0 0.0 0.0 0.01 0.0 0.0\n")
        return TRP, ["--ask-before-using-AFM", a, "--AFM-time-initial", "2",
                     "--AFM-time-step", "0.01"]
    if name == "membrane":
        return TRP, [*rot, "--environment-potential", env,
                     "--hbond-energy", "-2.0", "--membrane-potential",
                     L["membrane"], "--membrane-thickness", "28",
                     "--membrane-exclude-residues", "2-3"]
    if name == "radial_fixed_rotamers":
        fix = _write(tmp_path, "fix.dat",
                     "residue restype rotamer\n2 TYR 1\n4 GLN 0\n")
        return TRP, [*rot, "--fix-rotamer", fix, "--sidechain-radial",
                     L["radial"], "--sidechain-radial-exclude-residues",
                     "0,5-6", "--hbond-energy", "-2.0"]
    if name == "reference_rama_target_cavity_from_config":
        src = str(tmp_path / "cavity_source.up")
        pc.main(["--fasta", _write(tmp_path, "src.fasta",
                                   f">s\n{TRP}\n"), "--output", src,
                 "--cavity-radius", "21.5"])
        return TRP, ["--reference-state-rama", _pickle(
            tmp_path, "ref.pkl", np.random.default_rng(5).uniform(
                0.5, 2.0, (72, 72))),
            "--target-structure", _pickle(tmp_path, "target.pkl",
                                          _pos(n, 4)),
            "--cavity-radius-from-config", src]
    raise KeyError(name)


FLAG_SETS = ["backbone", "full", "product_rule", "tables", "torus_dbn",
             "chains_unbound", "chains_heuristic_cavity", "tension", "afm",
             "membrane", "radial_fixed_rotamers",
             "reference_rama_target_cavity_from_config"]


@pytest.mark.parametrize("name", FLAG_SETS)
def test_upside_config_writes_the_jax_file(tmp_path, libs, name):  # noqa: F811
    seq, flags = _flags(name, tmp_path, libs)
    fasta = _write(tmp_path, "seq.fasta", f">test\n{seq}\n")
    out = str(tmp_path / "sys.up")
    argv = ["--fasta", fasta, "--output", out] + flags
    assert jc.main(argv) == out
    want = str(tmp_path / "jax.up")
    os.replace(out, want)
    assert pc.main(argv) == out
    assert_same_file(out, want)


BAD = {
    "restraint_without_structure": ["--restraint-group", "0-3"],
    "each_chain_without_breaks": ["--apply-restraint-group-to-each-chain"],
    "unbound_without_breaks": ["--make-unbound"],
    "dynamic_placement": ["--dynamic-rotamer-placement"],
    "environment_without_rotamers": ["--environment-potential", "x.h5"],
    "membrane_without_thickness": ["--membrane-potential", "x.h5"],
    "tension_and_afm": ["--tension", "T", "--ask-before-using-AFM", "A"],
    "bad_table_header": ["--z-flat-bottom", "HEADER"],
    "two_cavity_flags": ["--cavity-radius", "3",
                         "--cavity-radius-from-config", "x.up"],
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_flags_exit_alike(tmp_path, capsys, name):
    fasta = _write(tmp_path, "seq.fasta", f">t\n{TRP}\n")
    table = _write(tmp_path, "t.dat", "residue wrong header\n1 2 3\n")
    flags = [table if f in ("T", "A", "HEADER") else f for f in BAD[name]]
    argv = ["--fasta", fasta, "--output", str(tmp_path / "x.up")] + flags
    outcome = []
    for main in (jc.main, pc.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        outcome.append((e.value.code, capsys.readouterr().err))
    assert outcome[0] == outcome[1]
    assert not os.path.exists(tmp_path / "x.up")


def test_segments_and_fix_rotamer_tables(tmp_path):
    np.testing.assert_array_equal(pc.parse_segments("10-13,17,19-21"),
                                  jc.parse_segments("10-13,17,19-21"))
    assert pc.parse_segments("3").dtype == np.int32
    table = _write(tmp_path, "fix.dat", "residue restype rotamer\n0 ALA 1\n")
    with pytest.raises(SystemExit):
        pc._read_fix_rotamer(table, np.array(["GLY", "ALA"]))
    assert pc._read_fix_rotamer(table, np.array(["ALA", "GLY"])) == {0: 1}
