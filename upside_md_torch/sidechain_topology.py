"""Per-restype side-chain internal-coordinate topology (all 20 amino
acids) and residue-frame atom construction (a copy of
upside_md_tpu/sidechain_topology.py, numpy alone, for `param_gen.py`).

The reference hard-codes one C++ function per residue type
(generate_from_rotamer.cpp:15-243 res_func_map); here the same geometry is
DATA: each atom is one row (name, parent, dihedral source, planar angle,
bond length), and a single generic routine grows the chain with TAB
(torsion-angle-bond) transforms.  The numeric constants are the
reference's fitted idealized geometry — they are the compatibility
contract with shipped parameter libraries, not code.

Atom order matches the reference: N, CA, C, O, [CB], side chain.
Dihedral sources:  ("chi", k, offset_deg) — rotamer torsion k plus a fixed
offset;  ("const", deg) — fixed torsion;  ("psi", offset_deg) — backbone
psi plus offset (the carbonyl O).
"""

from __future__ import annotations

import numpy as np

deg = np.pi / 180.0

# residue-frame anchor of the backbone construction
# (generate_from_rotamer.cpp:30-35 place_bb)
_BB_ANCHOR = np.array([
    [0.8191292, -0.3103239, 0.4824173, -1.2079210],
    [0.5736088, 0.4423396, -0.6894263, -0.2636016],
    [0.0005532, 0.8414480, 0.5403378, -0.0009170],
    [0.0, 0.0, 0.0, 1.0]])

# backbone rows: (name, parent, dihedral, theta_deg, bond)
_BACKBONE = [
    ("N", None, ("const", 0.0), 0.0, 0.0),
    ("CA", "N", ("const", 0.0), 0.0, 1.45),
    ("C", "CA", ("const", 122.7), 110.3, 1.53),
    ("O", "C", ("psi", 180.0), 120.5, 1.23),
]
_CB_ROW = ("CB", "CA", ("const", 0.0), 110.6, 1.53)

# side-chain rows per restype (generate_from_rotamer.cpp:50-205)
SIDECHAIN_TOPOLOGY = {
    "ALA": [],
    "GLY": [],
    "ARG": [("CG", "CB", ("chi", 0, 0.0), 113.9, 1.52),
            ("CD", "CG", ("chi", 1, 0.0), 111.7, 1.52),
            ("NE", "CD", ("chi", 2, 0.0), 111.7, 1.46),
            ("CZ", "NE", ("chi", 3, 0.0), 124.7, 1.33),
            ("NH1", "CZ", ("const", 0.0), 120.7, 1.33),
            ("NH2", "CZ", ("const", -180.0), 119.6, 1.33)],
    "ASN": [("CG", "CB", ("chi", 0, 0.0), 112.7, 1.52),
            ("OD1", "CG", ("chi", 1, 0.0), 120.9, 1.23),
            ("ND2", "CG", ("chi", 1, 180.0), 116.5, 1.33)],
    "ASP": [("CG", "CB", ("chi", 0, 0.0), 113.0, 1.52),
            ("OD1", "CG", ("chi", 1, 0.0), 119.2, 1.25),
            ("OD2", "CG", ("chi", 1, -179.9), 118.2, 1.25)],
    "CYS": [("SG", "CB", ("chi", 0, 0.0), 113.8, 1.81)],
    "GLN": [("CG", "CB", ("chi", 0, 0.0), 113.9, 1.52),
            ("CD", "CG", ("chi", 1, 0.0), 112.8, 1.52),
            ("OE1", "CD", ("chi", 2, 0.0), 120.9, 1.23),
            ("NE2", "CD", ("chi", 2, -180.0), 116.5, 1.33)],
    "GLU": [("CG", "CB", ("chi", 0, 0.0), 113.9, 1.52),
            ("CD", "CG", ("chi", 1, 0.0), 113.2, 1.52),
            ("OE1", "CD", ("chi", 2, 0.0), 119.0, 1.25),
            ("OE2", "CD", ("chi", 2, -180.0), 118.1, 1.25)],
    "HIS": [("CG", "CB", ("chi", 0, 0.0), 113.6, 1.50),
            ("ND1", "CG", ("chi", 1, 0.0), 122.7, 1.38),
            ("CD2", "CG", ("chi", 1, 179.9), 131.0, 1.36),
            ("CE1", "ND1", ("const", 179.9), 109.2, 1.32),
            ("NE2", "CD2", ("const", -179.9), 107.2, 1.37)],
    "ILE": [("CG1", "CB", ("chi", 0, 0.0), 110.4, 1.53),
            ("CG2", "CB", ("chi", 0, -123.2), 110.7, 1.53),
            ("CD1", "CG1", ("chi", 1, 0.0), 114.0, 1.52)],
    "LEU": [("CG", "CB", ("chi", 0, 0.0), 116.4, 1.53),
            ("CD1", "CG", ("chi", 1, 0.0), 110.4, 1.53),
            ("CD2", "CG", ("chi", 1, 122.9), 110.6, 1.53)],
    "LYS": [("CG", "CB", ("chi", 0, 0.0), 114.0, 1.52),
            ("CD", "CG", ("chi", 1, 0.0), 111.5, 1.52),
            ("CE", "CD", ("chi", 2, 0.0), 111.6, 1.52),
            ("NZ", "CE", ("chi", 3, 0.0), 111.8, 1.49)],
    "MET": [("CG", "CB", ("chi", 0, 0.0), 113.9, 1.52),
            ("SD", "CG", ("chi", 1, 0.0), 112.7, 1.81),
            ("CE", "SD", ("chi", 2, 0.0), 100.7, 1.79)],
    "PHE": [("CG", "CB", ("chi", 0, 0.0), 113.8, 1.50),
            ("CD1", "CG", ("chi", 1, 0.0), 120.7, 1.39),
            ("CD2", "CG", ("chi", 1, -180.0), 120.5, 1.39),
            ("CE1", "CD1", ("const", -180.0), 120.8, 1.39),
            ("CE2", "CD2", ("const", 180.0), 120.8, 1.39),
            ("CZ", "CE1", ("const", 0.0), 119.9, 1.39)],
    "PRO": [("CG", "CB", ("chi", 0, 0.0), 104.2, 1.50),
            ("CD", "CG", ("chi", 1, 0.0), 104.9, 1.51)],
    "SER": [("OG", "CB", ("chi", 0, 0.0), 110.8, 1.42)],
    "THR": [("OG1", "CB", ("chi", 0, 0.0), 109.2, 1.43),
            ("CG2", "CB", ("chi", 0, -120.4), 111.1, 1.53)],
    "TRP": [("CG", "CB", ("chi", 0, 0.0), 113.9, 1.50),
            ("CD1", "CG", ("chi", 1, 0.0), 127.1, 1.37),
            ("CD2", "CG", ("chi", 1, -179.7), 126.6, 1.43),
            ("NE1", "CD1", ("const", -179.8), 110.1, 1.38),
            ("CE2", "CD2", ("const", 179.8), 107.2, 1.41),
            ("CE3", "CD2", ("const", -0.2), 133.9, 1.40),
            ("CZ2", "CE2", ("const", 180.0), 122.4, 1.40),
            ("CZ3", "CE3", ("const", -180.0), 118.7, 1.39),
            ("CH2", "CZ2", ("const", 0.0), 117.5, 1.37)],
    "TYR": [("CG", "CB", ("chi", 0, 0.0), 113.7, 1.51),
            ("CD1", "CG", ("chi", 1, 0.0), 120.9, 1.39),
            ("CD2", "CG", ("chi", 1, -179.9), 120.8, 1.39),
            ("CE1", "CD1", ("const", -179.9), 121.1, 1.39),
            ("CE2", "CD2", ("const", 179.9), 121.1, 1.39),
            ("CZ", "CE1", ("const", 0.0), 119.5, 1.38),
            ("OH", "CZ", ("const", 180.0), 119.8, 1.38)],
    "VAL": [("CG1", "CB", ("chi", 0, 0.0), 110.7, 1.53),
            ("CG2", "CB", ("chi", 0, 122.9), 110.4, 1.53)],
}

N_CHI = {rt: (max((r[2][1] for r in rows if r[2][0] == "chi"), default=-1)
              + 1) for rt, rows in SIDECHAIN_TOPOLOGY.items()}


def _tab(phi, theta, bond):
    """TAB transform growing one atom (generate_from_rotamer.cpp:15-28)."""
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    return np.array([
        [-ct, -st, 0.0, -bond * ct],
        [cp * st, -cp * ct, -sp, bond * cp * st],
        [sp * st, -sp * ct, cp, bond * sp * st],
        [0.0, 0.0, 0.0, 1.0]])


def residue_atoms(restype, psi, chi=(0.0, 0.0, 0.0, 0.0)):
    """Atom positions (n_atom, 3) in the residue frame: N, CA, C, O,
    [CB], side chain per SIDECHAIN_TOPOLOGY.  psi and chi in radians."""
    rows = list(_BACKBONE)
    if restype != "GLY":
        rows.append(_CB_ROW)
    rows = rows + SIDECHAIN_TOPOLOGY[restype]

    frames = {None: _BB_ANCHOR}
    out = []
    for name, parent, dihedral, theta, bond in rows:
        kind = dihedral[0]
        if kind == "const":
            phi = dihedral[1] * deg
        elif kind == "psi":
            phi = psi + dihedral[1] * deg
        else:
            phi = chi[dihedral[1]] + dihedral[2] * deg
        frames[name] = frames[parent] @ _tab(phi, theta * deg, bond)
        out.append(frames[name][:3, 3].copy())
    return np.array(out)


def atom_names(restype):
    names = [r[0] for r in _BACKBONE]
    if restype != "GLY":
        names.append(_CB_ROW[0])
    return names + [r[0] for r in SIDECHAIN_TOPOLOGY[restype]]
