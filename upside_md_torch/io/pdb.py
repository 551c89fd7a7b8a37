"""PDB ingestion (the port's copy of upside_md_tpu/io/pdb.py, numpy
only): extract the N/CA/C backbone, FASTA (with cis-proline
marking), chi1/chi2 angles, and chain breaks.

Replaces the reference's ProDy-based py/PDB_to_initial_structure.py with a
dependency-free PDB parser producing the same outputs:
  <base>.initial.pkl  (n_atom, 3, 1) float array pickle
  <base>.fasta        one-letter sequence, '*P' for cis-proline
  <base>.chi          'residue restype chain resnum chi1 chi2' table
  <base>.chain_breaks space-separated chain first-residue indices
"""

from __future__ import annotations

import pickle
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

deg = np.pi / 180.0

THREE_TO_ONE = {
    'ALA': 'A', 'CYS': 'C', 'ASP': 'D', 'GLU': 'E', 'PHE': 'F',
    'GLY': 'G', 'HIS': 'H', 'ILE': 'I', 'LYS': 'K', 'LEU': 'L',
    'MET': 'M', 'ASN': 'N', 'PRO': 'P', 'GLN': 'Q', 'ARG': 'R',
    'SER': 'S', 'THR': 'T', 'VAL': 'V', 'TRP': 'W', 'TYR': 'Y'}
NONSTANDARD = {'MSE': 'MET'}


def _dihedral(x1, x2, x3, x4):
    b1, b2, b3 = x2 - x1, x3 - x2, x4 - x3
    b2b3 = np.cross(b2, b3)
    return np.arctan2(np.linalg.norm(b2) * np.dot(b1, b2b3),
                      np.dot(np.cross(b1, b2), b2b3))


@dataclass
class PDBResidue:
    chain: str
    resnum: int
    restype: str
    atoms: Dict[str, np.ndarray] = field(default_factory=dict)

    def get(self, name):
        return self.atoms.get(name)

    @property
    def cg(self):
        for k, v in self.atoms.items():
            if re.match(r"[^H]G1?$", k):
                return v
        return None

    @property
    def cd(self):
        for k, v in self.atoms.items():
            if re.match(r"[^H]D1?$", k):
                return v
        return None


def parse_pdb(text: str, model: Optional[int] = None,
              chains: Optional[List[str]] = None) -> List[PDBResidue]:
    residues: List[PDBResidue] = []
    index: Dict = {}
    cur_model = 1
    want_model = model
    for line in text.splitlines():
        rec = line[:6]
        if rec == 'MODEL ':
            cur_model = int(line[10:14])
        elif rec == 'ENDMDL':
            if want_model is None:
                break  # first model only, like prody default
        elif rec in ('ATOM  ', 'HETATM'):
            if want_model is not None and cur_model != want_model:
                continue
            altloc = line[16]
            if altloc not in (' ', 'A'):
                continue
            restype = line[17:20].strip()
            restype = NONSTANDARD.get(restype, restype)
            if restype not in THREE_TO_ONE:
                continue
            chain = line[21].strip() or ' '
            if chains and chain not in chains:
                continue
            resnum = int(line[22:26])
            icode = line[26]
            key = (chain, resnum, icode)
            if key not in index:
                r = PDBResidue(chain, resnum, restype)
                index[key] = r
                residues.append(r)
            name = line[12:16].strip()
            xyz = np.array([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
            index[key].atoms.setdefault(name, xyz)
    return residues


def extract_initial_structure(pdb_text, model=None, chains=None,
                              allow_unexpected_breaks=False,
                              recenter=True):
    """Returns dict with coords (n_atom,3), fasta string (with '*P'),
    sequence (3-letter incl CPR), chi table, chain_first_residue list."""
    residues = parse_pdb(pdb_text, model, chains)
    # complete backbones only
    residues = [r for r in residues
                if all(r.get(a) is not None for a in ('N', 'CA', 'C'))]

    coords: List[np.ndarray] = []
    sequence: List[str] = []
    chi = []
    chain_resnum = []
    chain_first_residue = []
    prev_omega = np.nan
    prev_chain = None
    unexpected = []

    for i, r in enumerate(residues):
        if coords:
            dist = np.linalg.norm(r.get('N') - coords[-1])
            if dist > 2.0:
                if r.chain == prev_chain:
                    unexpected.append(len(coords) // 3)
                chain_first_residue.append(len(coords) // 3)
        # omega of this residue (prevCA, prevC, N, CA)
        restype = r.restype
        if (restype == 'PRO' and coords and np.isfinite(prev_omega)
                and abs(prev_omega) < 90 * deg):
            restype = 'CPR'
        coords.extend([r.get('N'), r.get('CA'), r.get('C')])
        sequence.append(restype)
        chain_resnum.append((r.chain, r.resnum))

        cb, cg, cd = r.get('CB'), r.cg, r.cd
        chi1 = (_dihedral(r.get('N'), r.get('CA'), cb, cg)
                if cb is not None and cg is not None else np.nan)
        chi2 = (_dihedral(r.get('CA'), cb, cg, cd)
                if cb is not None and cg is not None and cd is not None
                else np.nan)
        chi.append((chi1, chi2))

        if i + 1 < len(residues):
            nxt = residues[i + 1]
            if nxt.get('N') is not None:
                prev_omega = _dihedral(r.get('CA'), r.get('C'),
                                       nxt.get('N'), nxt.get('CA')) \
                    if nxt.get('CA') is not None else np.nan
        prev_chain = r.chain

    if unexpected and not allow_unexpected_breaks:
        raise ValueError(f"unexpected chain breaks at residues {unexpected} "
                         "(probably missing residues in the structure)")

    coords = np.array(coords)
    if recenter:
        coords = coords - coords.mean(axis=0)

    fasta = ''.join(('*P' if s == 'CPR' else THREE_TO_ONE[s])
                    for s in sequence)
    return {
        'coords': coords,
        'fasta': fasta,
        'sequence': sequence,
        'chi': np.array(chi),
        'chain_resnum': chain_resnum,
        'chain_first_residue': chain_first_residue,
    }


def write_outputs(result, basename, pdb_name='input'):
    with open(basename + '.initial.pkl', 'wb') as f:
        pickle.dump(result['coords'][..., None], f, -1)
    with open(basename + '.fasta', 'w') as f:
        f.write(f'> Created from {pdb_name}\n')
        s = result['fasta']
        for i in range(0, len(s), 80):
            f.write(s[i:i + 80] + '\n')
    with open(basename + '.chi', 'w') as f:
        f.write('residue restype  chain  resnum      chi1     chi2\n')
        for nr, restype in enumerate(result['sequence']):
            ch, rn = result['chain_resnum'][nr]
            c1, c2 = result['chi'][nr]
            f.write(f'{nr: 7d} {restype:>7s} {ch:>5s}   {rn:>6}  '
                    f'{c1 / deg: 8.3f} {c2 / deg: 8.3f}\n')
    if result['chain_first_residue']:
        with open(basename + '.chain_breaks', 'w') as f:
            f.write(' '.join(str(i) for i in result['chain_first_residue'])
                    + '\n')


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('pdb')
    p.add_argument('basename')
    p.add_argument('--model', type=int, default=None)
    p.add_argument('--chains', default='')
    p.add_argument('--allow-unexpected-chain-breaks', action='store_true')
    p.add_argument('--record-chain-breaks', action='store_true')
    p.add_argument('--disable-recentering', action='store_true')
    args = p.parse_args(argv)
    chains = [c for c in args.chains.split(',') if c]
    result = extract_initial_structure(
        open(args.pdb).read(), args.model, chains or None,
        args.allow_unexpected_chain_breaks, not args.disable_recentering)
    if not args.record_chain_breaks:
        result['chain_first_residue'] = []
    write_outputs(result, args.basename, args.pdb)


if __name__ == '__main__':
    main()
