"""Post-hoc editing of compiled `.up` configs without h5py (port of
upside_md_tpu/config/edit.py).

Equivalents of the reference's in-place config editors:

* ``break_chains`` — convert an already-compiled single-chain config
  into a multichain system: record chain starts, add rigid-jump MC
  moves, cut bonded spring terms that span a chain boundary, and mark
  boundary-crossing phi/psi angles as dummies
  (reference: py/ugly_hack_break_chain.py:7-160).
* ``add_target_information`` — attach a target structure under
  ``/target/pos`` for restraint or analysis use
  (reference: py/add_target_information.py:8-24).

The port's `io/h5.Writer` only creates files, so an edit reads the file,
writes a new one beside it (every member it does not touch copied with
`Writer.copy`, chunked datasets becoming contiguous ones) and moves it
over the old one with `os.replace`.  The edited file's groups, datasets
and attributes equal those of the JAX package's in-place edit, as read
back; an edit that raises leaves the file as it was (the JAX package's
edit may have changed it before it raised).  Both work on files written
by either package's builder, by the reference's own config compiler, or
with an /output group from the JAX command line.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

from ..io import h5


def find_multichain_terms(ids: np.ndarray,
                          chain_starts: np.ndarray) -> np.ndarray:
    """Rows of an (n_term, k) atom-id table whose atoms span >1 chain.

    ``chain_starts`` are first-*atom* indices of every chain (including 0).
    Reference semantics: ugly_hack_break_chain.py:7-13.
    """
    ids = np.asarray(ids)
    chain_starts = np.asarray(chain_starts, dtype=np.int64)
    chain_num = (ids[:, :, None] >= chain_starts[None, None, :]).sum(-1)
    return chain_num.max(1) != chain_num.min(1)


def _rewrite(path: str, changes: Dict):
    """Write the HDF5 file at `path` anew with `changes` applied, then
    move it over the old one.  `changes` maps member paths ("input/
    jump_moves") to None (dropped), a dict (a new or replacing group with
    these attributes; a replaced group's old members are dropped) or
    (array, attrs) (a new or replacing dataset).  A new member's parent
    must exist or come earlier in `changes`."""
    changes = {p.strip("/"): v for p, v in changes.items()}
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(
        os.path.abspath(path)))
    os.close(fd)
    try:
        with h5.File(path) as f, h5.Writer(tmp, f.attrs) as w:
            def walk(group, prefix):
                for k, child in group.items():
                    p = prefix + k
                    if p in changes:
                        continue
                    if any(c.startswith(p + "/") for c in changes):
                        w.create_group(p, child.attrs)
                        walk(child, p + "/")
                    else:
                        w.copy(child, p)
            walk(f, "")
            for p, v in changes.items():
                if isinstance(v, dict):
                    w.create_group(p, v)
                elif v is not None:
                    w.create_dataset(p, v[0], v[1])
        os.replace(tmp, path)
    except BaseException:
        os.remove(tmp)
        raise


def _cut_rows(grp, at: str, names: Sequence[str], remove: np.ndarray,
              changes: Dict) -> int:
    """Drop the flagged rows from each named dataset of a group, keeping
    its attributes."""
    keep = ~remove
    for nm in names:
        changes[f"{at}/{nm}"] = (np.asarray(grp[nm])[keep],
                                 dict(grp[nm].attrs))
    return int(remove.sum())


def break_chains(path: str, chain_first_residue: Sequence[int],
                 rl_chains: Optional[Sequence[int]] = None,
                 jump_length_scale: float = 5.0,
                 jump_rotation_scale: float = 30.0,
                 remove_pivot: bool = False,
                 verbose: bool = False):
    """Multichain conversion of a compiled config (the file at `path` is
    replaced by the edited one).

    ``chain_first_residue`` lists the first residue of every chain after
    the first (residue 0 is implied), matching
    ``ConfigBuilder.add_chain_breaks``.  Cuts ``angle_spring`` /
    ``dihedral_spring`` rows and *bonded* ``dist_spring`` rows whose atoms
    span chains, converts boundary-crossing ``rama_coord`` rows to dummy
    phi/psi, and installs ``/input/chain_break`` + ``/input/jump_moves``.
    Reference: ugly_hack_break_chain.py:103-158.
    """
    chain_first_residue = [int(x) for x in chain_first_residue]
    if not chain_first_residue:
        raise ValueError("need at least one chain break residue")

    changes: Dict = {}
    with h5.File(path) as f:
        inp = f["input"]
        pot = inp["potential"]
        n_res = len(inp["sequence"])
        starts = np.array([0] + chain_first_residue, dtype=np.int64) * 3
        ends = np.append(starts, 3 * n_res)
        n_chain = len(starts)

        changes["input/chain_break"] = {}
        changes["input/chain_break/chain_first_residue"] = (
            np.asarray(chain_first_residue, np.int32), None)
        if rl_chains is not None:
            rl_chains = np.asarray(rl_chains, np.int32)
            if rl_chains.sum() != n_chain:
                raise ValueError(
                    f"rl_chains {rl_chains.tolist()} must sum to the "
                    f"number of chains ({n_chain})")
            changes["input/chain_break/rl_chains"] = (rl_chains, None)

        # rigid-jump MC moves: one range per chain, or receptor/ligand
        # collective ranges (reference :105-116)
        if rl_chains is None:
            atom_range = np.stack([ends[:-1], ends[1:]], axis=1)
        else:
            atom_range = np.array(
                [[ends[0], ends[rl_chains[0]]],
                 [ends[rl_chains[0]], ends[-1]]])
        changes["input/jump_moves"] = {}
        changes["input/jump_moves/atom_range"] = (
            atom_range.astype(np.int32), None)
        changes["input/jump_moves/sigma_trans"] = (np.full(
            len(atom_range), jump_length_scale, np.float32), None)
        changes["input/jump_moves/sigma_rot"] = (np.full(
            len(atom_range), jump_rotation_scale * np.pi / 180.0,
            np.float32), None)
        if remove_pivot and "pivot_moves" in inp:
            changes["input/pivot_moves"] = None

        # cut bonded terms spanning chains (reference :127-129)
        for name, fields, consider in (
                ("angle_spring", ("equil_dist", "spring_const"), None),
                ("dihedral_spring", ("equil_dist", "spring_const"), None),
                ("dist_spring", ("equil_dist", "spring_const",
                                 "bonded_atoms"), "bonded_atoms")):
            if name not in pot:
                continue
            grp = pot[name]
            bad = find_multichain_terms(np.asarray(grp["id"]), starts)
            if consider is not None:
                bad &= np.asarray(grp[consider]).astype(bool)
            n = _cut_rows(grp, f"input/potential/{name}",
                          ("id",) + fields, bad, changes)
            if verbose and n:
                print(f"cut {n} multichain rows from {name}")

        # hbond donors/acceptors cannot be cut post hoc (reference :131-141)
        if "infer_H_O" in pot:
            g = pot["infer_H_O"]
            for sub in ("donors", "acceptors"):
                if sub in g and find_multichain_terms(
                        np.asarray(g[sub]["id"]), starts).any():
                    raise ValueError(
                        "infer_H_O spans a chain break; rebuild the config "
                        "with hbond_excluded_residues instead of editing")

        # boundary-crossing phi/psi become dummy angles (reference :143-157)
        if "rama_coord" in pot:
            ds = pot["rama_coord"]["id"]
            tbl = np.asarray(ds).copy()
            locs = np.nonzero(find_multichain_terms(tbl, starts))[0]
            for loc in locs:
                chain_num = (tbl[loc][:, None] >= starts).sum(-1)
                if not (chain_num[1] == chain_num[2] == chain_num[3]
                        and (chain_num[0] == chain_num[1]
                             or chain_num[3] == chain_num[4])):
                    raise ValueError(
                        f"rama_coord row {loc} spans a chain break in an "
                        "unsupported pattern")
                if chain_num[0] == chain_num[1]:
                    tbl[loc, 4] = -1   # cut psi
                else:
                    tbl[loc, 0] = -1   # cut phi
            if len(locs):
                changes["input/potential/rama_coord/id"] = (tbl,
                                                            dict(ds.attrs))
                if verbose:
                    print(f"dummied {len(locs)} rama_coord rows")
    _rewrite(path, changes)
    return path


def add_target_information(path: str, target_pos: np.ndarray,
                           replace: bool = False):
    """Write a target structure to ``/target/pos`` of an existing config
    (reference: add_target_information.py:8-24)."""
    target_pos = np.asarray(target_pos, np.float32)
    if target_pos.ndim == 3:
        target_pos = target_pos[:, :, 0]
    with h5.File(path) as f:
        pos = np.asarray(f["input/pos"])
        if pos.ndim == 3:
            pos = pos[:, :, 0]
        if target_pos.shape != pos.shape:
            raise ValueError(
                f"target shape {target_pos.shape} != system {pos.shape}")
        if "target" in f and not replace:
            raise ValueError("config already has /target "
                             "(pass replace=True)")
    _rewrite(path, {"target": {}, "target/pos": (target_pos, None)})
    return path


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Post-hoc editing of compiled .up configs")
    sub = p.add_subparsers(dest="cmd", required=True)

    bc = sub.add_parser("break-chains",
                        help="convert a config to multichain in place")
    bc.add_argument("config")
    bc.add_argument("--chain-first-residue", type=int, action="append",
                    default=[], help="first residue of each chain after "
                    "the first; repeatable")
    bc.add_argument("--chain-break-from-file", action="store_true",
                    help="reuse breaks already recorded in the config")
    bc.add_argument("--rl-chains", nargs=2, type=int, default=None,
                    help="receptor/ligand chain counts for collective jumps")
    bc.add_argument("--jump-length-scale", type=float, default=5.0)
    bc.add_argument("--jump-rotation-scale", type=float, default=30.0)
    bc.add_argument("--remove-pivot", action="store_true")

    at = sub.add_parser("add-target",
                        help="attach a target structure under /target")
    at.add_argument("config")
    at.add_argument("--target-structure", required=True,
                    help=".npy (n_atom,3) or .initial.pkl structure")
    at.add_argument("--replace", action="store_true")

    args = p.parse_args(argv)
    if args.cmd == "break-chains":
        breaks = list(args.chain_first_residue)
        if args.chain_break_from_file:
            with h5.File(args.config) as f:
                if "input/chain_break/chain_first_residue" not in f:
                    sys.exit("--chain-break-from-file: config records "
                             "no chain breaks")
                breaks = np.asarray(
                    f["input/chain_break/chain_first_residue"]).tolist()
        break_chains(args.config, breaks, rl_chains=args.rl_chains,
                     jump_length_scale=args.jump_length_scale,
                     jump_rotation_scale=args.jump_rotation_scale,
                     remove_pivot=args.remove_pivot, verbose=True)
    elif args.cmd == "add-target":
        if args.target_structure.endswith(".npy"):
            pos = np.load(args.target_structure)
        else:
            import pickle
            with open(args.target_structure, "rb") as fh:
                pos = pickle.load(fh)
        add_target_information(args.config, pos, replace=args.replace)


if __name__ == "__main__":
    main()
