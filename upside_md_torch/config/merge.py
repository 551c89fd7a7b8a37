"""Merge per-chain configs into one multichain system with separate
interaction graphs without h5py (port of upside_md_tpu/config/merge.py;
reference py/multi_igraph.py).

Each chain's potential groups are copied with a `_<i>` suffix and rewired:
`pos` arguments become per-chain `slice_<i>` nodes selecting that chain's
atoms.  The combined file's own groups (cavity_radial, pivot/jump moves,
chain_break) are taken from the base file.  Prefix-based node-type
resolution makes the suffixed names resolve to the same node types.  The
files are read with `io/h5.File` and the merged one written with
`io/h5.Writer` (datasets contiguous, contents equal to the JAX package's
merge as read back).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io import h5

SHARED_GROUPS = {"cavity_radial"}


def merge_configs(base_path: str, chain_paths: List[str], out_path: str):
    """base_path: combined-system config (all chains' pos/sequence, cavity,
    chain breaks, samplers); chain_paths: per-chain configs whose potential
    graphs are kept separate."""
    with h5.Writer(out_path) as out:
        with h5.File(base_path) as base:
            inp = base["input"]
            out.create_group("input", inp.attrs)
            for name, node in inp.items():
                if name != "potential":
                    out.copy(node, f"input/{name}")
            pot = inp["potential"]
            out.create_group("input/potential", pot.attrs)
            # keep only the base potential groups shared by all chains
            for name, grp in pot.items():
                if name in SHARED_GROUPS:
                    out.copy(grp, f"input/potential/{name}")

        atom_offset = 0
        for ci, path in enumerate(chain_paths):
            with h5.File(path) as cin:
                n_res = len(cin["input/sequence"])
                n_atom = 3 * n_res
                # slice node selecting this chain's atoms from global pos
                out.create_group(f"input/potential/slice_{ci}", {
                    "arguments": np.asarray(["pos"], dtype="S")})
                out.create_dataset(
                    f"input/potential/slice_{ci}/id",
                    np.arange(atom_offset, atom_offset + n_atom))
                for name, grp in cin["input/potential"].items():
                    if name in SHARED_GROUPS:
                        continue
                    new_name = f"input/potential/{name}_{ci}"
                    args = [a.decode() if isinstance(a, bytes) else str(a)
                            for a in grp.attrs["arguments"]]
                    new_args = [f"slice_{ci}" if a == "pos" else f"{a}_{ci}"
                                for a in args]
                    out.create_group(new_name, {
                        **grp.attrs,
                        "arguments": np.asarray(new_args, dtype="S")})
                    for k, child in grp.items():
                        out.copy(child, f"{new_name}/{k}")
                atom_offset += n_atom
    return out_path
