"""The flagship forward step and the multi-rank dry run (counterpart of the
JAX package's __graft_entry__.py).

    entry(small=False, device="cuda") -> (forward, (pos, params))

`forward(pos, params)` returns (energy, forces) of the flagship full
force field, forces = -dU/dpos, through `System.deriv`, the call the MD
loop makes at each stage (cold BP start here).  pos is (n_atom, 3), giving
a scalar energy, or a replica batch (B, n_atom, 3).

The flagship is 76-residue ubiquitin (20-residue trp-cage when `small`)
with the full force field: rotamer BP side chains, hbond coverage and
hydrophobes, the environment chain.  With the reference's parameter
libraries (`bench_systems.have_reference_params`) it is built as the JAX
`_flagship` builds it, by `bench_systems.build_full_system`.  Without them
the JAX package falls back to the backbone-only field; the port instead
loads the committed full-force-field bundle of the same build on the
synthetic libraries with smooth Rama maps (`data/ubiquitin_full_synth.npz`,
`data/trp_cage_full_synth.npz`), so that the flagship runs the fused pair
block (K1 fwd, K1 bwd) and bead-space BP (K2) on the card as it does with
the reference's libraries.  It does not use `build_full_system`'s
white-noise Rama map, whose rama_map_pot is ~1e5.

`dryrun_multichip(ranks, device="cuda", backend=None, replicas=None)` is
`parallel.dryrun.run`: the JAX dry run's five steps on N ranks.  The JAX
package re-executes itself on a virtual CPU mesh; here each rank is a
process of its own on a card (or the CPU when asked).  Its command line
is `python -m upside_md_torch.parallel.dryrun --ranks N`.

    python -m upside_md_torch.entry [--small] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from . import DATA_DIR
from .bench_systems import (CYT_C, TRP_CAGE, UBIQUITIN, full_builder,
                            have_reference_params, _write_and_load)
from .config import bundle
from .parallel.dryrun import run as dryrun_multichip  # noqa: F401
from .system import System

# the committed full-force-field bundles (synthetic libraries, smooth Rama
# maps; tools/export_torch_bundle.py), by sequence
FULL_BUNDLES = {TRP_CAGE: "trp_cage_full_synth",
                UBIQUITIN: "ubiquitin_full_synth",
                CYT_C: "cytochrome_c_full_synth"}


def full_system(seq=UBIQUITIN, device="cuda", dtype=torch.float32):
    """(system, params, pos, aux) of `seq`'s full force field: the
    reference's libraries through `full_builder` when present, otherwise
    the committed bundle of that sequence (FULL_BUNDLES)."""
    if have_reference_params():
        return _write_and_load(full_builder(seq), device, dtype)
    path = os.path.join(DATA_DIR, FULL_BUNDLES[seq] + ".npz")
    system, pos = System.from_bundle(path, device, dtype)
    return system, system.params, pos, bundle.load_aux(path)


def full_label(seq=UBIQUITIN):
    """Which libraries `full_system(seq)` runs on, for a metric's label."""
    if have_reference_params():
        return "reference libraries"
    return f"synthetic libraries ({FULL_BUNDLES[seq]})"


def _flagship(small=False, device="cuda", dtype=torch.float32):
    """(system, params, pos, aux) of the flagship: full-force-field
    ubiquitin, or trp-cage when `small`."""
    return full_system(TRP_CAGE if small else UBIQUITIN, device, dtype)


def forward_step(system):
    """forward(pos, params) -> (energy, forces) of `system`: `System.deriv`
    from a cold BP start, forces = -dU/dpos; pos (n_atom, 3) gives a
    scalar energy and (n_atom, 3) forces, (B, n_atom, 3) a batch."""
    def forward(pos, params):
        one = pos.ndim == 2
        g, e, _ = system.deriv(pos[None] if one else pos, params=params)
        return (e[0], -g[0]) if one else (e, -g)
    return forward


def entry(small=False, device="cuda", dtype=torch.float32):
    """(forward, (pos, params)): the flagship's forward step and its
    example arguments, on the card unless `device` says otherwise."""
    system, params, pos, _ = _flagship(small, device, dtype)
    return forward_step(system), (pos, params)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the flagship forward step")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    forward, (pos, params) = entry(args.small, args.device)
    energy, forces = forward(pos, params)
    if not (torch.isfinite(energy) and torch.isfinite(forces).all()):
        raise RuntimeError("the flagship's energy or forces are not finite")
    print(f"entry ok: {energy.item()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
