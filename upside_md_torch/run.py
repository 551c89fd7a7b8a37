"""Job orchestration (port of upside_md_tpu/run.py; reference
py/run_upside.py): building a `.up` from a FASTA and parameter libraries,
launching the command line in process or as a subprocess, continuing
interrupted runs, and replica-ladder swap sets.

The configurations are `.up` files, which the port builds and reads
without h5py (`config/builder.py`, `config/reader.py`), or spec bundles
(`.npz`).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np

from .cli import output_path
from .io import h5


def upside_config(fasta, output_path, initial_structure=None,
                  rama_maps=None, rama_library=None, sheet_mixing=None,
                  hbond_energy=0.0, backbone=True,
                  rotamer_placement=None, rotamer_interaction=None,
                  dynamic_rotamer_1body=True, rotamer_damping=0.4,
                  environment_potential=None, cavity_radius=0.0,
                  fix_rotamer=None, seed=0):
    """Programmatic equivalent of the upside_config.py CLI: assemble a
    `.up` file from a FASTA (text starting with '>' or a path) plus
    parameter libraries, in the JAX package's order (run.py:22-66)."""
    from .config.builder import ConfigBuilder

    init = None
    if initial_structure is not None:
        if isinstance(initial_structure, (str, os.PathLike)):
            init = pickle.load(open(initial_structure, 'rb'),
                               encoding='latin1')
            init = np.asarray(init)[..., 0] if init.ndim == 3 else init
        else:
            init = np.asarray(initial_structure)

    b = ConfigBuilder(fasta if fasta.startswith('>') else open(fasta).read(),
                      initial_pos=init, seed=seed)
    b.add_backbone_springs()
    if rama_library:
        b.add_rama_map_pot_from_library(rama_library, sheet_mixing)
    elif rama_maps is not None:
        b.add_rama_map_pot(rama_maps)
    if rotamer_placement and rotamer_interaction:
        b.add_rotamer_sidechains(rotamer_placement, rotamer_interaction,
                                 damping=rotamer_damping,
                                 dynamic_1body=dynamic_rotamer_1body,
                                 fix_rotamer=fix_rotamer)
    if hbond_energy:
        b.add_hbond(hbond_energy=hbond_energy,
                    coverage_library=rotamer_interaction)
    if environment_potential:
        b.add_environment(environment_potential)
    if rotamer_placement and rotamer_interaction:
        b.add_rotamer_node()
    if backbone:
        b.add_backbone_pairs()
    if cavity_radius:
        b.add_cavity_radial(cavity_radius)
    return b.write(output_path)


def run_upside(config_paths: List[str], duration, frame_interval,
               temperature="1.0", extra_args: Optional[List[str]] = None,
               in_process=True, **kw):
    """Launch a simulation over one or more configurations (`.up` or
    `.npz`, passed on as they are), one replica slot each.  Keywords become flags (`output_dir="out"` -> `--output-dir=out`,
    True -> a bare flag).  in_process=True calls `cli.main` directly (the
    reference's `in_process_upside`, upside_engine.py:67-91); otherwise
    `python -m upside_md_torch.cli` runs as a subprocess, and its exit
    code is returned."""
    args = [f"--duration={duration}", f"--frame-interval={frame_interval}",
            f"--temperature={temperature}"]
    for k, v in kw.items():
        flag = "--" + k.replace('_', '-')
        if v is True:
            args.append(flag)
        elif v is not False and v is not None:
            args.append(f"{flag}={v}")
    args += list(extra_args or [])
    args += list(config_paths)
    if in_process:
        from .cli import main
        return main(args)
    return subprocess.call([sys.executable, "-m", "upside_md_torch.cli"]
                           + args)


def continue_sim(config_paths: List[str], duration, frame_interval,
                 output_dir=".", **kw):
    """Continue an interrupted run (run_upside.py:231-254): each slot
    starts from the last frame of its file in `output_dir`, passed on as
    that slot's initial structure, and the relaunch's logger shifts the
    file's /output to /output_previous_i (and writes the new start to
    /input/pos)."""
    last = []
    for slot, config in enumerate(config_paths):
        with h5.File(output_path(output_dir, config, slot)) as f:
            frame = np.asarray(f["output/pos"])[-1]
        last.append(frame[0] if frame.ndim == 3 else frame)  # (1, n, 3)
    fd, path = tempfile.mkstemp(suffix=".pkl", dir=output_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(np.stack(last), f, -1)
        return run_upside(config_paths, duration, frame_interval,
                          output_dir=output_dir, initial_structures=path,
                          **kw)
    finally:
        os.remove(path)


def swap_table2d(nx, ny):
    """Swap sets for a 2D replica ladder (run_upside.py:395-405): four sets
    of non-overlapping neighbor swaps (even/odd in each direction)."""
    idx = lambda x, y: x * ny + y  # noqa: E731
    sets = []
    for parity in (0, 1):
        s = [f"{idx(x, y)}-{idx(x + 1, y)}"
             for x in range(parity, nx - 1, 2) for y in range(ny)]
        if s:
            sets.append(','.join(s))
    for parity in (0, 1):
        s = [f"{idx(x, y)}-{idx(x, y + 1)}"
             for x in range(nx) for y in range(parity, ny - 1, 2)]
        if s:
            sets.append(','.join(s))
    return sets
