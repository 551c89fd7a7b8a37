"""Job orchestration (port of upside_md_tpu/run.py; reference
py/run_upside.py): launching the command line in process or as a
subprocess, continuing interrupted runs, and replica-ladder swap sets.

The configurations are `.up` files, which the port reads without h5py
(`config/reader.py`), or spec bundles (`.npz`).  The JAX package's
`upside_config`, which builds a `.up` through `config/builder.py`, is not
ported yet, so the `.up` comes from that package or the reference.
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
