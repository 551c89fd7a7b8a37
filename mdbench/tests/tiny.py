"""Tiny variants of the benchmark's cells for the CPU tests: the cell's
own workload file with the small trp-cage bundle (20 residues, 96 beads,
the same node types) and few replicas, rounds and configurations; a
training cell draws from a small pool of trp-cage frames made once per
process by `make_frames.make`."""

import atexit
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mdbench import harness  # noqa: E402

CPU = torch.device("cpu")
MD_CELLS = ("ubq_full.ens4096", "t4l_full.ens512")
TRAIN_CELLS = ("ubq_full.train_cd1024",)


_POOL = []


def frames_pool(config):
    """A .npy pool of 6 trp-cage MD frames (3 trajectories, 2 frames)."""
    if not _POOL:
        import numpy as np
        from mdbench import make_frames
        pool = make_frames.make(config, 3, 2, 2, 1, 5, CPU)
        fd, path = tempfile.mkstemp(suffix=".npy")
        os.close(fd)
        np.save(path, pool.numpy())
        atexit.register(os.remove, path)
        _POOL.append(path)
    return _POOL[0]


def tiny(cell):
    wl = harness.load_workload(cell)
    wl["config"] = dict(wl["config"], bundle="trp_cage_full_synth")
    if wl["mode"] == "md":
        wl.update(replicas=4, chunk_rounds=2, check_replicas=3)
    else:
        wl.update(ensemble=5, warmup_steps=1,
                  frames_file=frames_pool(wl["config"]))
    return wl


def run_once(wl, seed=2 ** 40 + 7, seconds=0.5):
    """One run of a tiny cell on the CPU: (Run, result)."""
    run = harness.load_module("modes", wl["mode"]).Run(wl, CPU, seed)
    return run, run.execute(seconds, False, 0.0)
