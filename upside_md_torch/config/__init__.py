"""System inputs for the port: numpy-only spec bundles (`bundle.py`) and
`.up` configurations (`reader.py`), both read without h5py or jax."""

import os

UP_SUFFIXES = (".up", ".h5")


def load(path):
    """(SpecRecords, initial positions (n_atom, 3), aux) of a spec bundle
    (`.npz`) or a `.up` configuration (`.up` or `.h5`), chosen by suffix."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".npz":
        from . import bundle
        records, pos = bundle.load(path)
        return records, pos, bundle.load_aux(path)
    if suffix in UP_SUFFIXES:
        from .reader import load_up
        return load_up(path)
    raise ValueError(f"{path}: not a spec bundle (.npz) or a .up "
                     "configuration (.up, .h5)")
