"""upside_md_torch: PyTorch + CUDA port of upside_md_tpu for NVIDIA Hopper.

The JAX package `upside_md_tpu` is the reference; this package imports
none of it (nor jax or h5py) and reads systems from Upside's `.up`
configurations (`config/reader.py`) and numpy spec bundles
(`config/bundle.py`).  Plain tensor code is PyTorch; the TPU's Pallas
kernels on the main path are hand-written CUDA in `csrc/`, each beside its
plain-PyTorch version in `ops/`.
"""

import os

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

from .system import System  # noqa: E402,F401
