"""Build, load and launch the hand-written Hopper kernels in ../csrc.

The CUDA sources have a plain C interface.  At first use each `.cu` file is
compiled by its own `nvcc` process for sm_90a (all started together), the
objects are linked into one shared library under `upside_md_torch/_build/
<hash of the sources>/`, and the library is loaded with ctypes.  Every
pointer and the stream pass as `c_void_p`; a C function returns
`cudaGetLastError()` after its launches, and `launch` raises when that is
not 0.

`LAUNCHES` counts, per kernel, the calls that launched it; nothing else
changes the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
KERNELS = ("fused_pair_fwd", "fused_pair_bwd", "fused_pair_bwd_recompute",
           "bp_bethe_pairs", "quadspline_fwd", "quadspline_bwd",
           "colsum_fwd", "colsum_bwd", "bp_bethe_planes")
# tile of the fused pair kernels (must match csrc/fused_pair.cuh)
TILE_ROWS = 32
TILE_COLS = 32

LAUNCHES = {name: 0 for name in KERNELS}
_lib = None


def reset_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else shutil.which("nvcc")


def build(verbose=False):
    """Compile csrc/*.cu (if this source hash has no library yet) and
    return the library path.  Raises on any compiler error."""
    h = hashlib.sha256()
    for f in _sources():
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(BUILD, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libupside_kernels.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME")
    os.makedirs(out_dir, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=out_dir)
    try:
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-I", CSRC]
        if verbose:
            flags.append("-Xptxas=-v")
        objs, procs = [], []
        for src in (f for f in _sources() if f.endswith(".cu")):
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{os.path.basename(src)}: nvcc failed "
                              f"({p.returncode}):\n{err}")
            elif verbose and err:
                print(f"{os.path.basename(src)}:\n{err}", flush=True)
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = os.path.join(tmp_dir, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib


def library():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    return _lib


def _carg(a):
    if a is None:                       # an operand the call does not read
        return ctypes.c_void_p(None)
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if isinstance(a, int):
        return ctypes.c_int(a)
    if isinstance(a, float):
        return ctypes.c_float(a)
    raise TypeError(f"cannot pass {type(a)} to a kernel")


def launch(name, *args):
    """Call C function `name` with args + the current stream; raise if the
    launch failed; count it."""
    fn = getattr(library(), name)
    cargs = [_carg(a) for a in args]
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if fn.argtypes is None:         # the kinds of a function's arguments
        fn.argtypes = [type(c) for c in cargs]      # are the same each call
        fn.restype = ctypes.c_int
    rc = fn(*cargs)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
