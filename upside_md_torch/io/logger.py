"""Trajectory logging into HDF5 through `io/h5.py` (port of
upside_md_tpu/io/logger.py; reference src/state_logger.h).

The JAX package's logger appends to the `.up` configuration's /output
group.  The port's systems come from read-only `.npz` bundles, so it
writes one file per replica slot instead (`cli.output_path`:
`<output dir>/<bundle stem>_<slot>.h5`), holding

* /input/pos: the slot's initial structure, (n_atom, 3, 1);
* /input/sequence: the residue names, where the bundle carries them;
* /output: the frames, with the attribute `invocation`.

/output's datasets have the JAX logger's names, per-frame shapes and
dtypes (the caller casts): extensible datasets appended one row a frame,
`pos` as (n_frame, 1, n_atom, 3), so the readers of either package
(`io/trajectory.py`, `analysis.py`) read both.  Frames wait in a buffer
of BUFFER_FRAMES rows a stream and reach the file together, at a
buffer's end or at `flush`; each such write appends only the new rows
(`h5.Writer.append`).  A dataset's chunks hold BUFFER_FRAMES rows too, so
a full buffer fills one chunk.  Which streams a frame carries is decided
by the log level of `io/streams.make_frame_fn`, not here.  Opening a
file that holds /output renames it to /output_previous_i, as the JAX
logger and continue_sim do: the file's contents are copied once into a
new file, which then replaces it.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from . import h5

LOG_LEVELS = ("basic", "detailed", "extensive")
BUFFER_FRAMES = 100     # frames buffered a stream, and rows a chunk


class H5Logger:
    def __init__(self, path, invocation="", input_pos=None, sequence=None):
        """input_pos: (n_atom, 3) initial structure written to /input/pos
        (replacing the file's own when it exists); sequence: residue names
        for /input/sequence (kept from the file when None)."""
        self.path = path
        self._buffers: Dict[str, list] = {}
        self.flush_seconds = []        # wall time of each buffer's write
        tmp = f"{path}.tmp{os.getpid()}"
        self._w = h5.Writer(tmp)
        try:
            self._start(path, input_pos, sequence, invocation)
        except BaseException:
            self._w.close()
            os.remove(tmp)
            raise
        os.replace(tmp, path)

    def _start(self, path, input_pos, sequence, invocation):
        w = self._w
        old = h5.File(path) if os.path.exists(path) else None
        try:
            i = 0
            while old is not None and f"output_previous_{i}" in old:
                i += 1
            for name, node in (old.items() if old is not None else []):
                if name == "output":
                    name = f"output_previous_{i}"
                if name != "input":
                    w.copy(node, name)
            w.create_group("input")
            if old is not None and "input" in old:
                for name, node in old["input"].items():
                    if (name == "pos" and input_pos is not None) or (
                            name == "sequence" and sequence is not None):
                        continue
                    w.copy(node, f"input/{name}")
        finally:
            if old is not None:
                old.close()
        if input_pos is not None:
            w.create_dataset("input/pos", np.asarray(
                input_pos, np.float32)[:, :, None])
        if sequence is not None:
            w.create_dataset("input/sequence", np.asarray(sequence, "S"))
        w.create_group("output", attrs={"invocation": invocation}
                       if invocation else None)
        w.flush()

    def log_frame(self, name, value):
        value = np.asarray(value)
        self._buffers.setdefault(name, []).append(value)
        if len(self._buffers[name]) >= BUFFER_FRAMES:
            self._flush_one(name)

    def log_once(self, name, value):
        self._w.create_dataset(f"output/{name}", np.asarray(value))
        self._w.flush()

    def _flush_one(self, name):
        rows = self._buffers.pop(name, [])
        if not rows:
            return
        t0 = time.perf_counter()
        block = np.stack(rows)
        path = f"output/{name}"
        if path in self._w:
            self._w.append(path, block)
        else:
            self._w.create_extensible(path, block, BUFFER_FRAMES)
            self._w.flush()
        self.flush_seconds.append(time.perf_counter() - t0)

    def flush(self):
        for name in list(self._buffers):
            self._flush_one(name)

    def close(self):
        if self._w is not None:
            self.flush()
            self._w.close()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
