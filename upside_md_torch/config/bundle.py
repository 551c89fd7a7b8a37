"""Spec bundles: a system's node graph and initial positions as numpy arrays.

A bundle is what the port needs to build a `System` on a machine that has
neither h5py nor jax: the atom count, the initial positions, and for every
node its name, node-type name, argument list, static `consts` and
differentiable `params`.  It is one `np.savez_compressed` file whose
`__index__` entry is a small JSON document describing every spec; each
array lives under `"<spec number>/<consts|params>/<key>"`.

Python scalars (ints, floats, bools, strings) ride in the JSON index;
everything array-like is stored as an array with its dtype.

An optional `aux` section carries tables outside the node graph, as the
JAX reader's fourth value does (config/reader.py:367-370): the Monte Carlo
move tables `pivot_moves` (proposal_pot, pivot_atom, pivot_restype,
pivot_range) and `jump_moves` (atom_range, sigma_trans, sigma_rot), each
array under `"aux/<section>/<key>"`.  A bundle without it has no `aux`
entry in its index.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

FORMAT_VERSION = 1


@dataclass
class SpecRecord:
    """One node of the graph, framework-free."""
    name: str
    type_name: str
    args: List[str]
    consts: Dict[str, Any] = field(default_factory=dict)
    params: Dict[str, Any] = field(default_factory=dict)


def _split(values: Dict[str, Any], prefix: str, arrays: Dict[str, np.ndarray]):
    index = {}
    for key, v in values.items():
        if isinstance(v, (bool, int, float, str)):
            index[key] = {"scalar": v}
        else:   # arrays and numpy scalars keep their dtype as arrays
            arrays[f"{prefix}/{key}"] = np.asarray(v)
            index[key] = {"array": True}
    return index


def save(path: str, specs: List[SpecRecord], pos: np.ndarray,
         aux: Dict[str, Dict[str, np.ndarray]] = None) -> str:
    """Write a bundle.  `pos` is the (n_atom, 3) initial structure; `aux`
    {section: {key: array}} the optional aux section."""
    arrays: Dict[str, np.ndarray] = {"pos": np.asarray(pos, np.float32)}
    entries = []
    for k, s in enumerate(specs):
        entries.append({
            "name": s.name, "type": s.type_name, "args": list(s.args),
            "consts": _split(s.consts, f"{k}/consts", arrays),
            "params": _split(s.params, f"{k}/params", arrays)})
    index = {"version": FORMAT_VERSION, "n_atom": int(np.shape(pos)[0]),
             "specs": entries}
    if aux:
        index["aux"] = {sec: sorted(tables) for sec, tables in aux.items()}
        for sec, tables in aux.items():
            for key, v in tables.items():
                arrays[f"aux/{sec}/{key}"] = np.asarray(v)
    arrays["__index__"] = np.frombuffer(
        json.dumps(index, sort_keys=True).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def _index(z, path):
    index = json.loads(bytes(z["__index__"]).decode())
    if index.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported bundle version "
                         f"{index.get('version')}")
    return index


def load(path: str) -> Tuple[List[SpecRecord], np.ndarray]:
    """Read a bundle.  Returns (specs, pos)."""
    with np.load(path, allow_pickle=False) as z:
        index = _index(z, path)
        pos = np.asarray(z["pos"])

        def unpack(desc, prefix):
            out = {}
            for key, d in desc.items():
                out[key] = (np.asarray(z[f"{prefix}/{key}"]) if "array" in d
                            else d["scalar"])
            return out

        specs = [SpecRecord(e["name"], e["type"], list(e["args"]),
                            unpack(e["consts"], f"{k}/consts"),
                            unpack(e["params"], f"{k}/params"))
                 for k, e in enumerate(index["specs"])]
    if pos.shape != (index["n_atom"], 3):
        raise ValueError(f"{path}: pos shape {pos.shape} does not match "
                         f"n_atom {index['n_atom']}")
    return specs, pos


def load_aux(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A bundle's aux section, {section: {key: array}}; {} without one."""
    with np.load(path, allow_pickle=False) as z:
        return {sec: {key: np.asarray(z[f"aux/{sec}/{key}"])
                      for key in keys}
                for sec, keys in _index(z, path).get("aux", {}).items()}
