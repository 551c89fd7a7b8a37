"""Carry a system built by the JAX package across to the port.

`from_jax_specs` takes the JAX package's `NodeSpec`s duck-typed (it reads
`.name`, `.node_type.name`, `.args`, `.consts` and `.params`) and returns
the framework-free `SpecRecord`s a bundle stores.  `params_from_jax` and
`params_to_numpy` carry a parameter pytree across in both directions.  The
module imports nothing from jax: `np.asarray` turns every array the caller
hands over into numpy.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from .config.bundle import SpecRecord

# entries the port's main path never reads: the raw Rama map only serves
# get_param/set_param, which rebuild it from the coefficients without it,
# the rotamer one-hots are rebuilt from `res`/`rot`, and the bead-type
# names are strings the graph does not use
DROPPED = {
    "rama_map_pot": {"raw_map"},
    "rotamer": {"onehot", "onehot_res"},
    "placement_fixed_point_vector_only": {"beadtype_seq"},
    "placement_scalar": {"beadtype_seq"},
}


def _to_numpy(v):
    return v if isinstance(v, (bool, int, float, str)) else np.asarray(v)


def from_jax_specs(specs: Iterable, pos) -> Tuple[List[SpecRecord],
                                                  np.ndarray]:
    """(JAX NodeSpecs, initial positions) -> (SpecRecords, pos as numpy)."""
    records = []
    for s in specs:
        tname = s.node_type.name
        drop = DROPPED.get(tname, set())
        consts = {k: _to_numpy(v) for k, v in s.consts.items()
                  if k not in drop}
        params = {k: _to_numpy(v) for k, v in s.params.items()
                  if k not in drop}
        records.append(SpecRecord(s.name, tname, list(s.args), consts,
                                  params))
    return records, np.asarray(pos, np.float32)


def params_from_jax(jax_params, device="cuda", dtype=torch.float32):
    """A JAX parameter pytree {node: {name: array}} (numpy or jax arrays)
    -> the port's {node: {name: tensor}}: floating arrays in `dtype`,
    others keep their kind (the port's `System.params` layout).  The
    tensors go to the card, as `System` and `Upside` do, unless `device`
    says otherwise; without a CUDA device the default raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_jax: no CUDA device; pass "
                           "device='cpu'")
    out = {}
    for node, p in jax_params.items():
        out[node] = {}
        for k, v in p.items():
            a = np.array(v)
            out[node][k] = torch.as_tensor(
                a, dtype=dtype if a.dtype.kind == "f" else None,
                device=device)
    return out


def params_to_numpy(params):
    """The port's {node: {name: tensor}} -> {node: {name: numpy array}}
    (what the JAX package's functions take)."""
    return {node: {k: v.detach().cpu().numpy()
                   if isinstance(v, torch.Tensor) else np.asarray(v)
                   for k, v in p.items()}
            for node, p in params.items()}
