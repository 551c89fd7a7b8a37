"""Upside-compatible Python API (port of upside_md_tpu/engine.py:28-107).

Mirrors the surface of the reference's upside_engine.py `Upside` class
(py/upside_engine.py:159-242): energy / deriv / get_output / get_sens /
get_output_dims / get_param / set_param / get_param_deriv.  The backing
engine is the port's `System`; parameter derivatives come from autograd
with respect to the node's parameter tensors, through the kernels' table
cotangents.  Positions go in and results come out as numpy arrays of one
configuration, (n_atom, 3), as in the reference.

Not ported yet: `get_value_by_name` and `count_edges_by_type` (ROADMAP).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .system import System


def _flatten_node_params(node_params: Dict) -> np.ndarray:
    """Every tensor of a node's parameters, flattened, in sorted-key order
    (engine.py:23-25)."""
    return np.concatenate([
        np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else v).ravel()
        for _, v in sorted(node_params.items())])


class Upside:
    """Engine object for analysis and training scripts.

    Stateful like the reference: `energy(pos)` and `deriv(pos)` keep pos, so
    that later get_output / get_sens / get_param_deriv refer to the same
    configuration (upside_engine.py:172-242).  `system_or_bundle_path` is a
    `System` or the path of a spec bundle; a bundle's System runs on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, system_or_bundle_path, params=None, initial_pos=None,
                 device="cuda", dtype=torch.float32):
        if isinstance(system_or_bundle_path, System):
            self.system = system_or_bundle_path
            self._pos = initial_pos
        else:
            self.system, self._pos = System.from_bundle(
                system_or_bundle_path, device, dtype)
        if params is not None:
            self.system.params = params
        self.n_atom = self.system.n_atom

    @property
    def params(self):
        return self.system.params

    def _batch(self, pos=None):
        if pos is not None:
            self._pos = torch.as_tensor(np.asarray(pos),
                                        dtype=self.system.dtype,
                                        device=self.system.device)
        if self._pos is None:
            raise ValueError("no configuration yet: call energy(pos) first")
        return self._pos.reshape(1, self.n_atom, 3)

    # -- reference-API methods ----------------------------------------------

    def energy(self, pos):
        with torch.no_grad():
            return float(self.system.evaluate(self._batch(pos))[0][0])

    def deriv(self, pos):
        g, _, _ = self.system.deriv(self._batch(pos))
        return g[0].cpu().numpy()

    def get_output(self, node_name):
        return self.system.get_output(self._batch(), node_name)[0] \
            .cpu().numpy()

    def get_sens(self, node_name):
        return self.system.get_sens(self._batch(), node_name)[0] \
            .cpu().numpy()

    def get_output_dims(self, node_name):
        return self.get_output(node_name).shape

    def get_param(self, node_name):
        spec = self.system.by_name[node_name]
        p = self.params.get(node_name, {})
        if spec.node_type.get_param is not None:
            return spec.node_type.get_param(self.system.consts[node_name], p)
        return _flatten_node_params(p)

    def set_param(self, param, node_name):
        spec = self.system.by_name[node_name]
        flat = np.asarray(param, np.float32).ravel()
        p = self.params.get(node_name, {})
        if spec.node_type.set_param is not None:
            new = spec.node_type.set_param(self.system.consts[node_name], p,
                                           flat)
        else:
            # generic: unflatten into the node's tensors, sorted keys
            size = sum(p[k].numel() for k in p)
            if size != flat.size:
                raise ValueError(f"bad param size for {node_name}: got "
                                 f"{flat.size}, expected {size}")
            new, off = dict(p), 0
            for k in sorted(p):
                t = p[k]
                new[k] = torch.as_tensor(
                    flat[off:off + t.numel()].reshape(tuple(t.shape)),
                    dtype=t.dtype, device=t.device)
                off += t.numel()
        self.params[node_name] = new

    def get_param_deriv(self, node_name):
        """d(total potential)/d(node params), flattened in get_param order
        (sorted keys)."""
        grads = self.system.param_deriv(self._batch(), node_name)
        return _flatten_node_params(grads)
