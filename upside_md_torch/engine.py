"""Upside-compatible Python API (port of upside_md_tpu/engine.py:28-107).

Mirrors the surface of the reference's upside_engine.py `Upside` class
(py/upside_engine.py:159-242): energy / deriv / get_output / get_sens /
get_output_dims / get_param / set_param / get_param_deriv.  The backing
engine is the port's `System`; parameter derivatives come from autograd
with respect to the node's parameter tensors, through the kernels' table
cotangents.  Positions go in and results come out as numpy arrays of one
configuration, (n_atom, 3), as in the reference.  `get_value_by_name` is
the diagnostics channel (engine.py:109-183): the rotamer node's channels
and `count_edges_by_type` of the pair nodes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import load
from .nodes.base import type_pairs
from .nodes.rotamer import rotamer_1body_energy, rotamer_diagnostics
from .ops.pairs import quadspline_family, sequence_exclusion_mask
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
    configuration (upside_engine.py:172-242).  `system_or_config_path` is
    a `System`, or the path of a `.up` configuration or a spec bundle
    (`config.load`), whose System runs on `device` (the card unless the
    caller asks for the CPU) and whose aux tables (Monte Carlo moves,
    sequence) stay in `aux`, as the JAX engine keeps its reader's."""

    def __init__(self, system_or_config_path, params=None, initial_pos=None,
                 device="cuda", dtype=torch.float32):
        self.aux = {}
        if isinstance(system_or_config_path, System):
            self.system = system_or_config_path
            self._pos = initial_pos
        else:
            records, pos, self.aux = load(system_or_config_path)
            self.system, self._pos = System.from_records(records, pos,
                                                         device, dtype)
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

    def get_value_by_name(self, node_name, log_name):
        """Diagnostics channel (reference DerivComputation::get_value_by_name,
        rotamer.cpp:675-773, hbond.cpp:406-412): the rotamer node's
        channels (and the aliases `edge_marginal_in_graph_order`,
        `n_node`, `rotamer_1body_energy<k>`), and `count_edges_by_type` of
        the rotamer, coverage and environment nodes.  Anything else
        raises, as the JAX method does."""
        spec = self.system.by_name[node_name]
        with torch.no_grad():
            outputs = self.system.evaluate(self._batch())[1]
            c, p = self.system.consts[node_name], self.params[node_name]
            if spec.node_type.name == "rotamer":
                inputs = [outputs[a] for a in spec.args]
                if log_name.startswith("rotamer_1body_energy"):
                    k = int(log_name[len("rotamer_1body_energy"):] or 0)
                    return rotamer_1body_energy(c, p, inputs, k)[0] \
                        .cpu().numpy()
                if log_name == "n_node":
                    return np.array([float(c["bp"].n_res)])
                diag = rotamer_diagnostics(c, p, inputs)
                key = {"edge_marginal_in_graph_order": "edge_marginal"} \
                    .get(log_name, log_name)
                if key in diag:
                    return diag[key][0].cpu().numpy()
            if log_name == "count_edges_by_type":
                return self._count_edges_by_type(spec, outputs)
        raise ValueError(f"value {log_name} not implemented for {node_name}")

    def _count_edges_by_type(self, spec, outputs):
        """Edge counts per (type1, type2) pair, flattened: the pairs inside
        the cutoff under the node's own mask (reference
        interaction_graph.h:427-441)."""
        c = self.system.consts[spec.name]
        name = spec.node_type.name
        table = self.params[spec.name]["interaction_param"]

        def sq_dist(x1, x2):
            return ((x1[:, None] - x2[None, :]) ** 2).sum(-1)
        if name == "rotamer":
            x = outputs[spec.args[0]][0, c["index"], 0:3]
            _, k, dx = quadspline_family(table.shape[-1])
            cutoff = (k - 2 - 1e-6) * dx
            res = c["res"]
            n = len(res)
            mask = (sq_dist(x, x) < cutoff * cutoff) & torch.ones(
                n, n, dtype=torch.bool, device=x.device).triu(1) \
                & (res[:, None] != res[None, :])
            t1 = t2 = c["type"]
        elif name in ("hbond_coverage", "environment_coverage"):
            x1 = outputs[spec.args[0]][0, c["index1"], 0:3]
            x2 = outputs[spec.args[1]][0, c["index2"], 0:3]
            t1, t2 = c["type1"], c["type2"]
            if name == "hbond_coverage":
                _, k, dx = quadspline_family(table.shape[-1])
                cutoff = (k - 2 - 1e-6) * dx
            else:
                prm = type_pairs(table, t1, t2, False)
                cutoff = prm[..., 0] + 1.0 / prm[..., 1]
            mask = (sq_dist(x1, x2) < cutoff * cutoff) \
                & sequence_exclusion_mask(c["id1"], c["id2"], 2)
        else:
            raise ValueError(
                f"count_edges_by_type not implemented for {name}")
        i, j = torch.nonzero(mask, as_tuple=True)
        n2t = table.shape[1]
        out = torch.zeros(table.shape[0] * n2t, dtype=torch.float64,
                          device=mask.device)
        out.index_add_(0, t1[i] * n2t + t2[j],
                       torch.ones(len(i), dtype=out.dtype, device=out.device))
        return out.cpu().numpy()
