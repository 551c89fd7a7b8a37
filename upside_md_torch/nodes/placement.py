"""Placement nodes (port of upside_md_tpu/nodes/placement.py; reference
src/placement.cpp): all seven variants.

Per-residue local data is placed with the rigid frames of
`affine_alignment`: points as R v + t, vectors as R v, scalars unchanged.
The data comes from a fixed per-layer table, or from a Rama-dependent
periodic 2-D spline."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.geometry import quat_to_rot, rotate_vec
from ..ops.spline import eval_periodic_bspline_2d, fit_periodic_bspline_2d
from .base import flat_param, register_node, rows
from .rama import rama_to_grid

SIG_WIDTH = {"scalar": 1, "point": 3, "vector": 3}


def _transform(signature, affine, val):
    t = affine[..., 0:3]
    R = quat_to_rot(affine[..., 3:7])
    out, off = [], 0
    for s in signature:
        v = val[..., off:off + SIG_WIDTH[s]]
        if s == "point":
            out.append(rotate_vec(R, v) + t)
        elif s == "vector":
            out.append(rotate_vec(R, v))
        else:
            out.append(v.expand(affine.shape[:-1] + v.shape[-1:]))
        off += SIG_WIDTH[s]
    return torch.cat(out, dim=-1)


def _fixed_placement(signature):
    def compute(c, p, inputs, ctx):
        affine = inputs[0][:, c["affine_residue"]]
        return _transform(signature, affine,
                          rows(p["placement_data"], c["layer_index"],
                               "placement_data" in ctx.stacked))
    return compute


def _rama_placement(signature):
    def compute(c, p, inputs, ctx):
        affine = inputs[0][:, c["affine_residue"]]
        rama = inputs[1][:, c["rama_residue"]]          # (B, n, 2)
        coeffs = rows(p["coeffs"], c["layer_index"],    # ([B,] n, nx, ny, w)
                      "coeffs" in ctx.stacked)
        coeffs = coeffs.movedim(-1, -3)                 # ([B,] n, w, nx, ny)
        x = rama_to_grid(rama[..., 0:1], coeffs.shape[-2])
        y = rama_to_grid(rama[..., 1:2], coeffs.shape[-1])
        width = coeffs.shape[-3]
        val, _, _ = eval_periodic_bspline_2d(
            coeffs, x.expand(x.shape[:-1] + (width,)),
            y.expand(y.shape[:-1] + (width,)))          # (B, n, w)
        return _transform(signature, affine, val)
    return compute


def make_rama_placement_params(placement_data):
    """Raw (n_layer, nx, ny, width) values -> {"coeffs": float32 fit}, one
    periodic 2-D fit a width column (placement.py:72-77)."""
    data = np.asarray(placement_data, np.float64)
    coeffs = np.stack([fit_periodic_bspline_2d(data[..., d])
                       for d in range(data.shape[-1])], axis=-1)
    return {"coeffs": coeffs.astype(np.float32)}


_get_data, _set_data = flat_param("placement_data")


def _fixed(name, signature):
    return register_node(name, False, _fixed_placement(signature),
                         get_param=_get_data, set_param=_set_data)


placement_scalar = register_node(
    "placement_scalar", False, _rama_placement(("scalar",)))
placement_fixed_scalar = _fixed("placement_fixed_scalar", ("scalar",))
placement_point_only = register_node(
    "placement_point_only", False, _rama_placement(("point",)))
placement_fixed_point_only = _fixed("placement_fixed_point_only",
                                    ("point",))
placement_point_vector_only = register_node(
    "placement_point_vector_only", False,
    _rama_placement(("point", "vector")))
placement_fixed_point_vector_only = _fixed(
    "placement_fixed_point_vector_only", ("point", "vector"))
placement_fixed_point_vector_scalar = _fixed(
    "placement_fixed_point_vector_scalar", ("point", "vector", "scalar"))
