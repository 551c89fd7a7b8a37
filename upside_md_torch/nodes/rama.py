"""Ramachandran map potential (port of upside_md_tpu/nodes/rama.py;
reference src/rama_map_pot.cpp).

The node evaluates fitted periodic spline coefficients; the flat
parameters of the reference's get_param/set_param are the raw map the
coefficients interpolate.  A system read from a `.up` keeps that map as
the float64 numpy const `raw_map`; a bundle drops it for size
(convert.DROPPED), and then get_param rebuilds it from the float32
coefficients by the spline's interpolation identity."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.spline import (eval_periodic_bspline_2d, fit_periodic_bspline_2d,
                          periodic_bspline_2d_knot_values)
from .base import register_node, rows, to_tensor


def rama_to_grid(rama, n_grid):
    """Angle in (-pi, pi] -> spline grid coordinate, with the reference's
    scaling (rama_map_pot.cpp:66-76)."""
    return (rama + math.pi) * (n_grid * (0.5 / math.pi - 1e-7))


def rama_map_pot_per_residue(c, p, inputs, stacked=False):
    """Per-residue map potential (B, n_res), the reference's
    'rama_map_potential' logging stream (rama_map_pot.cpp:50-54); `stacked`
    when the coefficients carry a leading replica axis."""
    rama = inputs[0][:, c["residue_id"]]               # (B, n_res, 2)
    coeffs = rows(p["coeffs"], c["rama_map_id"], stacked)
    x = rama_to_grid(rama[..., 0], coeffs.shape[-2])   # ([B,] n_res, nx, ny)
    y = rama_to_grid(rama[..., 1], coeffs.shape[-1])
    val, _, _ = eval_periodic_bspline_2d(coeffs, x, y)
    return val


def _rama_map_pot(c, p, inputs, ctx):
    return rama_map_pot_per_residue(c, p, inputs,
                                    "coeffs" in ctx.stacked).sum(-1)


def make_rama_map_params(raw):
    """Raw (n_layer, nx, ny) map values -> {"coeffs": float32 fit} (fitted
    in float64, rama.py:57-60)."""
    coeffs = fit_periodic_bspline_2d(np.asarray(raw, np.float64))
    return {"coeffs": coeffs.astype(np.float32)}


def _prepare(c, device, dtype):
    """Every const a tensor but `raw_map`, which stays a host float64
    array for get_param."""
    return {k: np.array(v, np.float64) if k == "raw_map"
            else to_tensor(v, device, dtype) for k, v in c.items()}


def _get_param(c, p):
    """The raw map, flat, in float64: the `.up`'s (or the last set_param's)
    where the node keeps one, else the knot values of the coefficients."""
    if "raw_map" in c:
        return np.asarray(c["raw_map"]).ravel()
    coeffs = p["coeffs"].detach().cpu().numpy()
    return periodic_bspline_2d_knot_values(coeffs).ravel()


def _set_param(c, p, flat):
    """Refit the coefficients to a new raw map (reshaped to their shape,
    rama.py:63-68) and keep the map in the node's consts, where get_param
    reads it."""
    t = p["coeffs"]
    raw = np.asarray(flat, np.float64).reshape(tuple(t.shape))
    c["raw_map"] = raw
    coeffs = make_rama_map_params(raw)["coeffs"]
    return {**p, "coeffs": torch.as_tensor(coeffs, dtype=t.dtype,
                                           device=t.device)}


rama_map_pot = register_node("rama_map_pot", True, _rama_map_pot,
                             prepare=_prepare, get_param=_get_param,
                             set_param=_set_param)
