"""Ramachandran map potential (port of upside_md_tpu/nodes/rama.py;
reference src/rama_map_pot.cpp)."""

from __future__ import annotations

import math

from ..ops.spline import eval_periodic_bspline_2d
from .base import register_node, rows


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


def _no_raw_map(*args):
    """The JAX hooks (rama.py:57-69) read and refit the raw map, which the
    bundles drop for size (convert.DROPPED)."""
    raise NotImplementedError(
        "rama_map_pot get_param/set_param need the raw Rama map, which the "
        "port's bundles do not carry")


rama_map_pot = register_node("rama_map_pot", True, _rama_map_pot,
                             get_param=_no_raw_map, set_param=_no_raw_map)
