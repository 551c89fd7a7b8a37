"""Compact sigmoid of the coarse-grained potentials (port of the main-path
part of upside_md_tpu/ops/sigmoid.py; reference src/vector_math.h:640-658)."""

from __future__ import annotations

import torch


def compact_sigmoid(x, sharpness):
    """Cubic compact sigmoid: 1 for x <= -1/sharpness, 0 for
    x >= 1/sharpness, 0.25*(y+2)*(y-1)^2 with y = x*sharpness between.
    Returns (value, dvalue/dx)."""
    y = x * sharpness
    val = 0.25 * (y + 2.0) * (y - 1.0) * (y - 1.0)
    der = sharpness * 0.75 * (y * y - 1.0)
    one, zero = torch.ones_like(val), torch.zeros_like(val)
    val = torch.where(y < -1.0, one, torch.where(y > 1.0, zero, val))
    der = torch.where((y < -1.0) | (y > 1.0), torch.zeros_like(der), der)
    return val, der
