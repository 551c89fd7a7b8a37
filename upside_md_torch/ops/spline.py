"""Uniform cubic B-spline evaluation (port of upside_md_tpu/ops/spline.py).

Knots sit on the integer grid and the coefficient with index k is centered
at k-1, so an evaluation at x touches coefficients floor(x)-1 .. floor(x)+2
(reference src/spline.h:97-310).  The JAX package evaluates with dense
window weights over the whole knot axis because gathers are slow on a TPU;
here the four coefficients are gathered directly.  The host-side fits a
`.up` reader runs at load time (float64 numpy, ops/spline.py:207-269 of
the JAX package, in the same order of operations) close the module.
"""

from __future__ import annotations

import numpy as np
import torch


def bspline_weights(t):
    """Weights of coefficients [i-1, i, i+1, i+2] at x = i + t."""
    s = 1.0 - t
    return torch.stack([
        s * s * s / 6.0,
        (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0,
        (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / 6.0,
        t * t * t / 6.0], dim=-1)


def bspline_dweights(t):
    """d/dx of `bspline_weights` (grid spacing 1)."""
    s = 1.0 - t
    return torch.stack([
        -0.5 * s * s,
        0.5 * (3.0 * t * t - 4.0 * t),
        0.5 * (-3.0 * t * t + 2.0 * t + 1.0),
        0.5 * t * t], dim=-1)


def _window(x, n_knot):
    """Interior window start i (clipped to [1, n_knot-3]) and fraction t."""
    i = torch.clamp(torch.floor(x.detach()), 1, n_knot - 3)
    return i.long(), x - i


def _gather4(coeffs, i):
    """coeffs (..., n_knot) broadcast against i (...): the 4 window
    coefficients (..., 4) starting at i-1."""
    idx = (i - 1).unsqueeze(-1) + torch.arange(4, device=i.device)
    shape = torch.broadcast_shapes(coeffs.shape[:-1], i.shape)
    return torch.gather(coeffs.expand(shape + coeffs.shape[-1:]), -1,
                        idx.expand(shape + (4,)))


def eval_bspline(coeffs, x):
    """Value and d/dx of a coefficient-form spline at x in [1, n_knot-2)
    (reference deBoor_value_and_deriv, src/spline.h:97-128)."""
    i, t = _window(x, coeffs.shape[-1])
    c = _gather4(coeffs, i)
    return ((bspline_weights(t) * c).sum(-1),
            (bspline_dweights(t) * c).sum(-1))


def eval_clamped_bspline(coeffs, x):
    """Constant value and zero slope outside [1, n_knot-2] (reference
    clamped_deBoor_value_and_deriv, src/spline.h:268-272)."""
    n = coeffs.shape[-1]
    lo, hi = 1.0, float(n - 2)
    val, der = eval_bspline(coeffs, torch.clamp(x, lo, hi))
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    cb = coeffs.expand(shape + (n,))
    left = (cb[..., 0] + 4.0 * cb[..., 1] + cb[..., 2]) / 6.0
    right = (cb[..., -3] + 4.0 * cb[..., -2] + cb[..., -1]) / 6.0
    val = torch.where(x <= lo, left, torch.where(x >= hi, right, val))
    der = torch.where((x <= lo) | (x >= hi), torch.zeros_like(der), der)
    return val, der


def bspline_window_weights(x, n_knot, clamped=True):
    """Dense window weights W (..., n_knot), value = sum_m W_m c_m; for
    clamped splines the boundary weights are the (1/6, 2/3, 1/6) stencils
    of the end values."""
    i, t = _window(x, n_knot)
    w = bspline_weights(t)
    rel = torch.arange(n_knot, device=x.device) - i.unsqueeze(-1) + 1
    W = torch.zeros(x.shape + (n_knot,), dtype=x.dtype, device=x.device)
    for k in range(4):
        W = torch.where(rel == k, w[..., k:k + 1], W)
    if clamped:
        stencil = torch.tensor([1 / 6, 4 / 6, 1 / 6], dtype=x.dtype,
                               device=x.device)
        left = torch.zeros(n_knot, dtype=x.dtype, device=x.device)
        right = torch.zeros_like(left)
        left[:3] = stencil
        right[-3:] = stencil
        W = torch.where((x <= 1.0).unsqueeze(-1), left,
                        torch.where((x >= n_knot - 2.0).unsqueeze(-1),
                                    right, W))
    return W


def eval_periodic_bspline_2d(coeffs, x, y):
    """Periodic bicubic surface: coeffs (..., nx, ny), x/y (...) on the
    grid with indices wrapping modulo its size.  Returns (value, d/dx,
    d/dy) (reference src/spline.h:434-450)."""
    nx, ny = coeffs.shape[-2], coeffs.shape[-1]
    ix = torch.floor(x.detach()).long()
    iy = torch.floor(y.detach()).long()
    tx, ty = x - ix, y - iy
    ar = torch.arange(4, device=x.device) - 1
    rows = torch.remainder(ix.unsqueeze(-1) + ar, nx)          # (..., 4)
    cols = torch.remainder(iy.unsqueeze(-1) + ar, ny)
    shape = torch.broadcast_shapes(coeffs.shape[:-2], x.shape)
    cb = coeffs.expand(shape + (nx, ny))
    sub = torch.gather(cb, -2, rows.expand(shape + (4,)).unsqueeze(-1)
                       .expand(shape + (4, ny)))               # (..., 4, ny)
    sub = torch.gather(sub, -1, cols.expand(shape + (4,)).unsqueeze(-2)
                       .expand(shape + (4, 4)))                # (..., 4, 4)
    wx, dwx = bspline_weights(tx), bspline_dweights(tx)
    wy, dwy = bspline_weights(ty), bspline_dweights(ty)
    cy = (sub * wx.unsqueeze(-1)).sum(-2)                      # (..., 4)
    cdx = (sub * dwx.unsqueeze(-1)).sum(-2)
    return (cy * wy).sum(-1), (cdx * wy).sum(-1), (cy * dwy).sum(-1)


def eval_clamped_interp(coeffs, x):
    """A spline fitted by the JAX package's `fit_clamped_interp_bspline`
    (the bundle stores its coefficients) at data coordinates x: the data
    domain [0, n-1], n = coeffs.shape[-1] - 2, with constant value and zero
    slope outside it (ops/spline.py:272; reference LayeredClampedSpline1D,
    src/spline.h:454-516)."""
    return eval_clamped_bspline(coeffs, x + 1.0)


# ---------------------------------------------------------------------------
# host-side fitting (float64 numpy; load time only)
# ---------------------------------------------------------------------------

def _cyclic(n):
    """The periodic interpolation matrix (2/3 on the diagonal, 1/6 on the
    cyclic off-diagonals): knot values = A @ coefficients."""
    A = np.zeros((n, n))
    idx = np.arange(n)
    A[idx, idx] = 2.0 / 3.0
    A[idx, (idx + 1) % n] = 1.0 / 6.0
    A[idx, (idx - 1) % n] = 1.0 / 6.0
    return A


def fit_periodic_bspline_1d(data):
    """B-spline coefficients of the periodic interpolating cubic spline of
    `data` (..., n) (reference solve_periodic_1d_spline,
    src/spline.cpp:121-156); A is symmetric, so right-multiplying by its
    inverse solves along the last axis."""
    data = np.asarray(data, dtype=np.float64)
    return data @ np.linalg.inv(_cyclic(data.shape[-1]))


def fit_periodic_bspline_2d(data):
    """Coefficients (..., nx, ny) of the periodic bicubic B-spline surface
    that interpolates `data` (..., nx, ny) at the integer grid."""
    data = np.asarray(data, dtype=np.float64)
    Ax = np.linalg.inv(_cyclic(data.shape[-2]))
    Ay = np.linalg.inv(_cyclic(data.shape[-1]))
    return np.einsum('ij,...jk,lk->...il', Ax, data, Ay)


def periodic_bspline_2d_knot_values(coeffs):
    """The inverse of `fit_periodic_bspline_2d`: the surface's values at
    the integer grid, in float64.  Along each axis the value at knot i is
    (c[i-1] + 4 c[i] + c[i+1]) / 6, indices wrapping."""
    c = np.asarray(coeffs, dtype=np.float64)
    return np.einsum('ij,...jk,lk->...il', _cyclic(c.shape[-2]), c,
                     _cyclic(c.shape[-1]))


def fit_clamped_interp_bspline(data):
    """Coefficients (..., n+2) of the zero-slope-clamped interpolating
    cubic spline of `data` (..., n) at the integer grid, for
    `eval_clamped_interp` (c[0] == c[2] and c[-1] == c[-3]; reference
    solve_clamped_1d_spline, src/spline.cpp:192-259)."""
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[-1]
    # unknowns c[1..n]; conditions: c0 == c2, c[n+1] == c[n-1]
    A = np.zeros((n, n))
    idx = np.arange(n)
    A[idx, idx] = 2.0 / 3.0
    A[idx[:-1], idx[:-1] + 1] = 1.0 / 6.0
    A[idx[1:], idx[1:] - 1] = 1.0 / 6.0
    A[0, 1] += 1.0 / 6.0           # c0 -> c2 fold
    A[n - 1, n - 2] += 1.0 / 6.0   # c[n+1] -> c[n-1] fold
    inner = np.einsum('ij,...j->...i', np.linalg.inv(A), data)
    return np.concatenate([inner[..., 1:2], inner, inner[..., -2:-1]],
                          axis=-1)
