"""Backbone steric repulsion (port of upside_md_tpu/nodes/steric.py;
reference src/backbone_steric.cpp).  Up to four frame-placed atoms per
residue; residue pairs more than one apart repel through a compact sigmoid
of squared distance that is exactly zero beyond r^2 = 9.3.

A replica's energy sums its (4R, 4R) pair grid by `halving_sum`, in an
order fixed by the grid's shape alone: a reduction kernel on the card
splits a long sum by how many outputs it has, so `.sum((-1, -2))` gave a
replica a different rounding in a batch of 16 than in one of 64."""

from __future__ import annotations

import torch

from ..ops.geometry import quat_to_rot, rotate_vec
from ..ops.sigmoid import compact_sigmoid
from .base import register_node, to_tensor

ENERGY_SCALE = 4.0
WALL2 = 3.0 * 3.0
SHARPNESS = 1.0 / (3.0 * 0.10)  # 1/(wall*width), backbone_steric.cpp:22-27


def _prepare(c, device, dtype):
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    # static atom-pair mask: residue ids more than one apart, each
    # unordered pair once, both atoms present
    rid = out["id"].repeat_interleave(4)
    valid = out["atom_mask"].reshape(-1)
    d = rid[:, None] - rid[None, :]
    out["pair_mask"] = (d < -1) & valid[:, None] & valid[None, :]
    return out


class _HalvingSum(torch.autograd.Function):
    """`halving_sum`, with the backward of any sum: the cotangent
    broadcast over the summed dim (one view, where autograd through the
    halvings would launch a zero fill and a copy for each slice)."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = n = x.shape[-1]
        while n > 1:
            if n % 2:       # an odd rest: padded once, to a power of two
                width = 1 << (n - 1).bit_length()
                x = torch.nn.functional.pad(x, (0, width - n))
                n = width
            n //= 2
            x = x[..., :n] + x[..., n:]
        return x[..., 0]

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(*g.shape, ctx.n)


def halving_sum(x):
    """Sum over the last dim by halving: its halves added elementwise
    while its length is even, an odd rest zero-padded to a power of two
    and halved on (a grid's sum pads only that rest, not the grid).  Only
    elementwise adds, so every replica's sum takes an order fixed by the
    shape, in any batch, on any device."""
    return _HalvingSum.apply(x)


def _backbone_pairs(c, p, inputs, ctx):
    affine = inputs[0][:, c["id"]]                     # (B, n_res, 7)
    R = quat_to_rot(affine[..., 3:7])
    atoms = rotate_vec(R.unsqueeze(-3), c["ref_pos"]) \
        + affine[..., None, 0:3]                       # (B, n_res, 4, 3)
    ax = atoms.reshape(atoms.shape[0], -1, 3)
    d = ax.unsqueeze(1) - ax.unsqueeze(2)
    r2 = (d * d).sum(-1)
    v, _ = compact_sigmoid(r2 - WALL2, SHARPNESS)
    v = torch.where(c["pair_mask"], v, torch.zeros_like(v))
    return ENERGY_SCALE * halving_sum(v.flatten(-2))


backbone_pairs = register_node("backbone_pairs", True, _backbone_pairs,
                               prepare=_prepare)
