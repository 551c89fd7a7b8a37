"""Inference-only neural-network potential nodes (port of
upside_md_tpu/nodes/nn.py; reference src/nn.cpp).

The convolution is one einsum over the stacked windows; its backward is
autograd's."""

from __future__ import annotations

import torch

from .base import register_node

ACTIVATIONS = {"ReLU": torch.relu, "Tanh": torch.tanh,
               "Identity": lambda y: y}


def _backbone_featurizer(c, p, inputs, ctx):
    """(sin phi, cos phi, sin psi, cos psi, donor hbond, acceptor hbond)
    per residue; an index of -1 has no donor or acceptor (nn.py:15-26)."""
    rama, hbond = inputs
    r = rama[:, c["rama_idx"]]

    def hb(idx):
        v = hbond[:, torch.clamp(idx, min=0), 6]
        return torch.where(idx >= 0, v, torch.zeros_like(v))
    return torch.stack([torch.sin(r[..., 0]), torch.cos(r[..., 0]),
                        torch.sin(r[..., 1]), torch.cos(r[..., 1]),
                        hb(c["donor_idx"]), hb(c["acceptor_idx"])], dim=-1)


def _conv1d(c, p, inputs, ctx):
    """Valid 1-D convolution over the element axis, then the activation:
    (B, n_in, c_in) -> (B, n_in - width + 1, c_out)."""
    act = c["activation"]
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act}")
    x = inputs[0]
    w, b = p["weights"], p["bias"]                   # ([B,] width, c, o)
    width = w.shape[-3]
    n_out = x.shape[1] - width + 1
    windows = torch.stack([x[:, i:i + n_out] for i in range(width)], dim=2)
    if "weights" in ctx.stacked:
        y = torch.einsum("bnwc,bwco->bno", windows, w)
    else:
        y = torch.einsum("bnwc,wco->bno", windows, w)
    return ACTIVATIONS[act](y + (b[:, None] if "bias" in ctx.stacked else b))


def _scaled_sum(c, p, inputs, ctx):
    return c["scale"] * inputs[0][..., 0].sum(-1)


backbone_featurizer = register_node("backbone_featurizer", False,
                                    _backbone_featurizer)
conv1d = register_node("conv1d", False, _conv1d)
scaled_sum = register_node("scaled_sum", True, _scaled_sum)
