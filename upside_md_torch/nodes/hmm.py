"""Hidden-Markov-model nodes (port of upside_md_tpu/nodes/hmm.py;
reference src/hmm.cpp).

* fixed_hmm: the forward algorithm over per-residue state energies with a
  fixed transition-energy matrix; the potential is -log Z.  The reference
  hand-codes the backward pass (posterior marginals, expected transition
  counts); here it comes from autograd through the forward recursion.
* torus_dbn: von-Mises-like emission energies from (phi, psi).

The forward recursion is sequential over residues: plain PyTorch, a few
small launches a residue, each over every replica at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import flat_param, register_node, rows


def _forward(c, p, inputs):
    """(per-residue potential (B, n_res), total (B,)): residue r
    contributes its emission offset minus its forward normalisation, plus
    the transition offset for r > 0 (hmm.cpp:63-69, 94-103)."""
    e1b = inputs[0][:, c["index"]]                   # (B, n_res, S)
    te = p["transition_energy"]                      # ([B,] S, S)
    # offset by the softmin-expected transition energy for stability; the
    # potential does not depend on it
    w = torch.exp(te.amin((-2, -1), keepdim=True) - te)
    offset = (te * w).sum((-2, -1)) / w.sum((-2, -1))    # () or (B,)
    T = torch.exp(offset[..., None, None] - te)
    e_min = e1b.amin(-1)                             # (B, n_res)
    emission = torch.exp(e_min[..., None] - e1b)
    forward = torch.ones_like(emission[:, 0])        # (B, S)
    lognorms = []
    for r in range(e1b.shape[1]):
        if r > 0:
            forward = (forward.unsqueeze(-2) @ T).squeeze(-2)
        forward = forward * emission[:, r]
        norm = forward.sum(-1, keepdim=True)
        forward = forward / norm
        lognorms.append(torch.log(norm[..., 0]))
    n_res = e1b.shape[1]
    later = (torch.arange(n_res, device=e1b.device) > 0).to(e1b.dtype)
    per_res = e_min - torch.stack(lognorms, -1) \
        + (offset[..., None] if offset.dim() else offset) * later
    return per_res, per_res.sum(-1)


def _fixed_hmm(c, p, inputs, ctx):
    return _forward(c, p, inputs)[1]


def hmm_energy_decomposition(consts, params, inputs):
    """(total (B,), per-residue (B, n_res)) potential: the reference's
    'hmm_energy' / 'hmm_energy_1body' streams (hmm.cpp:94-103)."""
    per_res, total = _forward(consts, params, inputs)
    return total, per_res


def _torus_dbn(c, p, inputs, ctx):
    rama = inputs[0][:, c["id"]]                     # (B, n_res, 2)
    bp = c["basin_param"]     # (S, 6): [log_norm, kappa_phi, angle_phi,
    #                                    kappa_psi, angle_psi, kappa_cor]
    prior = rows(p["prior_offset_energies"], c["restypes"],
                 "prior_offset_energies" in ctx.stacked)
    phi, psi = rama[..., 0:1], rama[..., 1:2]
    # emission energy per (residue, state), hmm.cpp:275-314
    em = (-bp[:, 1] * torch.cos(phi - bp[:, 2])
          - bp[:, 3] * torch.cos(psi - bp[:, 4])
          + bp[:, 5] * torch.cos(phi - psi - (bp[:, 2] - bp[:, 4])))
    return prior + bp[:, 0] + em


_get_te, _set_te = flat_param("transition_energy", np.float32)
fixed_hmm = register_node("fixed_hmm", True, _fixed_hmm, get_param=_get_te,
                          set_param=_set_te)
_get_prior, _set_prior = flat_param("prior_offset_energies", np.float32)
torus_dbn = register_node("torus_dbn", False, _torus_dbn,
                          get_param=_get_prior, set_param=_set_prior)
