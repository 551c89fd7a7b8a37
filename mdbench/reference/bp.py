"""Plain loopy belief propagation and the Bethe free energy of the rotamer
problem (reference src/rotamer.cpp), for the benchmark's reference.

A residue i has six rotamer slots, of which `valid` (R, 6) says which
exist; E1 (B, R, 6) are the slots' 1-body energies and E2 (B, R, R, 6, 6)
the pair energies, symmetric (E2[i, j, a, b] == E2[j, i, b, a]).  Residues
are joined where any pair energy between them is nonzero; a pair with none
would pass uniform messages and add nothing to the free energy.

Sum-product messages are damped and max-normalised and the solve runs,
from a cold start, until no node belief moves by more than `tol`.  The
free energy is the Bethe free energy at the fixed point.  Its gradient is
carried by the envelope theorem: dF/dE1 is the node marginals and
dF/dE2 the pair marginals of each joined pair, so the returned value is
F with those marginals as its (fixed) slopes.
"""

from __future__ import annotations

import torch


def _normalise(x, dim=-1):
    return x / torch.clamp(x.sum(dim, keepdim=True),
                           min=torch.finfo(x.dtype).tiny)


def solve(prob, P, adj, damping, tol, max_iter):
    """Messages M[:, i, j] (B, R, R, 6) from residue i to j over j's slots,
    and the sweeps run.  prob (B, R, 6) node potentials (0 at invalid
    slots), P (B, R, R, 6, 6) pair factors, adj (B, R, R) bool."""
    B, R = prob.shape[:2]
    lo = torch.finfo(prob.dtype).tiny
    adjf = adj.unsqueeze(-1).to(prob.dtype)
    logprob = torch.log(torch.clamp(prob, min=lo))
    M = _normalise(torch.ones((B, R, R, 6), dtype=prob.dtype,
                              device=prob.device) * (prob > 0)[:, None])
    belief = _normalise(prob)
    for sweep in range(1, max_iter + 1):
        logM = torch.log(torch.clamp(M, min=lo)) * adjf
        field = logprob + logM.sum(1)                   # (B, R, 6)
        # cavity of i toward j: i's field without j's message to i
        cav = field[:, :, None, :] - logM.transpose(1, 2)
        cav = torch.exp(cav - cav.amax(-1, keepdim=True)) \
            * (prob > 0)[:, :, None, :]
        new = _normalise(torch.einsum("bija,bijac->bijc", cav, P))
        M = new if sweep == 1 else _normalise(
            (1.0 - damping) * new + damping * M)
        b = torch.exp(field - field.amax(-1, keepdim=True)) * (prob > 0)
        b = _normalise(b)
        moved = (b - belief).abs().amax()
        belief = b
        moved = float(moved)
        # a non-finite problem (a diverging low-precision control) stops
        if sweep > 1 and (moved <= tol or moved != moved):
            break
    return M, sweep


def marginals(prob, P, adj, M):
    """Node marginals (B, R, 6) and pair marginals (B, R, R, 6, 6) from
    converged messages."""
    lo = torch.finfo(prob.dtype).tiny
    logM = torch.log(torch.clamp(M, min=lo)) * adj.unsqueeze(-1).to(
        prob.dtype)
    field = torch.log(torch.clamp(prob, min=lo)) + logM.sum(1)
    valid = prob > 0
    b = _normalise(torch.exp(field - field.amax(-1, keepdim=True)) * valid)
    cav = field[:, :, None, :] - logM.transpose(1, 2)
    cav = torch.exp(cav - cav.amax(-1, keepdim=True)) * valid[:, :, None, :]
    pair = P * cav[..., :, None] * cav.transpose(1, 2)[..., None, :]
    pair = pair / torch.clamp(pair.sum((-1, -2), keepdim=True), min=lo)
    return b, pair


def _xlogy(x, y):
    return torch.where(x > 0, x * torch.log(torch.where(x > 0, y,
                                                        torch.ones_like(y))),
                       torch.zeros_like(x))


def free_energy(E1, E2, valid, damping, tol, max_iter):
    """Bethe free energy (B,) of the rotamer problem, differentiable in E1
    and E2 through the marginals (the envelope gradients)."""
    with torch.no_grad():
        e1, e2 = E1.detach(), E2.detach()
        R = e1.shape[1]
        pv = valid[:, None, :, None] & valid[None, :, None, :]
        eye = torch.eye(R, dtype=torch.bool, device=e1.device)
        adj = (torch.where(pv, e2, torch.zeros_like(e2)) != 0).any(-1) \
            .any(-1) & ~eye
        big = torch.finfo(e1.dtype).max
        offset = torch.where(valid, e1, torch.full_like(e1, big)).amin(-1)
        prob = torch.where(valid, torch.exp(offset[..., None] - e1),
                           torch.zeros_like(e1))
        P = torch.where(pv, torch.exp(-e2), torch.zeros_like(e2))
        M, _ = solve(prob, P, adj, damping, tol, max_iter)
        b, m = marginals(prob, P, adj, M)
        upper = torch.triu(adj, 1)[..., None, None]
        m = torch.where(upper, m, torch.zeros_like(m))
        bb = b[:, :, None, :, None] * b[:, None, :, None, :]
        node = (torch.where(valid, b * e1, torch.zeros_like(b))
                + _xlogy(b, b)).sum((-1, -2))
        edge = (torch.where(pv, m * e2, torch.zeros_like(m))
                + _xlogy(m, m) - _xlogy(m, bb)).sum((-1, -2, -3, -4))
        F = node + edge
    zero1 = torch.where(valid, E1 - e1, torch.zeros_like(E1))
    zero2 = torch.where(pv, E2 - e2, torch.zeros_like(E2))
    return F + (b * zero1).sum((-1, -2)) + (m * zero2).sum((-1, -2, -3, -4))
