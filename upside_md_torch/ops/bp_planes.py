"""Residue-plane BP: K6, its plain version, and the envelope-gradient rule.

Port of `bp_bethe_pallas` (upside_md_tpu/ops/pallas_bp.py:355), the BP
path of proteins with more than 512 sidechain beads and at most 128
residues (upside_md_tpu/nodes/rotamer.py:447-461).  Inputs keep the JAX
layout: the 1-body energies E1 (B, R, 6), the pair energies as 36 (a*6+b)
planes E2 (B, 36, R, R), the adjacency adj (B, R, R) bool (its diagonal is
ignored) and, from the rotamer statics, the slot validity (R, 6) and the
solver settings.  The Boltzmann planes P = exp(-E2) with validity folded
in are formed here, outside the kernel, as `_bp_impl` (:313-321) forms them
in XLA.

The solve is `_bp_solve` (rotamer.py:60-140) on the given adjacency, each
replica stopping at its own convergence; F is `bethe_free_energy`
(rotamer.py:142).  Besides F it returns the sum-normalised node beliefs nb
(B, R, 6), the edge messages eb (B, R, R, 6) (the port's cache layout,
identity on non-edges), the final deviation (B,) and the sweep count (B,).
The VJP scales the envelope gradients G1 (B, R, 6) and G2 (B, 36, R, R)
(nonzero on adjacent i < j only) by the cotangent of F, as `_bp_fwd` /
`_bp_bwd` (pallas_bp.py:376-390) do.

The plain version, `bp_bethe_planes_plain`, reuses `bp_solve_plain` and
`bethe_and_gradients` of ops/bp_pairs.py: it is the port of the XLA
`_bp_solve` + `bethe_free_energy`.  `planes_solver` chooses the solve by R
alone, as `_use_pallas_bp` (rotamer.py:271-275) does: on CUDA tensors K6
up to MAX_RES residues and the plain function above them, where the
reference has no kernel either; on CPU tensors (or when asked, for
comparisons on the card) the plain function.  The choice never depends on
whether a kernel ran, and `bp_planes_kernel` raises above MAX_RES.  K6 is
csrc/bp_bethe_planes.cu: a grid-wide prologue (adjacency bits, compact
edges, each directed edge's 36 factors gathered out of the planes), the
per-replica solve on the compact edges, and a grid-wide epilogue that
writes G2 and the dense messages (csrc/bp_common.cuh; the plain versions
of those passes are in ops/bp_pairs.py).  Residues i != j are joined
where either adj[i, j] or adj[j, i] is set, in the kernel and in the
plain version: the rotamer node's adjacency is symmetric, and one that is
not is symmetrised rather than trusted.
"""

from __future__ import annotations

import torch

from . import kernels
from .bp_pairs import (MAX_RES, NPAIR, NROT, BPScratch, bethe_and_gradients,
                       bp_solve_plain, node_potentials, small_outputs)


def boltzmann_planes(E2planes, valid):
    """P (B, 36, R, R) = exp(-E2) where both slots are valid, else 0."""
    R = valid.shape[0]
    v = valid.to(E2planes.dtype)
    vplanes = (v[:, :, None, None] * v[None, None]).permute(1, 3, 0, 2) \
        .reshape(NPAIR, R, R)
    return torch.exp(-E2planes) * vplanes


def bp_bethe_planes_plain(st, E1, P, adj, init=None):
    """Plain version of K6: (F, G1, G2, nb, eb, dev, iters)."""
    B, R = E1.shape[:2]
    P5 = P.reshape(B, NROT, NROT, R, R).permute(0, 3, 4, 1, 2)
    adj = (adj | adj.transpose(1, 2)) \
        & ~torch.eye(R, dtype=torch.bool, device=adj.device)
    offset, prob = node_potentials(E1, st.valid)
    nb, eb, dev, it = bp_solve_plain(prob, P5, adj, st.valid, st.damping,
                                     st.max_iter, st.tol, st.chunk, init)
    F, G1, G = bethe_and_gradients(E1, offset, prob, P5, adj, st.valid, nb,
                                   eb)
    G2 = G.permute(0, 3, 4, 1, 2).reshape(B, NPAIR, R, R)
    return F, G1, G2, nb, eb, dev, it


def k6(st, E1, P, adj, init=None):
    """K6's outputs (F, G1, G2, nb, eb, dev, iters)."""
    return bp_planes_kernel(st, E1, P, adj, init)[0]


def planes_solver(n_res, on_card, plain=False):
    """The solve of a residue-plane BP call of n_res residues: `k6` on the
    card up to MAX_RES residues, `bp_bethe_planes_plain` (the port of the
    XLA `_bp_solve`) above them, on the CPU, or when `plain` asks."""
    return k6 if on_card and not plain and n_res <= MAX_RES \
        else bp_bethe_planes_plain


def bp_bethe_planes_fwd(st, E1, P, adj, init=None, plain=False):
    """(F, G1, G2, nb, eb, dev, iters) from the solve `planes_solver`
    chooses."""
    return planes_solver(st.n_res, E1.is_cuda, plain)(st, E1, P, adj, init)


def bp_planes_kernel(st, E1, P, adj, init=None):
    """One call of K6's C entry point on CUDA tensors: ((F, G1, G2, nb, eb,
    dev, iters), scratch), the scratch as in `bp_pairs.bp_pairs_kernel`."""
    B, R = E1.shape[0], st.n_res
    if not 2 <= R <= MAX_RES:
        raise ValueError(f"bp_bethe_planes kernel supports 2 to {MAX_RES} "
                         f"residues, got {R}")
    warm = init is not None
    # a cold start passes null warm-start pointers
    nb0, eb0 = (t.contiguous() for t in init) if warm else (None, None)
    E1, P, adj = E1.contiguous(), P.contiguous(), adj.contiguous()
    checks = [(E1, (B, R, NROT)), (P, (B, NPAIR, R, R))]
    if warm:
        checks += [(nb0, (B, R, NROT)), (eb0, (B, R, R, NROT))]
    for t, shape in checks:
        if not t.is_cuda or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"bp_bethe_planes kernel takes CUDA float32 "
                             f"{shape}, got {t.device} {t.dtype} "
                             f"{tuple(t.shape)}")
    if not adj.is_cuda or adj.dtype != torch.bool \
            or tuple(adj.shape) != (B, R, R):
        raise ValueError(f"bp_bethe_planes kernel takes a CUDA bool "
                         f"adjacency {(B, R, R)}, got {adj.device} "
                         f"{adj.dtype} {tuple(adj.shape)}")
    scratch = BPScratch(B, R, False, E1.device)
    f32 = dict(dtype=torch.float32, device=E1.device)
    F, dev, G1, nb, iters = small_outputs(B, R, E1.device)
    G2 = torch.empty((B, NPAIR, R, R), **f32)
    eb = torch.empty((B, R, R, NROT), **f32)
    kernels.launch(
        "bp_bethe_planes", E1, P, adj, st.valid, nb0, eb0,
        B, R, st.damping, st.max_iter, st.tol, st.chunk, F, G1, G2, nb, eb, dev, iters, scratch.ibuf, scratch.fbuf)
    return (F, G1, G2, nb, eb, dev, iters), scratch


class BPPlanesFreeEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E1, E2planes, adj, st, init, plain):
        P = boltzmann_planes(E2planes, st.valid)
        F, G1, G2, nb, eb, dev, iters = bp_bethe_planes_fwd(
            st, E1, P, adj, init, plain)
        ctx.save_for_backward(G1, G2)
        ctx.mark_non_differentiable(nb, eb, dev, iters)
        return F, nb, eb, dev, iters

    @staticmethod
    def backward(ctx, gF, *unused):
        G1, G2 = ctx.saved_tensors
        return gF[:, None, None] * G1, gF[:, None, None, None] * G2, None, \
            None, None, None


def bp_bethe_planes(st, E1, E2planes, adj, init=None, plain=False):
    """(F, nb, eb, dev, iters); F differentiable in E1 and E2planes."""
    return BPPlanesFreeEnergy.apply(E1, E2planes, adj, st, init, plain)
