"""Bead-space BP: K2, its plain version, and the envelope-gradient rule.

Port of `bp_bethe_pairs` (upside_md_tpu/ops/pallas_bp.py:1303): from the
1-body energies E1 (B, R, 6) and the bead-pair grid E_pair (B, n2p, n2p)
(each unordered pair once, upper triangle) to the Bethe free energy F and
its envelope gradients G1 = dF/dE1 and dE = dF/dE_pair.  The solve follows
the dense `_bp_solve` (upside_md_tpu/nodes/rotamer.py:60-140):

* rot-slot scatter by index: E2[i,j,a,b] = U[i,j,a,b] + U[j,i,b,a] with
  U[i,j,a,b] = sum of E_pair over the beads of slots (i,a) and (j,b);
  P = exp(-E2) at valid slot pairs;
* residues i != j are adjacent when any of their 36 E2 entries is nonzero.
  Other pairs have identity potentials, which do not move the fixed point
  and carry zero Bethe edge energy, so they are skipped;
* damped synchronous loopy BP: an undamped first sweep on a cold start,
  max-normalised beliefs with EPS 1e-10, the log-space node update with
  max-centring, a convergence test every `chunk` sweeps, `max_iter` and
  `tol` from the config.  Each replica stops at its own convergence;
* Bethe F (`bethe_free_energy`, rotamer.py:142) and its envelope
  gradients: G1 = b q + (1 - sum b q) [argmin], q = p/(EPS+p); and
  dF/dE2 = m pbb/(EPS+pbb) on adjacent i<j, gathered back to bead pairs.

The VJP is an elementwise scale of (G1, dE) by the cotangent of F.
Besides F it returns the sum-normalised node beliefs nb (B, R, 6), the
edge messages eb (B, R, R, 6), the final deviation (B,) and the sweep
count (B,).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels

NROT = 6
EPS = 1e-10
MAX_RES = 128       # residues one BP kernel block holds (bp_common.cuh)


@dataclass
class BPStatics:
    n_res: int
    n_bead: int
    n2p: int
    slot_beads: torch.Tensor  # (R*6, m) int32 bead of each slot, n2p = none
    bead_slot: torch.Tensor   # (n_bead,) int32 res*6 + rot
    valid: torch.Tensor       # (R, 6) bool
    damping: float
    max_iter: int
    tol: float
    chunk: int


def make_statics(res, rot, valid, n2p, damping, max_iter, tol, chunk,
                 device):
    res, rot = np.asarray(res), np.asarray(rot)
    n_res = int(np.asarray(valid).shape[0])
    slot = res * NROT + rot
    m = max(1, int(np.bincount(slot, minlength=n_res * NROT).max()))
    slot_beads = np.full((n_res * NROT, m), n2p, np.int32)
    fill = np.zeros(n_res * NROT, np.int64)
    for b, s in enumerate(slot):
        slot_beads[s, fill[s]] = b
        fill[s] += 1
    return BPStatics(
        n_res=n_res, n_bead=len(res), n2p=n2p,
        slot_beads=torch.as_tensor(slot_beads, device=device),
        bead_slot=torch.as_tensor(slot.astype(np.int32), device=device),
        valid=torch.as_tensor(np.asarray(valid, bool), device=device),
        damping=float(damping), max_iter=int(max_iter), tol=float(tol),
        chunk=max(1, int(chunk)))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def scatter_pairs(st, E_pair):
    """(B, n, n) bead grid, n >= n_bead (padded or not) -> E2 (B, R, R, 6,
    6), exactly symmetric."""
    B, R, n = E_pair.shape[0], st.n_res, E_pair.shape[-1]
    R6, m = R * NROT, st.slot_beads.shape[1]
    Ep = torch.nn.functional.pad(E_pair, (0, 1, 0, 1))   # index n -> 0
    sb = torch.clamp(st.slot_beads.long(), max=n).reshape(-1)
    # two index_selects, summed over each slot's beads: their backward is
    # an index_add (advanced indexing's sort-based backward took 45% of the
    # device time of an RNase A evaluation at 512 replicas on an H100)
    rows = Ep.index_select(1, sb).reshape(B, R6, m, n + 1).sum(2)
    U = rows.index_select(2, sb).reshape(B, R6, R6, m).sum(3)
    U = U.reshape(B, R, NROT, R, NROT).permute(0, 1, 3, 2, 4)
    return U + U.permute(0, 2, 1, 4, 3)


def node_potentials(E1, valid):
    """offset (B, R) = min valid E1; prob = exp(offset - E1) at valid."""
    big = torch.full_like(E1, float("inf"))
    offset = torch.where(valid, E1, big).min(-1).values
    prob = torch.where(valid, torch.exp(offset[..., None] - E1),
                       torch.zeros_like(E1))
    return offset, prob


def bp_solve_plain(prob, P, adj, valid, damping, max_iter, tol, chunk,
                   init=None):
    """`_bp_solve` over a replica batch, each replica stopping at its own
    convergence.  prob (B, R, 6), P (B, R, R, 6, 6), adj (B, R, R) bool.
    Returns (nb sum-normalised, eb (B, R, R, 6), dev (B,), iters (B,))."""
    adf = adj[..., None].to(prob.dtype)
    vmask = valid[None, :, None, :]

    def edge_update(nb_v, eb):
        V = nb_v[:, :, None, :] / (EPS + eb)             # V[j,i,b]
        m = (P * V.transpose(1, 2)[:, :, :, None, :]).sum(-1)
        m = torch.where(vmask, m, torch.zeros_like(m))
        m = m / torch.clamp(m.sum(-1, keepdim=True), min=EPS)
        return torch.where(adj[..., None], m, torch.ones_like(m))

    def node_update(eb):
        s = (torch.log(torch.clamp(eb, min=1e-30)) * adf).sum(2)
        s = s - s.max(-1, keepdim=True).values
        nb = prob * torch.exp(s)
        return nb / torch.clamp(nb.max(-1, keepdim=True).values, min=EPS)

    B, R = prob.shape[:2]
    if init is None:
        eb = edge_update(prob, torch.ones((B, R, R, NROT), dtype=prob.dtype,
                                          device=prob.device))
        nb = prob
    else:
        nb, eb = init[0].to(prob.dtype), init[1].to(prob.dtype)
    nb = nb / torch.clamp(nb.max(-1, keepdim=True).values, min=EPS)

    it = torch.zeros(B, dtype=torch.int32, device=prob.device)
    dev = torch.full((B,), float("inf"), dtype=prob.dtype, device=prob.device)
    active = torch.ones(B, dtype=torch.bool, device=prob.device)
    while bool(active.any()):
        nb_c, eb_c = nb, eb
        for _ in range(chunk):
            nb_prev = nb_c
            eb_c = edge_update(nb_c, eb_c)
            nb_c = (1.0 - damping) * node_update(eb_c) + damping * nb_c
        dev_c = (nb_c - nb_prev).abs().amax((-1, -2))
        a = active
        nb = torch.where(a[:, None, None], nb_c, nb)
        eb = torch.where(a[:, None, None, None], eb_c, eb)
        dev = torch.where(a, dev_c, dev)
        it = it + chunk * a.to(torch.int32)
        active = a & (it < max_iter) & (dev > tol)
    nb = nb / torch.clamp(nb.sum(-1, keepdim=True), min=EPS)
    return nb, eb, dev, it


def bethe_and_gradients(E1, offset, prob, P, adj, valid, nb, eb):
    """Bethe F (B,) with its envelope gradients G1 (B, R, 6) and G
    (B, R, R, 6, 6) (nonzero on adjacent i<j)."""
    b = nb
    zero = torch.zeros_like(b)
    node_en = offset + torch.where(
        valid, b * torch.log((EPS + b) / (EPS + prob)), zero).sum(-1)
    q = prob / (EPS + prob)
    sum_bq = torch.where(valid, b * q, zero).sum(-1, keepdim=True)
    masked = torch.where(valid, E1, torch.full_like(E1, float("inf")))
    first_min = torch.nn.functional.one_hot(
        masked.argmin(-1), NROT).to(b.dtype)
    G1 = torch.where(valid, b * q + (1.0 - sum_bq) * first_min, zero)

    bc1 = b[:, :, None, :] / (EPS + eb)                  # node i at edge ij
    bc2 = bc1.transpose(1, 2)                            # node j at edge ij
    m_raw = P * bc1[..., :, None] * bc2[..., None, :]
    m = m_raw / torch.clamp(m_raw.sum((-1, -2), keepdim=True), min=EPS)
    pbb = P * b[:, :, None, :, None] * b[:, None, :, None, :]
    pv = valid[:, None, :, None] & valid[None, :, None, :]
    z = torch.zeros_like(m)
    edge_en = torch.where(pv, m * torch.log((EPS + m) / (EPS + pbb)),
                          z).sum((-1, -2))
    iu = torch.triu(adj, 1)
    F = node_en.sum(-1) + torch.where(iu, edge_en,
                                      torch.zeros_like(edge_en)).sum((-1, -2))
    G = torch.where(pv & iu[..., None, None], m * pbb / (EPS + pbb), z)
    return F, G1, G


def bead_gradient(st, G, n2p):
    """dF/dE_pair[p, q] = G at the ordered residue pair of beads p, q."""
    Gs = G + G.permute(0, 2, 1, 4, 3)                     # (B, R, R, 6, 6)
    B, R = G.shape[:2]
    flat = Gs.permute(0, 1, 3, 2, 4).reshape(B, R * NROT, R * NROT)
    s = st.bead_slot.long()
    dE = G.new_zeros((B, n2p, n2p))
    dE[:, :st.n_bead, :st.n_bead] = flat[:, s[:, None], s[None, :]]
    return dE


def bp_bethe_pairs_plain(st, E1, E_pair, init=None):
    """Plain version of K2: (F, G1, dE, nb, eb, dev, iters)."""
    E2 = scatter_pairs(st, E_pair)
    valid = st.valid
    pv = valid[:, None, :, None] & valid[None, :, None, :]
    P = torch.where(pv, torch.exp(-E2), torch.zeros_like(E2))
    R = st.n_res
    eye = torch.eye(R, dtype=torch.bool, device=E1.device)
    adj = (E2 != 0).any(-1).any(-1) & ~eye
    offset, prob = node_potentials(E1, valid)
    nb, eb, dev, it = bp_solve_plain(prob, P, adj, valid, st.damping,
                                     st.max_iter, st.tol, st.chunk, init)
    F, G1, G = bethe_and_gradients(E1, offset, prob, P, adj, valid, nb, eb)
    return F, G1, bead_gradient(st, G, E_pair.shape[-1]), nb, eb, dev, it


# ---------------------------------------------------------------------------
# kernel wrapper and autograd rule
# ---------------------------------------------------------------------------

def bp_bethe_pairs_fwd(st, E1, E_pair, init=None, plain=False):
    """K2: the plain version on CPU tensors (or when asked), the CUDA
    kernel on CUDA tensors."""
    if plain or not E1.is_cuda:
        return bp_bethe_pairs_plain(st, E1, E_pair, init)
    B, R, n2p = E1.shape[0], st.n_res, st.n2p
    f32 = dict(dtype=torch.float32, device=E1.device)
    warm = init is not None
    # a cold start passes null warm-start pointers, which is how the kernel
    # tells it from a warm one
    nb0, eb0 = (t.contiguous() for t in init) if warm else (None, None)
    E1, E_pair = E1.contiguous(), E_pair.contiguous()
    checks = [(E1, (B, R, NROT)), (E_pair, (B, n2p, n2p))]
    if warm:
        checks += [(nb0, (B, R, NROT)), (eb0, (B, R, R, NROT))]
    for t, shape in checks:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"bp_bethe_pairs kernel takes float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if R > MAX_RES:
        raise ValueError(f"bp_bethe_pairs kernel supports <= {MAX_RES} "
                         f"residues, got {R}")
    F = torch.empty((B,), **f32)
    G1 = torch.empty((B, R, NROT), **f32)
    dE = torch.empty((B, n2p, n2p), **f32)
    nb = torch.empty((B, R, NROT), **f32)
    eb = torch.empty((B, R, R, NROT), **f32)
    dev = torch.empty((B,), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=E1.device)
    pbuf = torch.empty((B, R, R, NROT * NROT), **f32)     # P, then G
    ebuf = torch.empty((B, 2, R, R, NROT), **f32)         # messages
    edges = torch.empty((B, R * (R - 1)), dtype=torch.int32,
                        device=E1.device)
    kernels.launch(
        "bp_bethe_pairs", E1, E_pair, st.slot_beads, st.bead_slot, st.valid,
        nb0, eb0,
        B, R, st.n_bead, n2p, st.slot_beads.shape[1],
        st.damping, st.max_iter, st.tol, st.chunk,
        F, G1, dE, nb, eb, dev, iters, pbuf, ebuf, edges)
    return F, G1, dE, nb, eb, dev, iters


def identity_edge_gradient(st, E_pair, nb):
    """dF/dE_pair (B, n2p, n2p) on the bead pairs of distinct residues that
    K2 leaves out of its graph because all 36 of their E2 entries are 0,
    zero elsewhere.  Such an edge is the identity, whose pair belief at the
    fixed point is the product of the node beliefs, so dF/dE_pair there is
    nb_i(a) nb_j(b): what the JAX package's solvers return (its XLA path
    keeps every residue pair with a bead pair inside the cutoff as an edge,
    its kernel every residue pair).  K2 returns 0 there.  Position
    gradients do not see the difference (a pair whose energy vanishes
    identically has no position derivative); table gradients do, because
    the pair's spline window weights are not 0."""
    R = st.n_res
    eye = torch.eye(R, dtype=torch.bool, device=nb.device)
    adj = (scatter_pairs(st, E_pair) != 0).any(-1).any(-1) | eye
    s = st.bead_slot.long()
    res = s // NROT
    b = nb.reshape(nb.shape[0], R * NROT)[:, s]                # (B, n)
    out = E_pair.new_zeros(E_pair.shape)
    n = st.n_bead
    out[:, :n, :n] = torch.where(~adj[:, res[:, None], res[None, :]],
                                 b[:, :, None] * b[:, None, :],
                                 torch.zeros_like(out[:, :n, :n]))
    return out


class BPFreeEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E1, E_pair, st, init, plain, identity_edges):
        F, G1, dE, nb, eb, dev, iters = bp_bethe_pairs_fwd(st, E1, E_pair,
                                                           init, plain)
        ctx.save_for_backward(G1, dE, E_pair if identity_edges else None,
                              nb if identity_edges else None)
        ctx.st = st
        ctx.mark_non_differentiable(nb, eb, dev, iters)
        return F, nb, eb, dev, iters

    @staticmethod
    def backward(ctx, gF, *unused):
        G1, dE, E_pair, nb = ctx.saved_tensors
        if E_pair is not None:
            dE = dE + identity_edge_gradient(ctx.st, E_pair, nb)
        return gF[:, None, None] * G1, gF[:, None, None] * dE, None, None, \
            None, None


def bp_bethe_pairs(st, E1, E_pair, init=None, plain=False,
                   identity_edges=False):
    """(F, nb, eb, dev, iters); F differentiable in E1 and E_pair.  With
    `identity_edges` the E_pair cotangent also holds the identity edges'
    term (`identity_edge_gradient`), which the rotamer node asks for when
    its table requires grad (training)."""
    return BPFreeEnergy.apply(E1, E_pair, st, init, plain, identity_edges)
