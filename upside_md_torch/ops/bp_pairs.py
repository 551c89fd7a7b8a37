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

On the card the C entry point runs a grid-wide prologue (adjacency bits,
the compact list of adjacent directed edges with each edge's reverse and
factor index, the factor blocks), the per-replica solve on the compact
edges, and a grid-wide epilogue that spreads the compact gradient and
messages into the dense outputs (csrc/bp_common.cuh).  Each of those
passes has its plain version here (`compact_edges`, `compact_factors`,
`compact_messages`, `dense_messages`, `dense_pair_gradient`), which the
CPU tests and the comparison on the card use; the plain solve itself
stays dense.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels

NROT = 6
EPS = 1e-10
MAX_RES = 128       # residues one BP kernel block holds (bp_common.cuh)
NPAIR = NROT * NROT
ADJ_WORDS = MAX_RES // 32
N_FSUM = 17         # F's node term and the edge pass's 16 blocks, a replica
N_COUNTS = 4        # per-replica integers of the scratch's `counts`
# Dynamic shared memory of each solve block (bp_common.cuh launches with
# the same numbers): what a block may ask for (232,448 bytes) less the
# solve's static node arrays.  The solve takes 116-128 registers a thread
# at 512 threads, so one block fills an SM's registers whatever shared
# memory it leaves free.
SOLVE_STATIC_BYTES = 13568      # >= sizeof(BPNodes), bp_common.cuh
SOLVE_SMEM_BYTES = 232448 - SOLVE_STATIC_BYTES
LAYOUTS = ("messages and factors in shared memory",
           "messages in shared memory, factors through L2",
           "messages and factors in global scratch")


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


# host syncs of the plain solve: one a chunk of sweeps, where it reads
# whether any replica is still active (XLA's while_loop keeps that test on
# the device); nothing else changes the count
HOST_SYNCS = {"bp_solve_plain": 0}


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


def _any_active(active):
    """Whether a replica is still solving: a host sync, counted."""
    HOST_SYNCS["bp_solve_plain"] += 1
    return bool(active.any())


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
    while _any_active(active):
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
# plain versions of the kernel's compact-edge passes
# ---------------------------------------------------------------------------

def compact_edges(adj):
    """The adjacent directed edges of adj (B, R, R) bool (symmetric; the
    diagonal is ignored) in row-major (i, j) order, which is CSR by
    residue.  Returns (count (B,), edges, reverse, pair_index), the last
    three (B, R (R - 1)) int32, -1 beyond each replica's count:
    edges[e] = i * R + j, reverse[e] the index of the edge (j, i), and
    pair_index[e] the rank of the undirected pair (min, max) among the
    adjacent pairs i < j in row-major order (the factor block both
    directions share in K2)."""
    B, R = adj.shape[:2]
    adj = adj & ~torch.eye(R, dtype=torch.bool, device=adj.device)
    cap = R * (R - 1)
    flat = adj.reshape(B, R * R)
    count = flat.sum(-1).to(torch.int32)
    order = torch.argsort((~flat).to(torch.uint8), dim=-1, stable=True)
    edges = order[:, :cap]
    live = torch.arange(cap, device=adj.device)[None, :] < count[:, None]
    rank = flat.long().cumsum(-1) - 1                 # edge index by (i, j)
    urank = torch.triu(adj, 1).reshape(B, R * R).long().cumsum(-1) - 1
    i, j = edges // R, edges % R
    reverse = rank.gather(1, j * R + i)
    pair = urank.gather(1, torch.minimum(i, j) * R + torch.maximum(i, j))
    none = torch.full_like(edges, -1)
    return count, *(torch.where(live, t, none).to(torch.int32)
                    for t in (edges, reverse, pair))


def compact_factors(P, edges, pair_index=None):
    """Factor blocks (B, n_blocks, 36) of P (B, R, R, 6, 6), 0 where unused.
    With `pair_index` one block per undirected pair, P[i, j] of i < j, in
    (B, R (R - 1) / 2, 36) (K2); without, one per directed edge (K6)."""
    B, R = P.shape[:2]
    live = edges >= 0
    blocks = P.reshape(B, R * R, NPAIR).gather(
        1, edges.clamp(min=0).long()[..., None].expand(-1, -1, NPAIR))
    blocks = torch.where(live[..., None], blocks, torch.zeros_like(blocks))
    if pair_index is None:
        return blocks
    upper = live & (edges // R < edges % R)
    out = P.new_zeros((B, R * (R - 1) // 2 + 1, NPAIR))
    slot = torch.where(upper, pair_index, torch.full_like(pair_index, -1))
    out.scatter_(1, (slot.long() % out.shape[1])[..., None]
                 .expand(-1, -1, NPAIR), blocks)
    return out[:, :-1]


def compact_messages(eb, edges):
    """Dense messages (B, R, R, 6) -> (B, R (R - 1), 6) on the compact
    edges, 0 beyond each replica's count."""
    B, R = eb.shape[:2]
    m = eb.reshape(B, R * R, NROT).gather(
        1, edges.clamp(min=0).long()[..., None].expand(-1, -1, NROT))
    return torch.where((edges >= 0)[..., None], m, torch.zeros_like(m))


def dense_messages(msg, edges, R):
    """Compact messages (B, R (R - 1), 6) -> dense (B, R, R, 6), identity
    (1.0) where there is no edge."""
    B = msg.shape[0]
    out = msg.new_ones((B, R * R + 1, NROT))
    slot = torch.where(edges >= 0, edges, torch.full_like(edges, R * R))
    out.scatter_(1, slot.long()[..., None].expand(-1, -1, NROT), msg)
    return out[:, :-1].reshape(B, R, R, NROT)


def dense_pair_gradient(G, edges, pair_index, R):
    """Compact gradient blocks (B, n_blocks, 36) -> dense (B, R, R, 6, 6),
    nonzero on adjacent i < j only.  With `pair_index` the blocks are per
    undirected pair (K2), without per directed edge (K6)."""
    B = G.shape[0]
    upper = (edges >= 0) & (edges // R < edges % R)
    block = (pair_index if pair_index is not None else torch.arange(
        edges.shape[1], device=edges.device)[None].expand(B, -1))
    vals = G.gather(1, block.clamp(min=0).long()[..., None]
                    .expand(-1, -1, NPAIR))
    out = G.new_zeros((B, R * R + 1, NPAIR))
    slot = torch.where(upper, edges, torch.full_like(edges, R * R))
    out.scatter_(1, slot.long()[..., None].expand(-1, -1, NPAIR), vals)
    return out[:, :-1].reshape(B, R, R, NROT, NROT)


def solve_layout(n_edges, n_blocks, smem_bytes=SOLVE_SMEM_BYTES):
    """The layout (index into LAYOUTS) the solve block of a replica with
    `n_edges` adjacent directed edges and `n_blocks` factor blocks (K2: one
    per undirected pair; K6: one per directed edge) takes with
    `smem_bytes` of dynamic shared memory: the rule of `bp_solve_kernel`,
    a rule of size.  With the kernel's budget K2 holds up to 1,710 edges
    in layout 0 and K6 1,094; both hold up to 3,908 in layout 1."""
    info = (8 * n_edges + 15) // 16 * 16
    messages = info + 2 * n_edges * NROT * 4
    if messages + n_blocks * NPAIR * 4 <= smem_bytes:
        return 0
    return 1 if messages <= smem_bytes else 2


class BPScratch:
    """Global scratch of one K2 or K6 call: one int32 and one float32
    buffer, cut into arrays with a leading replica axis as
    `make_scratch` (csrc/bp_common.cuh) cuts them.  After a call:
    `counts[:, 0]` adjacent directed edges, `[:, 1]` undirected pairs,
    `[:, 2]` the layout the solve took; `edges`, `reverse`, `pair_index`
    as `compact_edges` gives them (unset beyond the count; K6's factor
    index is the edge's own); `factors` the gradient blocks;
    `messages[:, 0]` the final compact messages."""

    def __init__(self, B, R, shared_factors, device):
        self.B, self.R, self.cap = B, R, R * (R - 1)
        self.f_cap = self.cap // 2 if shared_factors else self.cap
        sizes = (("adjw", R * ADJ_WORDS), ("cand", R * ADJ_WORDS),
                 ("counts", N_COUNTS), ("row_start", R + 1),
                 ("edges", self.cap), ("reverse", self.cap),
                 ("pair_index", self.cap), ("upair", self.cap // 2))
        self._ints, n = {}, 0
        for name, per in sizes:
            self._ints[name] = (n, per)
            n += B * per
        self.ibuf = torch.empty(n, dtype=torch.int32, device=device)
        self.fbuf = torch.empty(
            B * (self.f_cap * NPAIR + 2 * self.cap * NROT + N_FSUM),
            dtype=torch.float32, device=device)

    def __getattr__(self, name):
        ints = self.__dict__.get("_ints", {})
        if name not in ints:
            raise AttributeError(name)
        start, per = ints[name]
        return self.ibuf[start:start + self.B * per].view(self.B, per)

    @property
    def factors(self):
        return self.fbuf[:self.B * self.f_cap * NPAIR].view(
            self.B, self.f_cap, NPAIR)

    @property
    def messages(self):
        start = self.B * self.f_cap * NPAIR
        return self.fbuf[start:start + self.B * 2 * self.cap * NROT].view(
            self.B, 2, self.cap, NROT)


def small_outputs(B, R, device):
    """F (B,), dev (B,), G1 and nb (B, R, 6) cut from one allocation, and
    the sweep counts (B,) int32."""
    n = B * R * NROT
    buf = torch.empty(2 * B + 2 * n, dtype=torch.float32, device=device)
    return (buf[:B], buf[B:2 * B], buf[2 * B:2 * B + n].view(B, R, NROT),
            buf[2 * B + n:].view(B, R, NROT),
            torch.empty(B, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# kernel wrapper and autograd rule
# ---------------------------------------------------------------------------

def bp_bethe_pairs_fwd(st, E1, E_pair, init=None, plain=False):
    """K2: the plain version on CPU tensors (or when asked), the CUDA
    kernel on CUDA tensors."""
    if plain or not E1.is_cuda:
        return bp_bethe_pairs_plain(st, E1, E_pair, init)
    return bp_pairs_kernel(st, E1, E_pair, init)[0]


def bp_pairs_kernel(st, E1, E_pair, init=None):
    """One call of K2's C entry point on CUDA tensors: ((F, G1, dE, nb, eb,
    dev, iters), scratch).  The scratch holds the compact edge list and
    the layout each replica's solve took, which the comparisons on the
    card read."""
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
        if not t.is_cuda or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"bp_bethe_pairs kernel takes CUDA float32 "
                             f"{shape}, got {t.device} {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 2 <= R <= MAX_RES:
        raise ValueError(f"bp_bethe_pairs kernel supports 2 to {MAX_RES} "
                         f"residues, got {R}")
    scratch = BPScratch(B, R, True, E1.device)
    F, dev, G1, nb, iters = small_outputs(B, R, E1.device)
    dE = torch.empty((B, n2p, n2p), **f32)
    eb = torch.empty((B, R, R, NROT), **f32)
    kernels.launch(
        "bp_bethe_pairs", E1, E_pair, st.slot_beads, st.bead_slot, st.valid,
        nb0, eb0,
        B, R, st.n_bead, n2p, st.slot_beads.shape[1],
        st.damping, st.max_iter, st.tol, st.chunk, F, G1, dE, nb, eb, dev, iters, scratch.ibuf, scratch.fbuf)
    return (F, G1, dE, nb, eb, dev, iters), scratch


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
