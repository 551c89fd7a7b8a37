"""Side-chain rotamer free energy by loopy BP (port of the main path of
upside_md_tpu/nodes/rotamer.py; reference src/rotamer.cpp).

Every residue is padded to 6 rotamer slots with a validity mask.  The
1-body energies of each bead are summed over the node's energy inputs and
scattered to their slots.  The solver path follows the JAX package's
dispatch (rotamer.py:418-461):

* up to 512 beads and 128 residues: the bead-pair grid from the fused pair
  block (or, unfused, from K5) goes to K2 (`ops/bp_pairs.py`), which
  scatters it to rotamer slots itself;
* more than 512 beads and up to 128 residues
  (`assemble_rotamer_energies`, rotamer.py:239-268): the K5 grid (upper
  triangle, different residues) is scattered by index to the residue-pair
  energies E2, the adjacency is the in-cutoff bead-pair mask lifted to
  residues, symmetric with no diagonal, and K6 (`ops/bp_planes.py`) solves
  BP on the 36 (a, b) planes of E2;
* more than 128 residues (the XLA `_bp_solve` branch, rotamer.py:463-483):
  the planes path with the port of `_bp_solve` + `bethe_free_energy` in
  K6's place, on the card too (`bp_planes.planes_solver` chooses by R
  alone, as `_use_pallas_bp` does).

Above NEIGHBOR_LIST_THRESHOLD beads the grid is not K5's dense one but
the fixed-K neighbour list's (rotamer.py:221-228): each bead's
min(n_bead, NEIGHBOR_K) nearest in-cutoff partners, scattered back onto
the grid, and the residue adjacency comes from the partners the list
kept.  Both thresholds are read at call time.

Both solvers return the Bethe free energy with its envelope gradients.

The warm-start cache carries the last evaluation's beliefs and messages
through the MD loop.  Node beliefs are extrapolated in log space from the
last two evaluations (m = m1 (m1/m0)^alpha, alpha = 1, clipped): the
default of the JAX package (rotamer.py:294-351, 393-416).  BP converges to
the same fixed point from any positive start, so the cache changes sweep
counts only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bp_pairs import (EPS, MAX_RES, NROT, bp_bethe_pairs,
                            bp_solve_plain, make_statics, node_potentials,
                            scatter_pairs)
from ..ops.bp_planes import bp_bethe_planes
from ..ops.pairs import (quadspline_coverage_nl, quadspline_family,
                         scatter_rows)
from ..ops.quadspline import PairSpline, live_pairs, quadspline
from .base import flat_param, per_slot, register_node, to_tensor

EXTRAP_ALPHA = 1.0
# above this many beads the JAX package leaves the bead-space BP kernel for
# the residue-plane one (rotamer.py:46)
PAIRS_KERNEL_MAX_BEADS = 512
# above this many beads the pair grid comes from a fixed-K neighbour list
# of min(n_bead, NEIGHBOR_K) partners a bead (rotamer.py:39-40)
NEIGHBOR_LIST_THRESHOLD = 1024
NEIGHBOR_K = 128


def _prepare(c, device, dtype):
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    res = np.asarray(c["res"])
    n = len(res)
    n2p = -(-n // 128) * 128
    out["bp"] = make_statics(res, c["rot"], c["valid"], n2p, c["damping"],
                             c["max_iter"], c["tol"],
                             c.get("iteration_chunk_size", 2), device)
    tri = np.arange(n)[:, None] < np.arange(n)[None, :]
    out["spline"] = PairSpline(c["type"], c["type"],
                               tri & (res[:, None] != res[None, :]), device)
    if _takes_planes(out["bp"]):
        out["res_onehot"] = torch.nn.functional.one_hot(
            out["res"], out["bp"].n_res).to(dtype)
    return out


def _takes_planes(st):
    """Whether BP runs on residue planes (K6 or the R > 128 branch) rather
    than on the bead grid (K2)."""
    return st.n_bead > PAIRS_KERNEL_MAX_BEADS or st.n_res > MAX_RES


def assemble_one_body(c, inputs):
    """1-body energy table E1 (B, R, 6): each bead's energies (the sum of
    the node's energy inputs, each (B, n, 1)) summed into its slot."""
    idx = c["index"]
    e_bead = inputs[1][:, idx, 0]
    for pn in inputs[2:]:
        e_bead = e_bead + pn[:, idx, 0]
    st = c["bp"]
    e_pad = torch.nn.functional.pad(e_bead, (0, st.n2p + 1 - st.n_bead))
    E1 = e_pad[:, st.slot_beads].sum(-1)
    return E1.reshape(E1.shape[0], st.n_res, NROT)


def assemble_pair_grid(c, p, beads, plain=False, stacked=False):
    """Unfused bead-pair grid (B, n, n): upper triangle, different
    residues, within the family's cutoff (rotamer.py:208-236), and the
    pairs the neighbour list kept (None on the dense path).  Up to
    NEIGHBOR_LIST_THRESHOLD beads K5 computes the grid; above, the
    neighbour list.  A table `stacked` over replicas runs once a slot."""
    n = beads.shape[1]

    def dense(table, b):
        return quadspline(c["spline"], table, b, b, plain)

    def neighbours(table, b):
        ka, k, dx = quadspline_family(table.shape[-1])
        x, d = b[..., 0:3], b[..., 3:6]
        cov, idx, mask = quadspline_coverage_nl(
            table, c["type"], c["type"], x, d, x, d, ka, k, 1.0 / dx,
            c["spline"].mask.bool(), min(n, NEIGHBOR_K))
        return (scatter_rows(cov, idx, mask, n),
                scatter_rows(mask.to(cov.dtype), idx, mask, n) > 0)

    grid = neighbours if n > NEIGHBOR_LIST_THRESHOLD else dense
    table = p["interaction_param"]
    out = per_slot(grid, table, beads) if stacked else grid(table, beads)
    return out if isinstance(out, tuple) else (out, None)


def residue_adjacency(c, live):
    """(B, R, R) bool from a (B, n, n) bead-pair mask: residues with a
    pair in it, symmetric, no diagonal (rotamer.py:230-232, 266-267)."""
    oh = c["res_onehot"] if "res_onehot" in c else \
        torch.nn.functional.one_hot(c["res"], c["bp"].n_res).to(
            torch.float32)
    counts = oh.T @ live.to(oh.dtype) @ oh           # exact small integers
    adj = (counts + counts.transpose(1, 2)) > 0
    return adj & ~torch.eye(adj.shape[-1], dtype=torch.bool,
                            device=adj.device)


def pair_adjacency(c, p, beads):
    """`residue_adjacency` of the rotamer mask's bead pairs inside the
    cutoff: the dense path's pair mask."""
    ps = c["spline"]
    table = p["interaction_param"]
    # the cutoff depends on the table's family (its width) only
    return residue_adjacency(c, live_pairs(
        ps, ps.table(table[0] if table.ndim > 3 else table), beads, beads))


def residue_planes(c, p, beads, grid, kept=None):
    """The planes path's BP inputs from the bead grid: E2 as 36 (a*6+b)
    planes (B, 36, R, R), scattered by index, and the adjacency, from the
    pairs the neighbour list `kept` where it made the grid (an overflowing
    row's dropped partners are no edge, as in the reference's pair mask),
    else from the pairs inside the cutoff."""
    st = c["bp"]
    E2 = scatter_pairs(st, grid)
    planes = E2.permute(0, 3, 4, 1, 2).reshape(E2.shape[0], NROT * NROT,
                                               st.n_res, st.n_res)
    adj = pair_adjacency(c, p, beads) if kept is None \
        else residue_adjacency(c, kept)
    return planes, adj


def extrapolate_beliefs(nb1, nb0, alpha=EXTRAP_ALPHA):
    """Node-belief warm start from the last two solutions, max-normalised."""
    r = torch.clamp(nb1 / torch.clamp(nb0, min=1e-12), 0.1, 10.0)
    m = torch.where(nb1 > 0, torch.clamp(nb1 * r ** alpha, min=1e-8),
                    torch.zeros_like(nb1))
    return m / torch.clamp(m.max(-1, keepdim=True).values, min=EPS)


def _rotamer(c, p, inputs, ctx):
    name = ctx.node_name
    st = c["bp"]
    E1 = assemble_one_body(c, inputs)
    raw = ctx.cache.get(name)
    init = None
    if raw is not None:
        init = (extrapolate_beliefs(raw["nb"], raw["prev_nb"]), raw["eb"])
    E_pair = ctx.fused.get(name + ":E_pair")
    stacked = "interaction_param" in ctx.stacked
    beads = inputs[0][:, c["index"], :6]
    if E_pair is not None or not _takes_planes(st):
        if E_pair is None:
            pad = st.n2p - st.n_bead
            E_pair = torch.nn.functional.pad(
                assemble_pair_grid(c, p, beads, ctx.plain, stacked)[0],
                (0, pad, 0, pad))
        F, nb, eb, dev, iters = bp_bethe_pairs(
            st, E1, E_pair, init, ctx.plain,
            identity_edges=p["interaction_param"].requires_grad)
    else:
        E2planes, adj = residue_planes(
            c, p, beads,
            *assemble_pair_grid(c, p, beads, ctx.plain, stacked))
        F, nb, eb, dev, iters = bp_bethe_planes(st, E1, E2planes, adj, init,
                                                ctx.plain)
    ctx.cache_out[name] = {
        "nb": nb, "eb": eb, "prev_nb": nb if raw is None else raw["nb"],
        "dev": dev, "iters": iters}
    return F


def _init_cache(c, n_replica, dtype):
    """Uniform beliefs over valid slots and identity messages, the JAX
    package's initial cache (rotamer.py:486-513)."""
    st = c["bp"]
    nb0 = st.valid.to(dtype).expand(n_replica, -1, -1).clone()
    eb0 = torch.ones((n_replica, st.n_res, st.n_res, NROT), dtype=dtype,
                     device=nb0.device)
    zeros = torch.zeros(n_replica, dtype=dtype, device=nb0.device)
    return {"nb": nb0, "eb": eb0, "prev_nb": nb0, "dev": zeros,
            "iters": zeros.to(torch.int32)}


def decode_bead_ids(packed_ids, n_bit_rotamer=4):
    """Packed bead id -> (rot, n_rot, residue) bit fields, int32
    (rotamer.py:49-57; reference rotamer.cpp:565-577)."""
    packed_ids = np.asarray(packed_ids, np.int64)
    sel = (1 << n_bit_rotamer) - 1
    rot = packed_ids & sel
    n_rot = (packed_ids >> n_bit_rotamer) & sel
    res = packed_ids >> (2 * n_bit_rotamer)
    return rot.astype(np.int32), n_rot.astype(np.int32), res.astype(np.int32)


def make_rotamer_consts(packed_ids, index, types, damping, max_iter, tol):
    """The node's consts from its packed bead ids (rotamer.py:533-563),
    without the one-hot tables the port rebuilds from `res` and `rot`.
    The packed residue field counts within each rotamer-count class
    (upside_config.py:973-983), so a BP residue is an (n_rot, count)
    pair."""
    rot, n_rot, res = decode_bead_ids(packed_ids)
    key = res.astype(np.int64) * (1 << 4) + n_rot
    uniq, res_c = np.unique(key, return_inverse=True)
    res_c = res_c.astype(np.int32)
    n_res = len(uniq)
    n_rot_per_res = np.zeros(n_res, np.int32)
    n_rot_per_res[res_c] = n_rot
    valid = np.arange(NROT)[None, :] < n_rot_per_res[:, None]
    return {"index": np.asarray(index, np.int32),
            "type": np.asarray(types, np.int32),
            "rot": rot, "res": res_c, "n_res": n_res,
            "n_rot_per_res": n_rot_per_res, "valid": valid,
            "damping": float(damping), "max_iter": int(max_iter),
            "tol": float(tol)}


_get_table, _set_table = flat_param("interaction_param")
rotamer = register_node("rotamer", True, _rotamer, prepare=_prepare,
                        init_cache=_init_cache, get_param=_get_table,
                        set_param=_set_table)


# -- diagnostics (rotamer.py:566-627 of the JAX package) ----------------------

def rotamer_problem(c, p, inputs, plain=False):
    """The residue-level BP problem of `assemble_rotamer_energies`
    (rotamer.py:239-268): (E1, offset, prob, E2 (B, R, R, 6, 6) symmetric,
    adjacency (B, R, R)), from the unfused pair grid whatever path the
    node itself takes."""
    st = c["bp"]
    E1 = assemble_one_body(c, inputs)
    offset, prob = node_potentials(E1, st.valid)
    beads = inputs[0][:, c["index"], :6]
    grid, kept = assemble_pair_grid(c, p, beads, plain)
    adj = pair_adjacency(c, p, beads) if kept is None \
        else residue_adjacency(c, kept)
    return E1, offset, prob, scatter_pairs(st, grid), adj


def _solve(c, prob, P, adj):
    """The cold `_bp_solve` of the diagnostics, 2 sweeps a chunk."""
    st = c["bp"]
    return bp_solve_plain(prob, P, adj, st.valid, st.damping, st.max_iter,
                          st.tol, 2)[:2]


def _bead_values(c, nb):
    """Per-bead values (B, n_bead) of per-slot ones (B, R, 6)."""
    return nb.reshape(nb.shape[0], -1)[:, c["res"] * NROT + c["rot"]]


def rotamer_diagnostics(consts, params, inputs, plain=False):
    """The reference's get_value_by_name channels (rotamer.cpp:675-773):
    per-residue free energies, 1-body energies, node and edge energies
    and marginals, each with the replica axis first."""
    valid = consts["bp"].valid
    E1, offset, prob, E2, adj = rotamer_problem(consts, params, inputs,
                                                plain)
    P = torch.exp(-E2)
    nb, eb = _solve(consts, prob, P, adj)
    zero = torch.zeros_like(nb)
    node_en = offset + torch.where(
        valid, nb * torch.log((EPS + nb) / (EPS + prob)), zero).sum(-1)
    bc1 = nb[:, :, None, :] / (EPS + eb)
    bc2 = bc1.transpose(1, 2)
    m_raw = P * bc1[..., :, None] * bc2[..., None, :]
    m = m_raw / torch.clamp(m_raw.sum((-1, -2), keepdim=True), min=EPS)
    pbb = P * nb[:, :, None, :, None] * nb[:, None, :, None, :]
    pv = valid[:, None, :, None] & valid[None, :, None, :]
    edge_en = torch.where(pv, m * torch.log((EPS + m) / (EPS + pbb)),
                          torch.zeros_like(m)).sum((-1, -2))
    edge_en = torch.where(adj, edge_en, torch.zeros_like(edge_en))
    adj4 = adj[..., None, None]
    return {
        "node_marginal": nb,
        "edge_marginal": torch.where(adj4, m, torch.zeros_like(m)),
        "node_energy": torch.where(valid, E1, torch.full_like(E1, 1e5)),
        "edge_energy": -torch.log(torch.where(adj4, P, torch.ones_like(P))),
        "node_free_energy": node_en,
        "edge_free_energy": edge_en,
        "rotamer_free_energy": node_en + 0.5 * edge_en.sum(-1),
        "bead_marginal": _bead_values(consts, nb),
        "adjacency": adj,
    }


def rotamer_1body_energy(consts, params, inputs, prob_node_index,
                         plain=False):
    """Marginal-weighted 1-body energy (B, R) of one energy input
    (rotamer.cpp:904-926)."""
    w = rotamer_diagnostics(consts, params, inputs, plain)["bead_marginal"]
    e_bead = inputs[1 + prob_node_index][:, consts["index"], 0]
    out = e_bead.new_zeros((e_bead.shape[0], consts["bp"].n_res))
    return out.index_add(1, consts["res"], w * e_bead)


def rotamer_marginals(consts, params, inputs, plain=False):
    """Posterior node marginals (B, R, 6) and per bead (B, n_bead)."""
    _, _, prob, E2, adj = rotamer_problem(consts, params, inputs, plain)
    nb, _ = _solve(consts, prob, torch.exp(-E2), adj)
    return nb, _bead_values(consts, nb)
