"""Side-chain rotamer free energy by loopy BP (port of the main path of
upside_md_tpu/nodes/rotamer.py; reference src/rotamer.cpp).

Every residue is padded to 6 rotamer slots with a validity mask.  The
1-body energies of each bead are summed over the node's energy inputs and
scattered to their slots; the bead-pair grid comes from the fused pair
block (or, unfused and on the CPU only, from the plain pair spline).
`ops/bp_pairs.py` solves BP and returns the Bethe free energy with its
envelope gradients.

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

from ..ops.bp_pairs import EPS, NROT, bp_bethe_pairs, make_statics
from ..ops.pairs import pair_coverage, quadspline_family
from .base import register_node, to_tensor

EXTRAP_ALPHA = 1.0


def _prepare(c, device, dtype):
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    res = np.asarray(c["res"])
    n2p = -(-len(res) // 128) * 128
    out["bp"] = make_statics(res, c["rot"], c["valid"], n2p, c["damping"],
                             c["max_iter"], c["tol"],
                             c.get("iteration_chunk_size", 2), device)
    return out


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


def assemble_pair_grid(c, p, beads):
    """Unfused bead-pair grid (B, n2p, n2p), plain only: upper triangle,
    different residues, within the family's cutoff."""
    st = c["bp"]
    table = p["interaction_param"]
    ka, k, dx = quadspline_family(table.shape[-1])
    res = c["res"]
    n = res.shape[0]
    tri = torch.arange(n, device=res.device)
    mask = (tri[:, None] < tri[None, :]) & (res[:, None] != res[None, :])
    grid = pair_coverage(table, c["type"], c["type"], beads, beads, mask,
                         ka, k, dx)
    return torch.nn.functional.pad(grid, (0, st.n2p - n, 0, st.n2p - n))


def extrapolate_beliefs(nb1, nb0, alpha=EXTRAP_ALPHA):
    """Node-belief warm start from the last two solutions, max-normalised."""
    r = torch.clamp(nb1 / torch.clamp(nb0, min=1e-12), 0.1, 10.0)
    m = torch.where(nb1 > 0, torch.clamp(nb1 * r ** alpha, min=1e-8),
                    torch.zeros_like(nb1))
    return m / torch.clamp(m.max(-1, keepdim=True).values, min=EPS)


def _rotamer(c, p, inputs, ctx):
    name = ctx.node_name
    E1 = assemble_one_body(c, inputs)
    E_pair = ctx.fused.get(name + ":E_pair")
    if E_pair is None:
        E_pair = assemble_pair_grid(c, p, inputs[0][:, c["index"], :6])
    raw = ctx.cache.get(name)
    init = None
    if raw is not None:
        init = (extrapolate_beliefs(raw["nb"], raw["prev_nb"]), raw["eb"])
    F, nb, eb, dev, iters = bp_bethe_pairs(c["bp"], E1, E_pair, init,
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


rotamer = register_node("rotamer", True, _rotamer, prepare=_prepare,
                        init_cache=_init_cache)
