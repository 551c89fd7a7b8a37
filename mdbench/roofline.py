"""The least time the pair kernels could take, from the work that the
traced evaluations' inputs need: the table of peaks and the functions that
count operations and bytes.

Peaks are NVIDIA's published figures for one H100 SXM at its full 700 W:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores, the
type every kernel here computes in.  A bound is max(bytes / 3.35 TB/s,
float32 operations / 67 TFLOP/s).

Bytes: each input read once and each output written once, in float32,
whatever a kernel reads again or keeps between its forward and backward.
Operations: only the live pairs' (inside the static mask and the cutoff),
at float32 operations a pair counted from the kernels' sources (an FMA
counts 2; chip_smoke.py's constants): a spline pair's value with its
derivatives 110 and their use in the backward 45, an environment pair's 46
and 70 (the fused block, K1); a coverage pair's value and weight 82 and
its backward 155 (K4); a grid pair's value 80 and its backward 150 (K5).
The live pairs are counted here with the reference's own geometry
(`reference/forcefield.py`), at the positions the run hands over.
"""

from __future__ import annotations

import torch

from .reference.forcefield import exclusion, pair_cutoff

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4


def bound_s(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def _nodes(ff, kind):
    return [n for n in ff.nodes if n["type"] == kind]


def _live(x1, x2, mask, cut):
    d2 = ((x2[:, None, :, :] - x1[:, :, None, :]) ** 2).sum(-1)
    return int((mask & (d2 < cut * cut)).sum())


def live_pairs(ff, pos, block=64):
    """Live pairs summed over the replicas of pos (B, n_atom, 3): of each
    coverage node (by name), of the environment coverage ("env") and of
    the rotamer bead grid ("grid")."""
    covs, envs = _nodes(ff, "hbond_coverage"), _nodes(ff, "environment_coverage")
    (rot,) = _nodes(ff, "rotamer")
    need = [a for n in covs + envs + [rot] for a in n["args"]]
    counts = {n["name"]: 0 for n in covs}
    counts.update(env=0, grid=0)
    for i in range(0, pos.shape[0], block):
        with torch.no_grad():
            out = ff.outputs(pos[i:i + block], needed=need)
        for n in covs:
            c, p = ff.consts[n["name"]], ff.params[n["name"]]
            counts[n["name"]] += _live(
                out[n["args"][0]][:, c["index1"], :3],
                out[n["args"][1]][:, c["index2"], :3],
                exclusion(c["id1"], c["id2"]),
                pair_cutoff(p["interaction_param"].shape[-1]))
        for n in envs:
            c, p = ff.consts[n["name"]], ff.params[n["name"]]
            prm = p["interaction_param"][c["type1"][:, None],
                                        c["type2"][None, :]]
            counts["env"] += _live(
                out[n["args"][0]][:, c["index1"], :3],
                out[n["args"][1]][:, c["index2"], :3],
                exclusion(c["id1"], c["id2"]), prm[..., 0] + 1 / prm[..., 1])
        c, p = ff.consts[rot["name"]], ff.params[rot["name"]]
        beads = out[rot["args"][0]][:, c["index"], :3]
        res = c["res"]
        upper = torch.triu(torch.ones(len(res), len(res), dtype=torch.bool,
                                      device=res.device), 1)
        counts["grid"] += _live(beads, beads,
                                upper & (res[:, None] != res[None, :]),
                                pair_cutoff(p["interaction_param"].shape[-1]))
    return counts


def _sizes(ff):
    covs, envs = _nodes(ff, "hbond_coverage"), _nodes(ff, "environment_coverage")
    (rot,) = _nodes(ff, "rotamer")
    rows = {n["name"]: len(ff.consts[n["name"]]["index1"]) for n in covs}
    n_env = sum(len(ff.consts[n["name"]]["index1"]) for n in envs)
    n_bead = len(ff.consts[rot["name"]]["index"])
    tables = sum(ff.params[n["name"]]["interaction_param"].numel()
                 for n in covs + envs + [rot]) * F32
    return rows, n_env, n_bead, tables


def fused_pair_s(ff, counts, B):
    """Bound of one evaluation's fused pair block, forward and backward
    (K1): both coverages, the environment coverage and the rotamer grid
    in one pass over the bead columns."""
    rows, n_env, n2, tables = _sizes(ff)
    n1 = sum(rows.values()) + n_env + n2
    live = sum(counts[n] for n in rows) + counts["grid"]
    inputs = F32 * B * 7 * (n1 + n2) + tables   # sites, row and column weights
    outputs = F32 * B * (2 * n2 + n_env + n2 * n2)  # coverages, env, grid
    fwd = bound_s(inputs + outputs, 110 * live + 46 * counts["env"])
    # the backward reads the inputs, the coverages' and env's cotangents and
    # the grid's at the live pairs, and writes the inputs' cotangents
    bwd = bound_s(2 * inputs - tables + F32 * B * (2 * n2 + n_env)
                  + F32 * counts["grid"],
                  45 * live + 70 * counts["env"])
    return fwd + bwd


def quadspline_s(ff, counts, B):
    """Bound of one evaluation's unfused pair splines, forward and
    backward: K4 for each coverage node and K5 for the rotamer grid."""
    rows, _, n2, _ = _sizes(ff)
    total = 0.0
    for name, n1 in rows.items():
        table = ff.params[name]["interaction_param"].numel() * F32
        sites = F32 * B * (7 * n1 + 6 * n2) + table
        total += bound_s(sites + F32 * B * n2, 82 * counts[name])
        total += bound_s(sites + F32 * B * (n2 + 7 * n1 + 6 * n2),
                         155 * counts[name])
    (rot,) = _nodes(ff, "rotamer")
    table = ff.params[rot["name"]]["interaction_param"].numel() * F32
    beads = F32 * B * 6 * n2 + table
    total += bound_s(beads + F32 * B * n2 * n2, 80 * counts["grid"])
    total += bound_s(beads + F32 * B * 6 * n2 + F32 * counts["grid"],
                     150 * counts["grid"])
    return total


def traced_bound(traced, per_eval):
    """Summed bound of the traced evaluations: each traced chunk's live
    pairs are the mean of those at its start and at its end."""
    ff, B = traced.extra["ff"], traced.extra["replicas"]
    total = 0.0
    for start, end, evals in traced.extra["chunks"]:
        a, b = live_pairs(ff, start), live_pairs(ff, end)
        mean = {k: 0.5 * (a[k] + b[k]) for k in a}
        total += evals * per_eval(ff, mean, B)
    return total
