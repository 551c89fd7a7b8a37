"""Cross-node fusion plan (port of upside_md_tpu/nodes/fusion.py).

The hbond coverage, the hydrophobe coverage, the environment coverage and
the rotamer bead-pair grid all stream the same sidechain-bead columns.
The plan finds that group once per System; when the evaluation reaches
the first coverage member, `compute` runs the fused pair block
(ops/fused_pair.py) and the member nodes read their results from
`ctx.fused`.  The environment coverage joins as the env band where it
fits; otherwise (no such node, as in a system built without an
environment library) the block runs without it and the env node, if any,
runs its own formulation.  The block runs whenever the plan exists, on
either device: its plain version on the CPU, its kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..ops.bp_pairs import MAX_RES
from ..ops.fused_pair import FusedPrep, fused_pair_block, make_prep
from ..ops.pairs import quadspline_family

MAX_BEADS = 512      # bead columns
MAX_ENV_ROWS = 128   # CB probes of the env band (fusion.py:275)


class PairFusionPlan:
    """The fused group: both coverage nodes and the rotamer pair grid, and
    the environment coverage as the env band when it fuses (env, env_cb,
    env_wp None otherwise)."""

    def __init__(self, cov1, cov2, rot, env=None, env_cb=None, env_wp=None):
        self.cov1, self.cov2, self.rot = cov1, cov2, rot
        self.env, self.env_cb, self.env_wp = env, env_cb, env_wp
        self.trigger_name = cov1.name
        self.table_nodes = [s.name for s in (cov1, cov2, rot, env)
                            if s is not None]

    def tables(self, params):
        """(tab1, tab2, tab3, tab4 or None): the parameter tensors the
        block reads."""
        return tuple(params[n]["interaction_param"] for n in self.table_nodes
                     ) + (None,) * (4 - len(self.table_nodes))

    def prepare(self, params, device, dtype=torch.float32) -> FusedPrep:
        """Parameter-only operands: per-(row type, column type) cubic
        coefficients, row/column types, the concatenated mask and the env
        sigmoid table.  Built once per advance (sim.py memo), and again
        whenever a table tensor changes."""
        cov1, cov2, rot, env = self.cov1, self.cov2, self.rot, self.env
        res = np.asarray(rot.consts["res"])
        n2 = len(res)
        tri = np.arange(n2)[:, None] < np.arange(n2)[None, :]

        def excl(spec):
            d = (np.asarray(spec.consts["id1"])[:, None]
                 - np.asarray(spec.consts["id2"])[None, :])
            return np.abs(d) > 2

        with tracing.sync("fusion_tables"):
            tabs = [t.detach().cpu().numpy() if t is not None else None
                    for t in self.tables(params)]
        if env is not None:
            env_band = (env.consts["type1"], env.consts["type2"], excl(env))
        else:
            env_band = (np.zeros(0, np.int64), np.zeros(n2, np.int64),
                        np.zeros((0, n2), bool))
        return make_prep(
            tabs[:3],
            [cov1.consts["type1"], cov2.consts["type1"], env_band[0],
             rot.consts["type"]],
            [cov1.consts["type2"], cov2.consts["type2"], env_band[1],
             rot.consts["type"]],
            [excl(cov1), excl(cov2), env_band[2],
             tri & (res[:, None] != res[None, :])],
            tabs[3], device, dtype)

    def block_inputs(self, consts, outputs):
        """(x1 rows (B, n1, 6), w1 (B, n1), x2 bead columns (B, n2, 6),
        wcol (B, n2)) from the member nodes' inputs.  The env column
        weight is exp(-1-body energy) of each bead, gathered through
        weighted_pos (fusion.py:177-181 of the JAX package); without the
        env band there are no env rows and wcol is zero."""
        cov1, cov2, rot = self.cov1, self.cov2, self.rot
        hb = outputs[cov1.args[0]][:, consts[cov1.name]["index1"]]
        hp = outputs[cov2.args[0]][:, consts[cov2.name]["index1"]]
        beads = outputs[rot.args[0]][:, consts[rot.name]["index"], :6]
        rows = [hb[..., :6], hp[..., :6]]
        if self.env is not None:
            env, wp = self.env, self.env_wp
            rows.append(outputs[self.env_cb.name][:, consts[env.name][
                "index1"], :6])
            scalar = outputs[wp.args[1]]
            wcol = torch.exp(-scalar[:, consts[wp.name]["index_weight"][
                consts[env.name]["index2"]], 0])
        else:
            wcol = beads.new_zeros(beads.shape[:2])
        rows.append(beads)
        x1 = torch.cat(rows, dim=1)
        n_rest = x1.shape[1] - hb.shape[1] - hp.shape[1]
        w1 = torch.cat([(1.0 - hb[..., 6]) ** 2, (1.0 - hp[..., 6]) ** 2,
                        beads.new_zeros(beads.shape[:1] + (n_rest,))], dim=1)
        return x1, w1, beads, wcol

    def compute(self, consts, outputs, prep, params, plain=False,
                residuals=True):
        """Run the fused block; returns {member name: node output}.  The
        table tensors of `params` go into the block, so their gradients
        reach them.  `prep` a list (tables stacked over replicas,
        `System.fused_prepared`): the block runs once per replica slot
        with that slot's operands and tables."""
        x1, w1, x2, wcol = self.block_inputs(consts, outputs)
        tabs = self.tables(params)
        if isinstance(prep, list):
            # a table is (n_type1, n_type2, width); stacked, (B, ...)
            slots = [fused_pair_block(
                p, x1[i:i + 1], w1[i:i + 1], x2[i:i + 1], wcol[i:i + 1],
                plain, [t[i] if t is not None and t.ndim > 3 else t
                        for t in tabs], residuals)
                for i, p in enumerate(prep)]
            cov, grid, envsum = (torch.cat(o) for o in zip(*slots))
        else:
            cov, grid, envsum = fused_pair_block(prep, x1, w1, x2, wcol,
                                                 plain, tabs, residuals)
        out = {self.cov1.name: cov[:, 0, :, None],
               self.cov2.name: cov[:, 1, :, None],
               self.rot.name + ":E_pair": grid}
        if self.env is not None:
            out[self.env.name] = envsum[..., None]
        return out


def _env_band(specs, rot, cov_last):
    """(env, env_cb, env_wp) when the environment coverage can ride the
    block as its env band, else None: its pair columns must be exactly the
    rotamer beads (through weighted_pos's index_pos), its CB probes must
    fit one 128-row tile, and its inputs must precede the second coverage
    member (fusion.py:262-293 of the JAX package)."""
    envs = [s for s in specs if s.node_type.name == "environment_coverage"]
    if len(envs) != 1:
        return None
    env = envs[0]
    by_name = {s.name: s for s in specs}
    wp, cb = by_name.get(env.args[1]), by_name.get(env.args[0])
    if (wp is None or wp.node_type.name != "weighted_pos" or cb is None
            or env.consts.get("id1") is None
            or env.consts.get("id2") is None
            or len(env.consts["index1"]) > MAX_ENV_ROWS
            or not np.array_equal(np.asarray(wp.consts["index_pos"])[
                np.asarray(env.consts["index2"])],
                np.asarray(rot.consts["index"]))):
        return None
    names = [s.name for s in specs]
    if not all(d == "pos" or names.index(d) <= cov_last
               for d in (env.args[0], wp.args[1])):
        return None
    return env, cb, wp


def plan_pair_fusion(specs) -> Optional[PairFusionPlan]:
    """Detect the (coverage, hydrophobe coverage, rotamer pair) group, with
    the environment coverage as its env band where that fits, as
    `plan_pair_fusion` (fusion.py:215-301) does.  Returns None unless the
    graph has the shape the fused block supports; the unfused nodes then
    run their own paths."""
    covs = [s for s in specs if s.node_type.name == "hbond_coverage"]
    rots = [s for s in specs if s.node_type.name == "rotamer"]
    if len(covs) != 2 or len(rots) != 1:
        return None
    rot = rots[0]
    index = np.asarray(rot.consts["index"])
    if int(rot.consts["n_res"]) > MAX_RES or len(index) > MAX_BEADS:
        return None
    for c in covs:
        if (c.args[1] != rot.args[0]
                or not np.array_equal(np.asarray(c.consts["index2"]), index)
                or c.consts.get("id1") is None
                or c.consts.get("id2") is None):
            return None
    try:
        fams = [quadspline_family(
            np.asarray(s.params["interaction_param"]).shape[-1])
            for s in (covs[0], covs[1], rot)]
    except (ValueError, KeyError):
        return None
    if fams[0] != fams[1] or fams[0][0] != fams[2][0] \
            or abs(fams[0][2] - fams[2][2]) > 1e-12:
        return None

    # the first coverage member moves directly before the second, so every
    # fused input must precede the second and nothing between the two may
    # read the first one's output
    names = [s.name for s in specs]
    cov_pos = sorted(names.index(c.name) for c in covs)
    needed = {covs[0].args[0], covs[1].args[0], rot.args[0]}
    if not all(d == "pos" or names.index(d) <= cov_pos[1] for d in needed):
        return None
    first = names[cov_pos[0]]
    if any(first in s.args for s in specs[cov_pos[0] + 1:cov_pos[1]]):
        return None
    cov1 = covs[0] if covs[0].name == first else covs[1]
    cov2 = covs[1] if cov1 is covs[0] else covs[0]
    env = _env_band(specs, rot, cov_pos[1]) or (None, None, None)
    return PairFusionPlan(cov1, cov2, rot, *env)
