"""The numbers that decide a run's `correct`, each a gap between what the
program produced and what the plain reference produced from the same
inputs.

MD (`state_gaps`, `md_readings`): over a checked chunk of rounds, from the
program's state at the chunk's start, the distance between the program's
and the reference's positions (momenta) at its end, as a share of how far
the reference moved them over the chunk, RMS over a replica's atoms: one
gap a sampled replica and chunk.  Two numbers are compared for each.  The
75th percentile of those gaps (`pos_gap_p75`, `mom_gap_p75`) is steady
from seed to seed and fails a run in which a quarter of the sample is
wrong.  The count of replica-chunks whose gap is over the cell's cap
(`pos_gap_over`, `mom_gap_over`) fails a run in which one sampled replica
is wrong in two of its chunks, so a fault confined to a few replicas, such
as a tail block of the batch, is seen once one of them is sampled.  The
worst gap is printed beside them, not compared: a trajectory that passes
close to where the force field changes abruptly magnifies any rounding,
and a float32 evaluation of the reference itself reads such rare gaps in
the same replicas as the program does; one such replica-chunk in a run
stays under the count's limit.

Training (`leaf_gap`): the gap between the program's norm of a leaf (the
first gradient, or the change after the checked steps) and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever is
larger; the worst leaf.  Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone and are
left out of the change.
"""

from __future__ import annotations

import torch


def _rms(x):
    return torch.sqrt((x.double() ** 2).mean((-1, -2)))


def state_gaps(start, prog, ref):
    """{pos_gap, mom_gap}: (S,) gaps of the sampled replicas; start, prog
    and ref are (pos, mom) pairs of (S, n_atom, 3) tensors."""
    out = {}
    for name, k in (("pos_gap", 0), ("mom_gap", 1)):
        moved = _rms(ref[k].double() - start[k].double())
        out[name] = _rms(prog[k].double() - ref[k].double()) / moved
    return out


def md_readings(gaps, caps):
    """The numbers compared, {pos_gap_p75, mom_gap_p75, pos_gap_over,
    mom_gap_over}, and the worst gaps beside them, from [state_gaps of
    each checked chunk]; caps {pos_gap, mom_gap} the per-replica caps of
    the counts.  A gap that is not a finite number counts as 1e30."""
    out = {}
    for name in ("pos_gap", "mom_gap"):
        g = torch.nan_to_num(torch.cat([c[name] for c in gaps]), nan=1e30,
                             posinf=1e30)
        out[name + "_p75"] = float(torch.quantile(g, 0.75))
        out[name + "_over"] = int((g > caps[name]).sum())
        out[name + "_max"] = float(g.max())
    return out


def leaf_norms(leaves):
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def leaf_gap(prog, ref, keep=None):
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖);
    prog and ref {leaf: norm}; `keep` the leaves to count (default all)."""
    names = sorted(ref if keep is None else keep)
    med = float(torch.tensor([ref[n] for n in sorted(ref)]).median())
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def moving_leaves(first_grad_norms):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(torch.tensor(list(first_grad_norms.values())).median())
    return [n for n, g in first_grad_norms.items() if g >= 1e-3 * med]


def train_gaps(prog_losses, prog_grad, prog_change, ref_losses, ref_grad,
               ref_change):
    """{loss_gap, grad_gap, change_gap}: the worst step's relative loss
    gap, and the two leaf gaps (norms as {leaf: float})."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    return {"loss_gap": loss, "grad_gap": leaf_gap(prog_grad, ref_grad),
            "change_gap": leaf_gap(prog_change, ref_change,
                                   moving_leaves(ref_grad))}
