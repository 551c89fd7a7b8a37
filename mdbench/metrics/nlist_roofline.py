"""Share of their roofline that the fixed-K neighbour lists reach,
forward and backward: the least time that K4 and K5 would need for the
same live pairs at the traced positions (`roofline.quadspline_s`: each
coverage node's and the rotamer grid's pair splines) over the stream
seconds of the list spans that `nlist_ms_per_eval` sums, in percent.
The bound counts the pairs' work whatever computes them, so a later
kernel for the lists is held to the same yardstick.  Nothing to read
where `nlist_ms_per_eval` reads nothing."""

from mdbench import harness, roofline

UNIT = "%"


def read(traced):
    ms = harness.load_module("metrics", "nlist_ms_per_eval").read(traced)
    if ms is None:
        return None
    spent = 1e-3 * ms * traced.evals
    return 100.0 * roofline.traced_bound(traced, roofline.quadspline_s) \
        / spent
