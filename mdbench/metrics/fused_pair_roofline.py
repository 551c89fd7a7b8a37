"""Share of its roofline that the fused pair block reaches, forward and
backward (K1: `ops/fused_pair.py`, `csrc/fused_pair_{fwd,bwd}.cu`): the
least time its inputs' work needs (`roofline.fused_pair_s`, from the live
pairs at the traced positions) over the device time of the launches named
here, in percent.  K1's grid memset is not attributed (the trace names no
memset's caller); the column sums are shared with K4 and K5, which do not
run where K1 does.  Nothing to read where none of them ran."""

from mdbench import roofline

UNIT = "%"
KERNELS = ("k1_fwd_row_tile_kernel", "k1_bwd_row_tile_kernel",
           "sum_col_partials_kernel")


def read(traced):
    busy = traced.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * roofline.traced_bound(traced, roofline.fused_pair_s) / busy
