"""Share of its roofline that the unfused pair splines reach, forward and
backward (K4 for each coverage node, K5 for the rotamer grid:
`ops/quadspline.py`, `csrc/quadspline.cu`): the least time their inputs'
work needs (`roofline.quadspline_s`, from the live pairs at the traced
positions) over the device time of the launches named here, in percent.
The column sums are shared with K1, which does not run where these do.
Nothing to read where none of them ran."""

from mdbench import roofline

UNIT = "%"
KERNELS = ("colsum_fwd_row_tile_kernel", "colsum_bwd_row_tile_kernel",
           "quadspline_fwd_band_kernel", "quadspline_bwd_row_tile_kernel",
           "sum_col_partials_kernel")


def read(traced):
    busy = traced.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * roofline.traced_bound(traced, roofline.quadspline_s) / busy
