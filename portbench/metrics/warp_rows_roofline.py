"""warp_rows_roofline: K2's least time a training step (the 5 forward
and 5 backward launches' bytes at 3.35 TB/s, each input read once and each
output written once) over their device time a step, in %."""

from portbench import readers


def read(r):
    return readers.roofline_percent(r, ("warp_rows_fwd", "warp_rows_bwd"),
                                    readers.warp_rows_bound_s(r))
