"""assemble_z_roofline: K1's least time a pass (its bytes at 3.35 TB/s,
each input read once and each output written once, at the fused decoder
stages' shapes) over its device time a pass, in %."""

from portbench import readers


def read(r):
    return readers.roofline_percent(r, ("assemble_z",),
                                    readers.assemble_z_bound_s(r))
