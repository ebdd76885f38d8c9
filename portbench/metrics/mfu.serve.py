"""mfu.serve: the model's operations a frame (work/flops.py) times the
frames served in the window, over the window and the bf16 peak (989
TFLOP/s), in %."""

from portbench import readers
from portbench.work import peaks


def read(r):
    return readers.mfu_percent(r, readers.forward_flops(r, 1),
                               r.counts.get("passes", 0) * r.traffic["batch"],
                               peaks.DTYPE_PEAKS[r.config["dtype"]])
