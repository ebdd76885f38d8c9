"""mfu.train: a training step's operations (three forwards at its batch,
work/flops.py) times the steps in the window, over the window and the f32
peak (67 TFLOP/s) of every card used, in %."""

from portbench import readers
from portbench.work import peaks


def read(r):
    return readers.mfu_percent(r, 3 * readers.forward_flops(
        r, r.traffic["batch"]), r.counts.get("steps", 0),
        peaks.DTYPE_PEAKS[r.config["dtype"]] * r.cell.chips)
