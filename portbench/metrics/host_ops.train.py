"""host_ops.train: host operators a step in the profiled sub-window: the
trace's outermost ``cpu_op`` events, on any thread, that start inside the
program's span ``train.step``, the median over its spans."""

from portbench import spans


def read(r):
    return spans.host_ops(r, "train.step")
