"""host_ops.stream: host operators a request in the profiled sub-window: the
trace's outermost ``cpu_op`` events, on any thread, that start inside the
program's span ``serve``, the median over its spans."""

from portbench import spans


def read(r):
    return spans.host_ops(r, "serve")
