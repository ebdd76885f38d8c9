"""idle.stream: the device's idle share of the profiled sub-window of
single-frame requests (host copies, dispatch and syncs included), in %."""

from portbench import readers


def read(r):
    return readers.idle_percent(r)
