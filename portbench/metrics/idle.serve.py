"""idle.serve: the device's idle share of the profiled sub-window of
back-to-back serving passes, in %."""

from portbench import readers


def read(r):
    return readers.idle_percent(r)
