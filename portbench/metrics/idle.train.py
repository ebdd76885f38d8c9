"""idle.train: the device's idle share of the profiled sub-window of
training steps, in %."""

from portbench import readers


def read(r):
    return readers.idle_percent(r)
