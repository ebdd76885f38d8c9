"""adam_idle_ms.train: device-idle ms a step inside the program's span
``train.adam``, in the profiled sub-window (the recorder's spans mapped onto
the trace's clock)."""

from portbench import spans


def read(r):
    return spans.idle_ms_inside(r, "train.adam")
