"""dec_ms.serve: device ms a pass in the serving forward's decoder
stages (the port's dec0-dec4 scopes), from the profiled sub-window."""

from portbench import readers


def read(r):
    return readers.scope_ms(r, "dec")
