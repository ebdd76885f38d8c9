"""enc_ms.serve: device ms a pass in the serving forward's encoder
stages (the port's enc0-enc4 scopes), from the profiled sub-window."""

from portbench import readers


def read(r):
    return readers.scope_ms(r, "enc")
