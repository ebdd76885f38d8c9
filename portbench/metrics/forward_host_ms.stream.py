"""forward_host_ms.stream: the program's span ``serve`` (the serving forward's
whole call), mean ms a request over the window's requests."""

from portbench import spans


def read(r):
    return spans.mean_ms(r, "serve")
