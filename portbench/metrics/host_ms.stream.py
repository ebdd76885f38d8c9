"""host_ms.stream: the benchmark's span from a request's start to the
serving forward's return (before the answer waits for the device), mean
ms over the window's requests."""

from portbench import readers


def read(r):
    return readers.span_mean_ms(r, "host_ms.stream")
