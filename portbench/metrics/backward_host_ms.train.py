"""backward_host_ms.train: the program's span ``train.backward``, mean ms a
step over the window's steps."""

from portbench import spans


def read(r):
    return spans.mean_ms(r, "train.backward")
