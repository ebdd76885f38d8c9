"""adam_host_ms.train: the program's span ``train.adam`` (the learning rate
and Adam's step), mean ms a step over the window's steps."""

from portbench import spans


def read(r):
    return spans.mean_ms(r, "train.adam")
