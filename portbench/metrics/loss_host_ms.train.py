"""loss_host_ms.train: the program's span ``train.loss`` (the layout change,
the reconstruction and consistency warps and the composite loss), mean ms
a step over the window's steps."""

from portbench import spans


def read(r):
    return spans.mean_ms(r, "train.loss")
