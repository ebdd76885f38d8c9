"""forward_host_ms.train: the program's span ``train.forward`` (the inputs to
the device, the image pyramid, zero_grad and the model's forward), mean ms
a step over the window's steps."""

from portbench import spans


def read(r):
    return spans.mean_ms(r, "train.forward")
