"""host_ms.train: the benchmark's span from a call of
Trainer.train_step to its return, before any sync, mean ms over the
window's steps."""

from portbench import readers


def read(r):
    return readers.span_mean_ms(r, "host_ms.train")
