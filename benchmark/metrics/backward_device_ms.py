"""backward_device_ms: the device ms of a training step's backward, the
summed durations of the device operations launched inside the program's
``t2v.train.backward`` span (by the autograd engine's thread too) over the
number of steps, in the traced units."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "t2v.train.backward")
