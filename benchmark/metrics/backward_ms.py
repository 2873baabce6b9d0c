"""backward_ms: the mean duration of the program's ``t2v.train.backward``
span, the host's ms of a training step's ``autograd.grad``, in the traced
units."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "t2v.train.backward")
