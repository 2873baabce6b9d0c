"""optimizer_ms: the mean duration of the program's ``t2v.train.optimizer``
span, the host's ms of a training step's AdamW update (and EMA), in the
traced units."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "t2v.train.optimizer")
