"""unet_host_ms: the mean duration of the program's ``t2v.unet`` span, the
host's ms to launch one CFG-batched UNet call, in the traced units."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "t2v.unet")
