"""unet_device_ms: the device ms of one CFG-batched UNet call, the summed
durations of the device operations launched inside the program's
``t2v.unet`` span over the number of spans, in the traced units. The
profiler does not stretch device time as it does the span's host time."""

from benchmark.metrics._spans import device_ms


def read(run):
    return device_ms(run, "t2v.unet")
