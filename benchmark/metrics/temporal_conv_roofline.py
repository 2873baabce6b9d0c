"""temporal_conv_roofline: the least time of the temporal convolution blocks'
work (four GroupNorm+SiLU+Conv3d (3,1,1) layers each, from their shapes,
benchmark/work/layers.py) over the device time of the operations launched
inside those blocks' spans, in %."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "temporal_conv")
