"""sampler_ms: the mean self time of the program's ``t2v.step`` span (its
duration less the ``t2v.unet`` spans inside it): the sampler's own host ms a
step, its guidance, update, draws and callback, in the traced units."""

from benchmark.metrics._spans import mean_self_ms


def read(run):
    return mean_self_ms(run, "t2v.step", "t2v.unet")
