"""emit_ms: the mean duration of the program's ``t2v.emit`` span, the host's
ms to write one video's outputs (PNG frames, ``args.txt``, the manifest), in
the traced units."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "t2v.emit")
