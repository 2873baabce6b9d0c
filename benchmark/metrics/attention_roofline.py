"""attention_roofline: the least time of the attention modules' work (every
CrossAttention and TemporalCrossAttention call of the traced unit:
projections, the attention core and the output projection, from their
shapes, benchmark/work/layers.py) over the device time of the operations
launched inside those modules' spans, in %."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "attention")
