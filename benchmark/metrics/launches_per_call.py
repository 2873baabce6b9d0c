"""launches_per_call: device operations launched inside the UNet-call spans of
the traced unit, over the calls (the profiler's trace, matched to the span
by the host time of each launch)."""


def read(run):
    tr = run.trace
    calls = tr.span_count("unet_call") if tr else 0
    return len(tr.under("unet_call")) / calls if calls else None
