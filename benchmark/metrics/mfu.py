"""mfu: the window's model operations over (window seconds x the card's dense
bf16 peak, benchmark/work/peaks.json), in %. The operations are counted
from the configuration's shapes (benchmark/work/models.py), whatever kernels
run: the loop says which calls its units made (``model_flops``)."""


def read(run):
    if run.peaks is None or not run.window_s:
        return None
    return 100.0 * run.runner.model_flops() / (run.window_s * run.peaks["flops"])
