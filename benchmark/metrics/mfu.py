"""mfu: the window's model operations over (window seconds x the cell's cards
x one card's dense bf16 peak, benchmark/work/peaks.json), in %. The
operations are counted once for the whole work, from the configuration's
shapes (benchmark/work/models.py), whatever kernels run and whichever card
runs them: the loop says which calls its units made (``model_flops``). Work
that several cards each repeat, as the temporal blocks under a frame split,
is counted once and shows as utilisation lost."""


def read(run):
    if run.peaks is None or not run.window_s:
        return None
    return 100.0 * run.runner.model_flops() / (run.window_s * run.cell.chips * run.peaks["flops"])
