"""request_s: the window's seconds over the requests it completed (whole
requests), by the host's clock: what one user waits for a video."""


def read(run):
    return run.window_s / run.units if run.units else None
