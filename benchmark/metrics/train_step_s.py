"""train_step_s: the window's seconds over the training steps it completed,
the clips' encode and the captions' included, by the host's clock."""


def read(run):
    return run.window_s / run.units if run.units else None
