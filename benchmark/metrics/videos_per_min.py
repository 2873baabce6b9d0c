"""videos_per_min: videos completed in the window over its minutes, by the
host's clock."""


def read(run):
    return run.runner.videos / (run.window_s / 60.0) if run.window_s else None
