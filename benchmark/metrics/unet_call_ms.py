"""unet_call_ms: the mean time of one UNet call (a CFG-batched call of the
sampler loop) over the window, by CUDA events recorded from forward hooks
around the call (benchmark/spans.py)."""


def read(run):
    return run.runner.timer.mean_ms("unet_call")
