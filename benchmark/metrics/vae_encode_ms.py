"""vae_encode_ms: the clips' encode time of a training step (every
``compute_latents`` call of the step, by CUDA events around it), mean over
the window's steps, in ms."""


def read(run):
    pairs = run.runner.timer.pairs.get("vae_encode")
    steps = getattr(run.runner, "steps", 0)
    if not pairs or not steps:
        return None
    import torch

    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / steps
