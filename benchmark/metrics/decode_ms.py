"""decode_ms: the port's own synced decode time of a video
(``InferResult.timings["decode"]``, or ``RunResult.timings["decode"]`` over
the request's videos, on the rank that decodes), mean over the window, in
ms."""


def read(run):
    d = getattr(run.runner, "decode_s", None)
    return 1000.0 * sum(d) / len(d) if d else None
