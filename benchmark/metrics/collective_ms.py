"""collective_ms: the device ms of the collective kernels (NCCL's) launched
inside the program's ``t2v.unet`` span, over the number of spans, in the
traced units of rank 0: the frame exchanges of one UNet call under a frame
split. NCCL's kernels run on a stream of their own, so their time counts
whether or not the card's other work overlaps it. None where the trace
holds no ``t2v.unet`` span or no collective kernel inside one."""

from benchmark.trace import is_collective


def read(run):
    tr = run.trace
    n = tr.span_count("t2v.unet") if tr is not None else 0
    ops = [k for k in tr.under("t2v.unet") if is_collective(k[0])] if n else []
    return sum(e - s for _, s, e, _ in ops) / n * 1e-6 if ops else None
