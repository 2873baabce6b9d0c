"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window, in GiB;
the largest over the cell's cards where it takes several."""


def read(run):
    return run.peak_bytes / 2**30 if run.on_card and run.peak_bytes else None
