"""setup_s: seconds from the start of the process to the end of set-up
(imports, the kernels built or loaded, the pipeline and its weights, the
warm-up unit), by the host's clock."""


def read(run):
    return run.setup_s
