"""Set-up seconds: from the process's start (imports, weights, cache
fill, the nvcc build of a first run, warm-up of the cell's shapes) to the
window's start."""


def read(run):
    return run.setup_s
