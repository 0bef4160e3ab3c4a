"""Seconds from the process's start to the window's first item: imports,
the kernels' build or load, weights, inputs and warm-up."""


def read(run):
    return run.setup_s
