"""Seconds from the process's start to the window's first step: imports, the
kernels' build on a checkout's first run, weights, the case pool, the checked
first steps that warm every shape up."""


def read(run):
    return run.setup_s
