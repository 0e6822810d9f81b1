"""Set-up: process start to the first timed request (imports, kernel
libraries, data or weights, warm-up)."""


def read(run):
    return run.t0 - run.t_start
