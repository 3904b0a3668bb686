"""Set-up: process start to the first timed request (imports, CUDA
start, inputs and weights made, surrogate trained, calibration, warm-up
of every shape the window uses; in a checkout's first run, the kernels'
build too)."""


def read(run):
    return run.setup_s
