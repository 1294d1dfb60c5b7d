"""Seconds from the start of run.py to the start of the window: imports,
the CUDA context, building or loading the kernels, the inputs and the
warm-up job (host clock)."""


def read(run):
    return run.setup_s
