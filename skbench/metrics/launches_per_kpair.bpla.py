"""Kernel launches on the device in the traced window of the BPLA train flow
(device events that are not copies or sets: the fold's, the features'
moves, the factors' and K2's) per thousand Gram pairs of the window's jobs."""


def read(run):
    t = run.trace
    pairs = sum(j.pairs for j in run.jobs)
    if t is None or not pairs:
        return None
    return t.launches() / (pairs / 1000.0)
