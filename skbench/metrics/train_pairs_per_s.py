"""Gram pairs, N(N+1)/2 a job, of every train job in the window, over the
window's seconds (host clock; the window ends with the first job that
finishes after --seconds)."""


def read(run):
    pairs = sum(j.pairs for j in run.jobs)
    return pairs / run.window_s if pairs else None
