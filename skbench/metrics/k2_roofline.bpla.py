"""K2's share of its roofline in the traced window of the BPLA train flow, in
percent: the least time of every Gram pair the window's jobs computed, N(N+1)/2
a job with the diagonal (roofline_la.k2_seconds, from the corpus's unpadded
lengths) over the device time of the LA log kernels by name
(``la_log_lanes``, the lane geometries, and ``la_dp``, the one-warp kernel).
On this flow every LA launch is K2's."""

import numpy as np

from skbench.roofline_la import k2_seconds

K2_KERNELS = ("la_log_lanes", "la_dp")


def read(run):
    t = run.trace
    if t is None:
        return None
    _, kernel_s = t.kernel_seconds(*K2_KERNELS)
    bound = 0.0
    for job in run.jobs:
        lens = np.array([len(s) for s in job.corpus["pos"] + job.corpus["neg"]])
        ix, iy = np.triu_indices(len(lens))
        bound += k2_seconds(lens[ix], lens[iy])
    if bound == 0.0 or kernel_s == 0.0:
        return None
    return 100.0 * bound / kernel_s
