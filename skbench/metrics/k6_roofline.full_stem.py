"""K6's share of its roofline in the traced window of the full stem train
flow, in percent: the least time of every Gram pair the window's jobs
computed (roofline.k6_seconds: max(lx, ly)(max(lx, ly) + 1)/2 windows of
(2 band + 1)^2 cells a pair, from the corpus's lengths) over the device
time of K6's kernel by name (``full_stem_level``)."""

import numpy as np

from skbench.roofline import k6_seconds


def read(run):
    t = run.trace
    if t is None:
        return None
    _, kernel_s = t.kernel_seconds("full_stem_level")
    band = int(run.cell.config["options"]["-b"])
    bound = 0.0
    for job in run.jobs:
        lens = np.array([len(s) for s in job.corpus["pos"] + job.corpus["neg"]])
        ix, iy = np.triu_indices(len(lens))
        bound += k6_seconds(lens[ix], lens[iy], band)
    if bound == 0.0 or kernel_s == 0.0:
        return None
    return 100.0 * bound / kernel_s
