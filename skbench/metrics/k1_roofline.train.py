"""K1's share of its roofline in the traced window of the train flow, in
percent: the least time of every Gram pair the window's jobs computed
(roofline.k1_seconds, from each example's unpadded DAG node count and
depth as the featurizer returned them; a pair takes min(depth_x, depth_y)
+ 1 trips, in the mode --precision names) over the device time of K1's
kernels by name (``fixed_point_cluster``, ``fixed_point_tiles``)."""

import numpy as np

from skbench.roofline import k1_seconds

K1_KERNELS = ("fixed_point_cluster", "fixed_point_tiles")


def read(run):
    t = run.trace
    if t is None:
        return None
    _, kernel_s = t.kernel_seconds(*K1_KERNELS)
    precision = run.cell.config["options"].get("--precision", "high")
    bound = 0.0
    for job in run.jobs:
        recs = job.records.get("stem_features")
        if not recs:
            continue
        idx = np.concatenate([r[0] for r in recs])
        nodes = np.zeros(len(idx), np.int64)
        depth = np.zeros(len(idx), np.int64)
        for i, n, d in recs:
            nodes[i], depth[i] = n, d
        ix, iy = np.triu_indices(len(idx))
        trips = np.minimum(depth[ix], depth[iy]) + 1
        bound += k1_seconds(nodes[ix], nodes[iy], trips, precision)
    if bound == 0.0 or kernel_s == 0.0:
        return None
    return 100.0 * bound / kernel_s
