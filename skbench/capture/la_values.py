"""The program's log K, pair by pair, as the timed path computes it: the
values ``BPLAKernel.log_value`` returns (K2, ``la_log_factored``, on the
factored route), before the engine normalizes them into the written Gram.

The wrapper around the CLI's BPLA featurizer adds one key, ``ID``, to the
features: the examples' indices in the job.  The engine gathers it with
every other feature, so the wrapper around ``BPLAKernel.log_value`` knows
which examples each row of a batch holds, however the program orders or
batches its pairs.  Each batch's indices and a copy of its values stay on
the device, in the running job's records under ``la_values``, until the
check reads them.  A name that is gone fails the run.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import numpy as np
import torch

ID = "skbench_id"
FEATURIZER = ("stem_kernel_torch.cli.bpla_kernel", "bpla_features")
KERNEL = ("stem_kernel_torch.models.bpla", "BPLAKernel", "log_value")


def _owner(module: str, *path: str):
    owner = importlib.import_module(module)
    for part in path[:-1]:
        owner = getattr(owner, part, None)
    if owner is None or not hasattr(owner, path[-1]):
        raise RuntimeError(f"capture la_values: {module}.{'.'.join(path)} is gone")
    return owner


@contextlib.contextmanager
def capture(records_of):
    """Install the two wrappers for the time of the block; ``records_of()``
    gives the dict of the job that is running."""
    feat_owner, kernel_owner = _owner(*FEATURIZER), _owner(*KERNEL)
    featurize, log_value = getattr(feat_owner, FEATURIZER[1]), getattr(kernel_owner, KERNEL[2])

    @functools.wraps(featurize)
    def featurize_with_ids(*args, **kwargs):
        feats = featurize(*args, **kwargs)
        feats[ID] = np.arange(len(feats["length"]), dtype=np.int64)
        return feats

    @functools.wraps(log_value)
    def log_value_kept(self, x, y):
        value = log_value(self, x, y)
        if ID in x and ID in y:
            records_of().setdefault("la_values", []).append(
                (x[ID], y[ID], value.detach().clone()))
        return value

    setattr(feat_owner, FEATURIZER[1], featurize_with_ids)
    setattr(kernel_owner, KERNEL[2], log_value_kept)
    try:
        yield
    finally:
        setattr(kernel_owner, KERNEL[2], log_value)
        setattr(feat_owner, FEATURIZER[1], featurize)


def values(records: dict) -> dict:
    """{(i, j): log K} of a job's captured batches (float64, host), each pair
    in the order the program computed it, x = i and y = j."""
    batches = records.get("la_values")
    if not batches:
        raise ValueError("the timed path gave no LA values for this job")
    ix = torch.cat([b[0] for b in batches]).cpu().numpy()
    iy = torch.cat([b[1] for b in batches]).cpu().numpy()
    v = torch.cat([b[2].reshape(-1) for b in batches]).double().cpu().numpy()
    return {(int(a), int(b)): float(val) for a, b, val in zip(ix, iy, v)}
