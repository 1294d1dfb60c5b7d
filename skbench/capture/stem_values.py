"""The program's stem-kernel values, pair by pair, as the timed path computes
them: K1's closure fixed point and its leaf term, before the string kernel
is added (``stem_kernel_lite`` writes only the sum, in which the stem part
can be a vanishing share).

The wrapper around the bucketed stem featurizer adds one key, ``ID``, to
each bucket's features: the examples' indices in the job.  The engine
gathers it with every other feature, so the wrapper around
``stem_kernel_pairs`` knows which examples each row of a batch holds,
however the program orders, buckets or batches its pairs.  Each batch's
indices and a copy of its values stay on the device, in the running job's
records under ``stem_values``, until the check reads them.  A name that is
gone fails the run.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch

ID = "skbench_id"
FEATURIZER = ("stem_kernel_torch.cli.stem_kernel_lite", "featurize_stem_bucketed")
PAIRS = ("stem_kernel_torch.models.stem_kernel", "stem_kernel_pairs")


def _owner(module: str, name: str):
    owner = importlib.import_module(module)
    if not hasattr(owner, name):
        raise RuntimeError(f"capture stem_values: {module}.{name} is gone")
    return owner


@contextlib.contextmanager
def capture(records_of):
    """Install the two wrappers for the time of the block; ``records_of()``
    gives the dict of the job that is running."""
    feat_owner, pairs_owner = _owner(*FEATURIZER), _owner(*PAIRS)
    featurize, pairs = getattr(feat_owner, FEATURIZER[1]), getattr(pairs_owner, PAIRS[1])

    @functools.wraps(featurize)
    def featurize_with_ids(*args, **kwargs):
        buckets = featurize(*args, **kwargs)
        for idx, feats, _ in buckets:
            feats[ID] = torch.as_tensor(idx, dtype=torch.int64, device=feats["valid"].device)
        return buckets

    @functools.wraps(pairs)
    def pairs_kept(x, y, *args, **kwargs):
        value = pairs(x, y, *args, **kwargs)
        if ID in x and ID in y:
            records_of().setdefault("stem_values", []).append(
                (x[ID], y[ID], value.detach().clone()))
        return value

    setattr(feat_owner, FEATURIZER[1], featurize_with_ids)
    setattr(pairs_owner, PAIRS[1], pairs_kept)
    try:
        yield
    finally:
        setattr(pairs_owner, PAIRS[1], pairs)
        setattr(feat_owner, FEATURIZER[1], featurize)


def values(records: dict) -> dict:
    """{(i, j): value} of a job's captured batches (float64, host), each pair
    in the order the program computed it, x = i and y = j: the stem kernel
    is not symmetric to rounding (the leaf term and the closures' order)."""
    batches = records.get("stem_values")
    if not batches:
        raise ValueError("the timed path gave no stem-kernel values for this job")
    ix = torch.cat([b[0] for b in batches]).cpu().numpy()
    iy = torch.cat([b[1] for b in batches]).cpu().numpy()
    v = torch.cat([b[2].reshape(-1) for b in batches]).double().cpu().numpy()
    return {(int(a), int(b)): float(val) for a, b, val in zip(ix, iy, v)}
