"""Mixed-length structured sequences: ``bench_full200.py:make_mixed``
(BASELINE config 3), each a stem of a third of its length, a random middle
and the stem's reverse complement.

Lengths: ``2 * per_class`` values spread evenly over ``length_range``
(inclusive), in an order drawn from ``rng``; config 3 draws them uniformly
at random instead.  Every seed then runs the same lengths, so the seed
changes the sequences and the order of the pairs, not the work.  The first
``per_class`` are the positives, the rest the negatives (one generator
makes both classes, as config 3 does).
"""

from __future__ import annotations

import numpy as np

from .family import BASES


def make(spec: dict, rng: np.random.Generator, job: int | None, core: str | None = None) -> dict:
    n = 2 * int(spec["per_class"])
    lo, hi = spec["length_range"]
    lengths = rng.permutation(np.round(np.linspace(lo, hi, n)).astype(int))
    seqs = []
    for ln in lengths:
        stem = rng.integers(0, 4, ln // 3)
        mid = rng.integers(0, 4, ln - 2 * len(stem))
        seqs.append("".join(BASES[np.concatenate([stem, mid, 3 - stem[::-1]])]))
    half = int(spec["per_class"])
    return {"pos": seqs[:half], "neg": seqs[half:], "core": None}
