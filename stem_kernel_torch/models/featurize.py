"""Padded feature arrays for the BPLA kernel.

A numpy copy of ``pad_to`` and ``bpla_features`` from
``stem_kernel_tpu/models/featurize.py``: every example becomes fixed-shape
padded arrays plus a true length, stacked over the example axis, which the
Gram engine moves to its device once.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..io.alphabet import N_RNA
from ..io.profile import Alignment, profile_from_alignment


def pad_to(n: int, multiple: int = 8) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def bpla_features(
    alignments: Sequence[Alignment],
    bpps: Sequence[np.ndarray],
    *,
    pad_multiple: int = 8,
) -> dict[str, np.ndarray]:
    """Features for the BPLA kernel: profiles + structural p_left/right/unpair.

    ``bpps``: per-example base-pair probability matrices over alignment
    columns (averaged over rows for alignments).
    """
    from .bpla import bpla_profiles

    n = len(alignments)
    lmax = pad_to(max(a.length for a in alignments), pad_multiple)
    prof = np.zeros((n, lmax, N_RNA), np.float32)
    pl = np.zeros((n, lmax), np.float32)
    pr = np.zeros((n, lmax), np.float32)
    pu = np.zeros((n, lmax), np.float32)
    lens = np.zeros(n, np.int32)
    for i, (aln, bpp) in enumerate(zip(alignments, bpps)):
        p = profile_from_alignment(aln)
        L = p.shape[0]
        base = p[:, :N_RNA]
        tot = base.sum(axis=1, keepdims=True)
        prof[i, :L] = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0)
        a, b, c = bpla_profiles(bpp)
        pl[i, :L], pr[i, :L], pu[i, :L] = a, b, c
        lens[i] = L
    return {
        "profile": prof,
        "p_left": pl,
        "p_right": pr,
        "p_unpair": pu,
        "length": lens,
    }
