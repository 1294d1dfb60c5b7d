"""Padded feature arrays for the BPLA and string kernels.

A numpy copy of ``stem_kernel_tpu/models/featurize.py``: every example
becomes fixed-shape padded arrays plus a true length, stacked over the
example axis, which the Gram engine moves to its device once.
``loop_profile_weights`` folds on a named device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..io.alphabet import N_RNA, encode
from ..io.profile import Alignment, profile_from_alignment
from ..utils.tracing import count, span


def pad_to(n: int, multiple: int = 8) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def string_kernel_features(
    alignments: Sequence[Alignment],
    *,
    weights: Sequence[np.ndarray] | None = None,
    pad_multiple: int = 8,
) -> dict[str, np.ndarray]:
    """Features for the profile string kernel: normalized column profiles.

    Profiles are normalized to sum 1 over the non-gap slots (the reference's
    subst_score divides by the count cross-product, which equals using
    normalized profiles).  Optional per-position ``weights`` (unpaired-loop
    profiles) ride along; absent weights default to 1.
    """
    n = len(alignments)
    lmax = pad_to(max(a.length for a in alignments), pad_multiple)
    prof = np.zeros((n, lmax, N_RNA), np.float32)
    wts = np.zeros((n, lmax), np.float32)
    lens = np.zeros(n, np.int32)
    for i, aln in enumerate(alignments):
        p = profile_from_alignment(aln)
        L = p.shape[0]
        base = p[:, :N_RNA]
        tot = base.sum(axis=1, keepdims=True)
        prof[i, :L] = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0)
        wts[i, :L] = 1.0 if weights is None else weights[i]
        lens[i] = L
    return {"profile": prof, "weight": wts, "length": lens}


def plain_string_features(
    seqs: Sequence[str], *, pad_multiple: int = 8
) -> dict[str, np.ndarray]:
    """Features for the exact-match string kernel: encoded code arrays."""
    n = len(seqs)
    lmax = pad_to(max(len(s) for s in seqs), pad_multiple)
    codes = np.zeros((n, lmax), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        c = encode(s)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return {"codes": codes, "length": lens}


def bpla_features(
    alignments: Sequence[Alignment],
    bpps: Sequence[np.ndarray],
    *,
    pad_multiple: int = 8,
) -> dict[str, np.ndarray]:
    """Features for the BPLA kernel: profiles + structural p_left/right/unpair.

    ``bpps``: per-example base-pair probability matrices over alignment
    columns (averaged over rows for alignments).  The span
    ``bpla_features``; the examples count in ``bpla.sequences``.
    """
    from .bpla import bpla_profiles

    n = len(alignments)
    count("bpla.sequences", n)
    with span("bpla_features"):
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


def loop_profile_weights(alignments, bp_opts=None, *, device):
    """Per-position unpaired-loop-profile weights for the string kernel.

    The ``--use-bp`` mode of the lite la_kernel
    (stem_kernel_lite/la-main.cpp:104-117): every alignment row is folded
    on ``device``, and each column's weight is the row-averaged unpaired
    probability (Profiler::non_bp_profile, stem_kernel_lite/data.cpp:94-123).
    Returns a list of (L_i,) float arrays aligned with ``alignments``.
    """
    from ..fold.bpmatrix import fold_sequences
    from .dag import _Profiler

    flat_rows: list[str] = []
    spans: list[tuple[int, int]] = []
    for a in alignments:
        rows = a.ungapped_rows()
        spans.append((len(flat_rows), len(rows)))
        flat_rows.extend(rows)
    row_bpps = fold_sequences(flat_rows, bp_opts, device=device)

    out = []
    for a, (start, cnt) in zip(alignments, spans):
        profs = [_Profiler(r, b)
                 for r, b in zip(a.rows, row_bpps[start : start + cnt])]
        total_w = sum(p.w for p in profs)
        lp = np.zeros(a.length)
        for p in profs:
            lp += p.loop_profile_vec()
        out.append((lp / total_w).astype(np.float32))
    return out
