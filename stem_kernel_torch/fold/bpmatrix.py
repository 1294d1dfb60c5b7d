"""BPP matrices for alignments: fold-and-average, the BPMatrix facade.

Port of ``stem_kernel_tpu/fold/bpmatrix.py`` (the reference's BPMatrix layer,
stem_kernel/common/bpmatrix.{h,cpp}).  FOLD runs the scaled McCaskill
engine on every ungapped row and averages the matrices over alignment
columns (average_matrix, bpmatrix.cpp:306-342).  Sequences are folded in
batches of similar length, each padded to its own longest member.

ALIFOLD is a covariance-scored consensus fold over alignment columns: every
loop energy evaluated per row and averaged (tables._build_luts_averaged),
plus per-column-pair covariance weights.  The JAX package folds one
alignment a call at its own length; here the alignments of a corpus fold
in batches of one fixed shape, padded in columns (gap code 4) and in rows
(all-gap rows), with all-gap dummies of length 0 filling the last batch of
a shape on the card.  An alignment folds in that shape alone too, so its
values do not depend on the alignments beside it (see ``_alifold_shape``).  SFOLD
(``n_samples > 0``) estimates the BPPs by stochastic traceback
(fold.sampling).  A CONTRAfold model is an ``EnergyParams`` like any other
(fold.contrafold).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.alphabet import encode
from ..io.profile import Alignment, index_map, profile_from_alignment
from ..utils.tracing import count, span
from .mccaskill_scaled import mccaskill_bpp_batch_scaled
from .params import N_PAIR, PAIR_TYPE, EnergyParams, default_params

# a fold batch holds at most this many padded (n x n) table cells, counted
# once a row for alignment-row batches (each row has its own LUT set): the
# engine's memory is O(B R n^2); a batch is never smaller than one example
MAX_BATCH_CELLS = 1 << 24
# the alifold batch shape: widths in steps of 8 columns, depths in steps
# of 4 rows, 64 alignments a batch (fewer where MAX_BATCH_CELLS says so);
# a batch costs about as much on the card as one alignment alone
ALIFOLD_PAD_COLS, ALIFOLD_PAD_ROWS, ALIFOLD_BATCH = 8, 4, 64


@dataclass
class BPMatrixOptions:
    """Folding options (BPMatrix::Options, common/bpmatrix.cpp:45-93)."""

    alifold: bool = False
    n_samples: int = 0  # >0 -> stochastic sampling (SFOLD)
    params: EnergyParams | None = None

    def resolved_params(self) -> EnergyParams:
        return self.params if self.params is not None else default_params()


def _length_groups(lengths: list[int]) -> list[list[int]]:
    """Indices sorted by length, cut into batches of at most
    ``MAX_BATCH_CELLS`` padded table cells (each batch pads to its longest)."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    groups: list[list[int]] = []
    cur: list[int] = []
    for i in order:
        n = max(lengths[i], 1)
        if cur and (len(cur) + 1) * n * n > MAX_BATCH_CELLS:
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)
    return groups


def _alifold_shape(n_cols: int, n_rows: int) -> tuple[int, int, int]:
    """(batch, rows, width) of the fold an alignment of ``n_rows`` x
    ``n_cols`` takes part in, alone or among others.

    f32 sums round differently with the width and depth of the padded axes
    they run over, and CUDA picks a reduction's split by the number of
    outputs, so a batch of another size gives other bits (up to 3e-5 on BPP
    on an H100).  One shape per (width, depth) class keeps an
    alignment's values those it gets alone.  The batch holds at most
    ``MAX_BATCH_CELLS`` cells of B * R * n^2: each row has its own LUT set.
    The CPU's sums do not depend on the batch size, so there a batch holds
    only its alignments (dummies would cost their full arithmetic).
    """
    width = -(-max(n_cols, 1) // ALIFOLD_PAD_COLS) * ALIFOLD_PAD_COLS
    rows = -(-max(n_rows, 1) // ALIFOLD_PAD_ROWS) * ALIFOLD_PAD_ROWS
    return max(1, min(ALIFOLD_BATCH, MAX_BATCH_CELLS // (rows * width * width))), rows, width


def fold_sequences(seqs: list[str], opts: BPMatrixOptions | None = None, *,
                   device) -> list[np.ndarray]:
    """BPP matrix (float64, host) per ungapped sequence, folded on ``device``.

    With ``n_samples > 0`` the SFOLD path estimates BPPs by stochastic
    traceback sampling instead of the outside pass (bpmatrix.cpp:179-232),
    each sequence with seed 0.
    """
    opts = opts or BPMatrixOptions()
    params = opts.resolved_params()
    count("fold.sequences", len(seqs))
    if opts.n_samples > 0:
        from .sampling import sfold_bpp

        with span("fold"):
            return [sfold_bpp(s, opts.n_samples, params, device=device) for s in seqs]
    codes_all = [encode(s) for s in seqs]
    out: list[np.ndarray | None] = [None] * len(seqs)
    with span("fold"):
        for idxs in _length_groups([len(c) for c in codes_all]):
            lpad = max(1, max(len(codes_all[i]) for i in idxs))
            codes = np.zeros((len(idxs), lpad), np.uint8)
            lens = np.zeros(len(idxs), np.int32)
            for r, i in enumerate(idxs):
                codes[r, : len(codes_all[i])] = codes_all[i]
                lens[r] = len(codes_all[i])
            bpps, _ = mccaskill_bpp_batch_scaled(codes, lens, params, device=device)
            host = bpps.cpu().numpy()
            count("fold.batches")
            for r, i in enumerate(idxs):
                L = lens[r]
                out[i] = np.asarray(host[r, :L, :L], dtype=np.float64)
    return out  # type: ignore[return-value]


def average_bpp(aln: Alignment, row_bpps: list[np.ndarray]) -> np.ndarray:
    """Average per-row BPP matrices over alignment columns.

    Each row's ungapped matrix is scattered to alignment-column coordinates
    through its gap index map, then averaged over rows (average_matrix,
    stem_kernel/common/bpmatrix.cpp:306-342).
    """
    L = aln.length
    acc = np.zeros((L, L))
    for row, bpp in zip(aln.rows, row_bpps):
        idx = index_map(row)  # column -> ungapped position or -1
        cols = np.flatnonzero(idx >= 0)
        sub = bpp[np.ix_(idx[cols], idx[cols])]
        acc[np.ix_(cols, cols)] += sub
    return acc / max(len(aln.rows), 1)


def bpp_for_alignments(alignments: list[Alignment], opts: BPMatrixOptions | None = None,
                       *, device) -> list[np.ndarray]:
    """BPP matrices for many alignments, folding all rows in shared batches
    (or, with ``opts.alifold``, the alignments' consensus folds in batches)."""
    opts = opts or BPMatrixOptions()
    if opts.alifold:
        return alifold_bpps(alignments, opts, device=device)
    flat: list[str] = []
    spans: list[tuple[int, int]] = []
    for a in alignments:
        rows = a.ungapped_rows()
        spans.append((len(flat), len(rows)))
        flat.extend(rows)
    all_bpps = fold_sequences(flat, opts, device=device)
    return [average_bpp(a, all_bpps[start: start + cnt]) for a, (start, cnt) in
            zip(alignments, spans)]


def bpp_for_alignment(aln: Alignment, opts: BPMatrixOptions | None = None, *,
                      device) -> np.ndarray:
    """BPP matrix over alignment columns (the reference's MData input)."""
    return bpp_for_alignments([aln], opts, device=device)[0]


def alifold_covariance(
    aln: Alignment, *, cov_weight: float = 1.6, noncanon_penalty: float = 1.6
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(consensus_codes, w_extra, pt_major, row_codes) for a covariance fold.

    ``row_codes`` is the (R, L) per-row nucleotide matrix (gap/other = 4)
    consumed by the true-alifold averaged LUTs.

    RNAalifold-style column-pair scoring (Hofacker 2002, the engine behind
    the reference's ALIFOLD method via alipf_fold,
    stem_kernel/common/bpmatrix.cpp:355-397), expressed in log-weight
    space as a per-(i, j) additive term for the partition function:

      cov(i, j)  = sum over unordered row pairs of the Hamming distance
                   between their (canonical) base pairs, / C(R, 2)
                   — compensatory double mutations score 2, single
                   consistent mutations 1;
      pen(i, j)  = fraction of rows whose (i, j) is neither canonical nor
                   fully gapped (0.25 for half-gapped rows, 1.0 otherwise);
      w_extra    = cov_weight * cov - noncanon_penalty * pen, and NEG where
                   no row can pair (i, j).

    Computed with O(36 n^2) pair-type count contractions, not O(R^2 n^2)
    row-pair loops.  Host numpy, as in the JAX package.
    """
    L = aln.length
    R = aln.n_rows
    code = np.full((R, L), 4, np.int8)  # 4 = gap/other
    lut = {"a": 0, "c": 1, "g": 2, "u": 3, "t": 3}
    for r, row in enumerate(aln.rows):
        for i, ch in enumerate(row.lower()):
            code[r, i] = lut.get(ch, 4)

    # per-row pair types over the (i, j) grid: -1 noncanon, -2 any gap
    pt_tab = np.full((5, 5), -1, np.int8)
    pt_tab[:4, :4] = PAIR_TYPE
    pt_tab[4, :] = -2
    pt_tab[:, 4] = -2
    pt = pt_tab[code[:, :, None], code[:, None, :]]  # (R, L, L)

    # counts per canonical pair type
    cnt = np.zeros((N_PAIR, L, L), np.float32)
    for t in range(N_PAIR):
        cnt[t] = (pt == t).sum(axis=0)
    n_canon = cnt.sum(axis=0)
    n_gap = (pt == -2).sum(axis=0).astype(np.float32)
    n_bad = R - n_canon - n_gap

    # Hamming distances between pair types (CG GC GU UG AU UA as 2-mers)
    pair_strs = ["cg", "gc", "gu", "ug", "au", "ua"]
    D = np.array([[sum(a != b for a, b in zip(p, q)) for q in pair_strs]
                  for p in pair_strs], np.float32)
    n_rowpairs = max(R * (R - 1) / 2.0, 1.0)
    cov = np.einsum("tij,uij,tu->ij", cnt, cnt, D) / 2.0 / n_rowpairs

    pen = (n_bad + 0.25 * n_gap * (n_gap < R)) / max(R, 1)
    w_extra = cov_weight * cov - noncanon_penalty * pen
    w_extra = np.where(n_canon > 0, w_extra, -1e30).astype(np.float32)

    # Row-aware pair gate (alipf_fold admits a pair when ANY row pairs,
    # stem_kernel/common/bpmatrix.cpp:355-397): pair type per column pair =
    # the majority canonical row pair, -1 only when NO row pairs.
    pt_major = np.where(n_canon > 0, np.argmax(cnt, axis=0), -1).astype(np.int32)

    prof = profile_from_alignment(aln)
    consensus = np.argmax(prof[:, :4], axis=1).astype(np.uint8)
    return consensus, w_extra, pt_major, code


def alifold_bpps(alignments: list[Alignment], opts: BPMatrixOptions | None = None, *,
                 device) -> list[np.ndarray]:
    """Covariance-scored TRUE-ALIFOLD BPPs (float64, host) of many alignments.

    Hofacker's alipf_fold recipe, the engine the reference reaches at
    stem_kernel/common/bpmatrix.cpp:355-397: every loop energy is evaluated
    PER ROW and averaged across rows (tables._build_luts_averaged), plus the
    per-(i, j) covariance log-weights of :func:`alifold_covariance`; a
    column pair is admissible when ANY row pairs canonically (typed through
    ``pt_override``).  Alignments fold on ``device`` in batches of the
    fixed shape ``_alifold_shape`` gives them: padded with gap columns and
    all-gap rows (they join no averaged entry), on a CUDA device the
    last batch of a shape filled with all-gap dummies of length 0.
    """
    opts = opts or BPMatrixOptions()
    params = opts.resolved_params()
    out: list[np.ndarray | None] = [None] * len(alignments)
    lengths = [a.length for a in alignments]
    shapes: dict[tuple[int, int, int], list[int]] = {}
    for i, a in enumerate(alignments):
        shapes.setdefault(_alifold_shape(a.length, a.n_rows), []).append(i)
    groups = [(shape, members[s: s + shape[0]]) for shape, members in sorted(shapes.items())
              for s in range(0, len(members), shape[0])]
    pad_batch = torch.device(device).type == "cuda"
    for (bsz, rpad, lpad), idxs in groups:
        bsz = bsz if pad_batch else len(idxs)
        rows = np.full((bsz, rpad, lpad), 4, np.int64)
        w_extra = np.zeros((bsz, lpad, lpad), np.float32)
        pt_major = np.full((bsz, lpad, lpad), -1, np.int32)
        lens = np.zeros(bsz, np.int64)
        for b, i in enumerate(idxs):
            _, we, pt, code = alifold_covariance(alignments[i])
            n, r = lengths[i], code.shape[0]
            rows[b, :r, :n] = code
            w_extra[b, :n, :n] = we
            pt_major[b, :n, :n] = pt
            lens[b] = n
        bpps, _ = mccaskill_bpp_batch_scaled(rows, lens, params, w_extra=w_extra,
                                             pt_override=pt_major, device=device)
        host = bpps.cpu().numpy()
        for b, i in enumerate(idxs):
            n = lengths[i]
            out[i] = np.asarray(host[b, :n, :n], dtype=np.float64)
    return out  # type: ignore[return-value]


def alifold_bpp(aln: Alignment, opts: BPMatrixOptions | None = None, *,
                device) -> np.ndarray:
    """The ALIFOLD BPP matrix of one alignment (see :func:`alifold_bpps`)."""
    return alifold_bpps([aln], opts, device=device)[0]
