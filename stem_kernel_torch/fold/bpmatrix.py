"""BPP matrices for alignments: fold-and-average, the BPMatrix facade.

Port of ``stem_kernel_tpu/fold/bpmatrix.py`` (the reference's BPMatrix layer,
stem_kernel/common/bpmatrix.{h,cpp}).  FOLD runs the scaled McCaskill
engine on every ungapped row and averages the matrices over alignment
columns (average_matrix, bpmatrix.cpp:306-342).  Sequences are folded in
batches of similar length, each padded to its own longest member.  The
ALIFOLD, SFOLD (sampling) and CONTRAfold paths are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.alphabet import encode
from ..io.profile import Alignment, index_map
from .mccaskill_scaled import mccaskill_bpp_batch_scaled
from .params import EnergyParams, default_params

# a fold batch holds at most this many padded (n x n) table cells: the
# engine's memory is O(B n^2); a batch is never smaller than one sequence
MAX_BATCH_CELLS = 1 << 24


@dataclass
class BPMatrixOptions:
    """Folding options (BPMatrix::Options, common/bpmatrix.cpp:45-93)."""

    alifold: bool = False
    n_samples: int = 0  # >0 -> stochastic sampling (SFOLD), not yet ported
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


def fold_sequences(seqs: list[str], opts: BPMatrixOptions | None = None, *,
                   device) -> list[np.ndarray]:
    """BPP matrix (float64, host) per ungapped sequence, folded on ``device``."""
    opts = opts or BPMatrixOptions()
    if opts.n_samples > 0:
        raise NotImplementedError("SFOLD (stochastic sampling) is not yet ported")
    params = opts.resolved_params()
    codes_all = [encode(s) for s in seqs]
    out: list[np.ndarray | None] = [None] * len(seqs)
    for idxs in _length_groups([len(c) for c in codes_all]):
        lpad = max(1, max(len(codes_all[i]) for i in idxs))
        codes = np.zeros((len(idxs), lpad), np.uint8)
        lens = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            codes[r, : len(codes_all[i])] = codes_all[i]
            lens[r] = len(codes_all[i])
        bpps, _ = mccaskill_bpp_batch_scaled(codes, lens, params, device=device)
        host = bpps.cpu().numpy()
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
    """BPP matrices for many alignments, folding all rows in shared batches."""
    opts = opts or BPMatrixOptions()
    if opts.alifold:
        raise NotImplementedError("alifold (consensus folding) is not yet ported")
    flat: list[str] = []
    spans: list[tuple[int, int]] = []
    for a in alignments:
        rows = a.ungapped_rows()
        spans.append((len(flat), len(rows)))
        flat.extend(rows)
    all_bpps = fold_sequences(flat, opts, device=device)
    return [average_bpp(a, all_bpps[start: start + cnt]) for a, (start, cnt) in
            zip(alignments, spans)]
