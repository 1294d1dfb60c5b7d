# Frozen copy of stem_kernel_torch/fold/tables.py for skbench's plain reference:
# the reference imports nothing of the program.
"""Sequence-indexed energy lookup tables for the scaled McCaskill engine.

Port of ``stem_kernel_tpu/fold/tables.py:build_luts`` with an explicit batch
axis: every (n, n) log-score LUT of a batch of sequences, as (B, n, n)
float64 tensors in [i, j] layout (j = partner column).  The engine casts
them to f32.  Impossible entries are NEG (finite, so f32 arithmetic never
produces NaN from inf - inf).

Table semantics (Vienna loop-energy structure, see fold.params):
  wpair        pair admissibility + per-pair bonus + optional extra weight
  stack        helix stacking, outer (i,j) over inner (i+1, j-1)
  hairpin      FULL hairpin score for closing pair (i, j): length term +
               (size 3: terminal-AU; size > 3: mismatch_h) + special
               tri/tetra/hexaloop total-score overrides + closing-GU gate
  bulge1_l/r   bulge of size 1 (left/right): length + stacking of the two
               pairs
  int11/21l/21r/22
               special small-interior tables, inner pair position fixed
  mm_i_out     generic-interior mismatch of the OUTER pair; *_in of the
               inner pair (reversed orientation); same for i1n / i23
  term_out/in  terminal-AU factors for bulges >= 2
  ml_close     multiloop closing-stem score: a + b + terminal + mismatch_m
               (reversed, looking into the loop) + closing-GU gate
  ml_stem      multiloop branch: b + terminal + mismatch_m (d2)
  ext_stem     exterior branch: terminal + mismatch_e / dangle5 / dangle3
               depending on neighbor existence (d2)

(B, R, n) alignment rows switch to per-row LUTs averaged over the rows
(``_build_luts_averaged``, the alifold path).
"""

from __future__ import annotations

import numpy as np
import torch

from .params import EnergyParams, PAIR_TYPE, REV_PAIR, hairpin_score

NEG = -1e30
DT = torch.float64


def _f(x, device) -> torch.Tensor:
    """A float64 table with -inf sanitized to NEG."""
    return torch.as_tensor(np.maximum(np.asarray(x, np.float64), NEG), device=device)


def build_luts(codes: torch.Tensor, length: torch.Tensor, params: EnergyParams,
               w_extra: torch.Tensor | None = None,
               pt_override: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """All (B, n, n) log-score LUTs for a batch of sequences.

    ``codes``: (B, n) integer codes (A, C, G, U = 0..3); ``length``: (B,).
    ``w_extra``: optional (B, n, n) extra log-weight added to every
    admissible pair.  ``pt_override``: optional (B, n, n) pair types (-1 =
    cannot pair) replacing the code-derived types — the row-aware ALIFOLD
    gate types a column pair by its majority canonical row pair.

    ``codes`` of shape (B, R, n) are alignment rows (gap/unknown >= 4) and
    switch to per-row energies averaged over the rows — see
    :func:`_build_luts_averaged`.
    """
    if codes.ndim == 3:
        return _build_luts_averaged(codes, length, params, w_extra, pt_override)
    dev = codes.device
    codes = codes.long()
    bsz, n = codes.shape
    ii = torch.arange(n, device=dev)
    dmat = (ii[None, :] - ii[:, None])[None]  # (1, n, n): j - i
    length = length.to(dev).long()

    if pt_override is None:
        PT = torch.as_tensor(PAIR_TYPE, device=dev).long()
        pt_full = PT[codes[:, :, None], codes[:, None, :]]
    else:
        pt_full = pt_override.to(dev).long()
    pt = pt_full
    if params.no_gu:
        pt = torch.where((pt == 2) | (pt == 3), -1, pt)
    in_len = ii[None, None, :] < length[:, None, None]
    can = (pt >= 0) & (dmat > params.min_hairpin) & in_len

    def shift2(m, di, dj):
        return torch.roll(torch.roll(m, -di, dims=1), -dj, dims=2)

    if params.no_lonely_pairs:
        # Vienna's pf noLP heuristic: (i, j) may pair only when it can stack
        # with a canonical neighbour pair (i+1, j-1) or (i-1, j+1).
        inner_ok = shift2(can, 1, -1) & (dmat > params.min_hairpin + 2)
        outer_pt = shift2(pt_full, -1, 1)  # pair type of (i-1, j+1)
        outer_ok = ((outer_pt >= 0) & (ii[None, :, None] >= 1)
                    & (ii[None, None, :] + 1 < length[:, None, None]))
        can = can & (inner_ok | outer_ok)

    negt = torch.tensor(NEG, dtype=DT, device=dev)
    bonus = _f(params.pair_bonus, dev)
    ptc = pt.clamp(min=0)
    wpair = torch.where(can, bonus[ptc], negt)
    if w_extra is not None:
        wpair = torch.where(can, wpair + w_extra.to(dev, DT), negt)

    rev = torch.as_tensor(REV_PAIR, device=dev).long()
    is_gu = (pt == 2) | (pt == 3)
    gu_gate = torch.where(is_gu & bool(params.no_closing_gu), negt,
                          torch.zeros((), dtype=DT, device=dev))

    # neighbour codes (clipped reads; validity comes from pair gating)
    c_ip1 = codes[:, (ii + 1).clamp(0, n - 1)]  # s[i+1]
    c_ip2 = codes[:, (ii + 2).clamp(0, n - 1)]
    c_im1 = codes[:, (ii - 1).clamp(min=0)]
    c_jm1 = c_im1  # s[j-1] uses the same shifted vector indexed by j
    c_jm2 = codes[:, (ii - 2).clamp(min=0)]
    c_jp1 = c_ip1
    row = lambda c: c[:, :, None]  # noqa: E731  indexed by i
    col = lambda c: c[:, None, :]  # noqa: E731  indexed by j

    def pair_at(di: int, dj: int):
        """Pair type of (i+di, j+dj) on the (i, j) grid, -1 out of range."""
        t = shift2(pt_full, di, dj)
        valid = (((ii + di)[:, None] >= 0) & ((ii + dj)[None, :] < n)
                 & ((ii + di)[:, None] < n) & ((ii + dj)[None, :] >= 0))
        return torch.where(valid[None], t, -1)

    # ---- stacking (outer (i,j) / inner (i+1, j-1)) ----
    stack_tab = _f(params.stack, dev)
    pt_in = pair_at(1, -1)
    stack = torch.where((pt >= 0) & (pt_in >= 0),
                        stack_tab[ptc, pt_in.clamp(min=0)], negt)

    # ---- hairpin (full score per closing pair) ----
    sizes = dmat - 1
    hp_len_np = hairpin_score(params, np.arange(max(2 * n, 32)))
    hp_len = _f(hp_len_np, dev)[sizes.clamp(min=0)]
    mm_h = _f(params.mismatch_h, dev)[ptc, row(c_ip1), col(c_jm1)]
    term = _f(params.terminal, dev)[ptc]
    if params.mismatch_all_hairpins:  # CONTRAfold: mismatch at every size
        hp_mm = mm_h
    else:
        hp_mm = torch.where(sizes == params.min_hairpin, term, mm_h)
    hairpin = hp_len + hp_mm + gu_gate
    # special loops override the whole score (length+mismatch), keeping gates
    if params.special_hairpins:
        hairpin = _apply_special_hairpins(hairpin, codes, params, gu_gate)
    hairpin = torch.where(can, hairpin.clamp(min=NEG), negt)

    # ---- bulge-1 (Vienna: keeps stacking; CONTRAfold: helix closings +
    #      bulged-base identity instead) ----
    blen1 = float(np.maximum(params.bulge_len[1], NEG))
    b1nuc = (torch.zeros((4,), dtype=DT, device=dev) if params.bulge1_nuc is None
             else _f(params.bulge1_nuc, dev))
    term_v = _f(params.terminal, dev)

    def bulge1_score(pt_inner, bulged_base):
        if params.bulge1_no_stack:
            pair_part = term_v[ptc] + term_v[pt_inner.clamp(min=0)]
        else:
            pair_part = stack_tab[ptc, pt_inner.clamp(min=0)]
        return blen1 + pair_part + b1nuc[bulged_base]

    pt_b1l = pair_at(2, -1)  # inner (i+2, j-1); bulged base s[i+1]
    bulge1_l = torch.where((pt >= 0) & (pt_b1l >= 0),
                           bulge1_score(pt_b1l, row(c_ip1)), negt)
    pt_b1r = pair_at(1, -2)  # inner (i+1, j-2); bulged base s[j-1]
    bulge1_r = torch.where((pt >= 0) & (pt_b1r >= 0),
                           bulge1_score(pt_b1r, col(c_jm1)), negt)

    # ---- special small interiors ----
    def rev_at(di, dj):
        t = pair_at(di, dj)
        return torch.where(t >= 0, rev[t.clamp(min=0)], -1), t

    ok = pt >= 0
    r11, t11 = rev_at(2, -2)
    int11 = torch.where(ok & (t11 >= 0), _f(params.int11, dev)[
        ptc, r11.clamp(min=0), row(c_ip1), col(c_jm1)], negt)
    # 1x2: inner (i+2, j-3); Vienna int21[type][type_2][si1][sq1][sj1]
    r21l, t21l = rev_at(2, -3)
    int21_l = torch.where(ok & (t21l >= 0), _f(params.int21, dev)[
        ptc, r21l.clamp(min=0), row(c_ip1), col(c_jm2), col(c_jm1)], negt)
    # 2x1: inner (i+3, j-2); Vienna int21[type_2][type][sq1][si1][sp1]
    r21r, t21r = rev_at(3, -2)
    int21_r = torch.where(ok & (t21r >= 0), _f(params.int21, dev)[
        r21r.clamp(min=0), ptc, col(c_jm1), row(c_ip1), row(c_ip2)], negt)
    # 2x2: inner (i+3, j-3); int22[type][type_2][si1][sp1][sq1][sj1]
    r22, t22 = rev_at(3, -3)
    int22 = torch.where(ok & (t22 >= 0), _f(params.int22, dev)[
        ptc, r22.clamp(min=0), row(c_ip1), row(c_ip2), col(c_jm2), col(c_jm1)], negt)

    # ---- interior mismatch factors (outer on (i,j); inner reversed) ----
    def mm_pair(tab):
        t = _f(tab, dev)
        out = torch.where(ok, t[ptc, row(c_ip1), col(c_jm1)], negt)
        # inner factor for pair (k, l): reversed type, neighbours s[l+1], s[k-1]
        inner = torch.where(ok, t[rev[ptc], col(c_jp1), row(c_im1)], negt)
        return out, inner

    mm_i_out, mm_i_in = mm_pair(params.mismatch_i)
    mm_1n_out, mm_1n_in = mm_pair(params.mismatch_i1n)
    mm_23_out, mm_23_in = mm_pair(params.mismatch_i23)

    term_out = torch.where(ok, term, negt)  # bulges >= 2: terminal both ends
    term_in = term_out  # terminal depends only on pair class (symmetric)

    # ---- multiloop stems (dangle model d2) ----
    mm_m = _f(params.mismatch_m, dev)
    # closing stem looks INTO the loop: reversed type, neighbours s[j-1], s[i+1]
    ml_close = torch.where(
        ok, params.ml_close + params.ml_branch + term
        + mm_m[rev[ptc], col(c_jm1), row(c_ip1)] + gu_gate, negt)
    # branch stem (k, l): neighbours s[k-1], s[l+1] (always inside the loop)
    ml_stem = torch.where(
        ok, params.ml_branch + term + mm_m[ptc, row(c_im1), col(c_jp1)], negt)

    # ---- exterior stems: mismatch_e / dangles depending on neighbours ----
    mm_e = _f(params.mismatch_e, dev)
    d5 = _f(params.dangle5, dev)[ptc, row(c_im1)]
    d3 = _f(params.dangle3, dev)[ptc, col(c_jp1)]
    both = mm_e[ptc, row(c_im1), col(c_jp1)]
    has5 = (ii[None, :, None] >= 1).expand(bsz, n, n)
    has3 = (ii[None, None, :] + 1 < length[:, None, None]).expand(bsz, n, n)
    zero = torch.zeros((), dtype=DT, device=dev)
    dang = torch.where(has5 & has3, both,
                       torch.where(has5, d5, torch.where(has3, d3, zero)))
    ext_stem = torch.where(ok, term + dang + params.ext_paired, negt)

    return dict(
        wpair=wpair, stack=stack, hairpin=hairpin,
        bulge1_l=bulge1_l, bulge1_r=bulge1_r,
        int11=int11, int21_l=int21_l, int21_r=int21_r, int22=int22,
        mm_i_out=mm_i_out, mm_i_in=mm_i_in,
        mm_1n_out=mm_1n_out, mm_1n_in=mm_1n_in,
        mm_23_out=mm_23_out, mm_23_in=mm_23_in,
        term_out=term_out, term_in=term_in,
        ml_close=ml_close, ml_stem=ml_stem, ext_stem=ext_stem,
    )


def _apply_special_hairpins(hairpin, codes, params: EnergyParams, gu_gate):
    """Override hairpin scores for special tri/tetra/hexaloops.

    Vienna stores specials as <closing 5' base><loop><closing 3' base>
    strings whose energy REPLACES the length+mismatch score entirely.
    """
    dev = codes.device
    bsz, n = codes.shape
    ii = torch.arange(n, device=dev)
    out = hairpin
    by_size: dict[int, list[tuple[np.ndarray, float]]] = {}
    for seq, score in params.special_hairpins.items():
        size = len(seq) - 2  # loop size without the closing pair
        if size <= 0:
            continue
        enc = np.asarray([_code_of(ch) for ch in seq], np.int64)
        if (enc < 0).any():
            continue
        by_size.setdefault(size, []).append((enc, float(score)))
    for size, entries in by_size.items():
        span = size + 1  # j - i
        # window of codes starting at i, length size + 2: (B, n, size+2)
        win = torch.stack(
            [codes[:, (ii + k).clamp(0, n - 1)] for k in range(size + 2)], dim=2)
        valid = (ii + size + 1 < n)[None]
        score_vec = torch.full((bsz, n), NEG, dtype=DT, device=dev)
        for enc, sc in entries:
            hit = (win == torch.as_tensor(enc, device=dev)[None, None]).all(dim=2) & valid
            score_vec = torch.where(hit, torch.tensor(sc, dtype=DT, device=dev), score_vec)
        # scatter onto the diagonal j = i + span (gates still apply)
        on_diag = ((ii[None, :] - ii[:, None]) == span)[None]
        out = torch.where(on_diag & (score_vec[:, :, None] > NEG / 2),
                          score_vec[:, :, None] + gu_gate, out)
    return out


def _code_of(ch: str) -> int:
    return {"A": 0, "C": 1, "G": 2, "U": 3, "T": 3}.get(ch.upper(), -1)


def _build_luts_averaged(rows: torch.Tensor, length: torch.Tensor, params: EnergyParams,
                         w_extra: torch.Tensor | None = None,
                         pt_override: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """True-alifold LUTs: per-row energies, averaged across alignment rows.

    ``rows``: (B, R, n) codes, gap/unknown >= 4; ``length``: (B,) alignment
    lengths.  Vienna's alipf_fold (reached by the reference at
    stem_kernel/common/bpmatrix.cpp:355-397) evaluates every loop energy PER
    SEQUENCE and Boltzmann-weights the average over rows (Hofacker 2002).
    Here each row gets its own full LUT set (its own pair types, stacks,
    mismatches, dangles), and every table entry is the masked mean over the
    rows for which it is defined.

    Documented deviations from alipf_fold (the reference package's, kept):
    - loop SIZES are measured in alignment columns for every row;
    - rows that cannot form a canonical pair at (i, j) are excluded from
      that entry's average; the covariance term's non-canonical penalty
      (``w_extra`` from bpmatrix.alifold_covariance) carries that penalty;
    - gapped NEIGHBOUR positions are imputed with the column consensus (the
      first most frequent base) for mismatch/dangle lookups.

    All-gap rows contribute to no entry, so alignments of different depths
    can share one (R, n) pad shape (the sums over R may round differently
    with R).
    """
    dev = rows.device
    rows = rows.long()
    bsz, nrow, n = rows.shape
    gap = rows >= 4
    onehot = (rows[..., None] == torch.arange(4, device=dev)) & ~gap[..., None]
    consensus = onehot.sum(dim=1).argmax(dim=-1)  # (B, n): first maximum
    filled = torch.where(gap, consensus[:, None, :], rows.clamp(0, 3))
    PT = torch.as_tensor(PAIR_TYPE, device=dev).long()
    rc = rows.clamp(0, 3)
    pt_r = PT[rc[..., :, None], rc[..., None, :]]
    pt_r = torch.where(gap[..., :, None] | gap[..., None, :], -1, pt_r)

    flat_len = length.to(dev).long().repeat_interleave(nrow)
    luts_r = build_luts(filled.reshape(bsz * nrow, n), flat_len, params, None,
                        pt_override=pt_r.reshape(bsz * nrow, n, n))

    negt = torch.tensor(NEG, dtype=DT, device=dev)
    out: dict[str, torch.Tensor] = {}
    for k, v in luts_r.items():
        v = v.reshape(bsz, nrow, n, n)
        valid = v > NEG / 2
        cnt = valid.sum(dim=1)
        s = torch.where(valid, v, torch.zeros((), dtype=DT, device=dev)).sum(dim=1)
        out[k] = torch.where(cnt > 0, s / cnt.clamp(min=1), negt)

    wp = out["wpair"]
    if w_extra is not None:
        wp = torch.where(wp > NEG / 2, wp + w_extra.to(dev, DT), negt)
    if pt_override is not None:
        # row-aware admissibility gate (majority pair type, -1 = no row pairs)
        wp = torch.where(pt_override.to(dev) >= 0, wp, negt)
    out["wpair"] = wp
    return out
