"""McCaskill partition function + base-pair probabilities, exact, in log space.

Port of ``stem_kernel_tpu/fold/mccaskill.py``, the oracle of the fold
layer: the full Vienna-structured energy model (see fold.params and
fold.tables) evaluated with logaddexp/logsumexp, so no scaling is needed.
It runs in a named dtype (float64 for the oracle, float32 by default as in
the JAX package) on a named device; no CLI reaches it.

- all DP tables live in **span layout** ``T[d, i]`` = value of subsequence
  (i, i+d), so each anti-diagonal of the triangular tables is one row and
  the Python loop over the span d does O(n) to O(n^2) of vector work;
- split-point sums (multiloop segment composition) are gathers over shifted
  rows, the O(n^3) core;
- interior loops enumerate the static (a, b) offset lists bounded by
  ``max_interior`` (Vienna's MAXLOOP), split into Vienna's loop classes
  (generic / 1xn / 2x3 / bulge) with per-class mismatch tables, and
  explicit terms for stack, bulge-1, int11, int21, int22
  (``mccaskill_scaled._interior_offsets``);
- base-pair probabilities come from an **explicit outside pass** (same span
  layout, top-down), keeping memory at O(n^2): reverse-mode autograd
  through the inside loop would store O(n^3) intermediates.

Recursions (log-space; ⊕ = logaddexp; luts from fold.tables):
    Qb[i,j] = wpair[i,j] + ( hairpin[i,j]
                ⊕ stack[i,j] + Qb[i+1,j-1]
                ⊕ bulge1/int11/int21/int22 lut terms
                ⊕ (+)_{class, a,b} pen_cls(a,b) + mm_out_cls[i,j]
                        + mm_in_cls[i+a,j-b] + Qb[i+a,j-b]
                ⊕ ml_close[i,j] + Qm2[i+1,j-1] )
    Qm1[i,j] = (Qm1[i,j-1] + c) ⊕ (ml_stem[i,j] + Qb[i,j])
    Qm2[i,j] = (+)_{t>=1} Qm[i,i+t-1] + Qm1[i+t,j]
    Qm[i,j]  = Qm2[i,j] ⊕ (+)_{t>=0} t*c + Qm1[i+t,j]
    Ql[j]    = Ql[j-1] ⊕ (+)_k Ql[k-1] + Qb[k,j] + ext_stem[k,j]

The gathers are plain torch indexing: slow on the card, and that is
expected of the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from .mccaskill_scaled import _interior_offsets
from .params import EnergyParams, default_params
from .tables import build_luts

NEG = -1e30

_EXPLICIT_TERMS = (
    ("bulge1_l", 3, 2), ("bulge1_r", 3, 1),
    ("int11", 4, 2),
    ("int21_l", 5, 2), ("int21_r", 5, 3),
    ("int22", 6, 3),
)


def _explicit_terms(params):
    """Explicit small-loop lut terms; empty in the fast tier."""
    return () if getattr(params, "fast", False) else _EXPLICIT_TERMS


def _class_lut_names(params):
    """(out, in) mismatch-lut names per loop class; 2 classes in fast."""
    if getattr(params, "fast", False):
        return (("mm_i_out", "term_out"), ("mm_i_in", "term_in"))
    return (("mm_i_out", "mm_1n_out", "mm_23_out", "term_out"),
            ("mm_i_in", "mm_1n_in", "mm_23_in", "term_in"))


def _span_gather(table: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """table[rows, cols] with out-of-range -> NEG.  rows/cols broadcast."""
    rows, cols = torch.broadcast_tensors(rows, cols)
    n = table.shape[-1]
    valid = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    flat = rows.clamp(0, n - 1) * n + cols.clamp(0, n - 1)
    return torch.where(valid, table.reshape(-1)[flat],
                       torch.full((), NEG, dtype=table.dtype, device=table.device))


class _Offsets:
    """The loop-class sweep's static offsets as tensors on one device."""

    def __init__(self, params: EnergyParams, dtype, device):
        ia, ib, ipen, icls = _interior_offsets(params)
        self.ia = torch.as_tensor(ia, device=device).long()
        self.ib = torch.as_tensor(ib, device=device).long()
        self.ipen = torch.as_tensor(ipen, dtype=dtype, device=device)
        self.icls = torch.as_tensor(icls, device=device).long()


def _luts(codes, length, params, w_extra, pt_override, dtype):
    """The LUTs of one sequence (codes (n,)) or alignment (codes (R, n)),
    each (n, n) in ``dtype``."""
    dev = codes.device
    we = None if w_extra is None else torch.as_tensor(w_extra, device=dev)[None]
    po = None if pt_override is None else torch.as_tensor(pt_override, device=dev)[None]
    luts = build_luts(codes[None], torch.as_tensor([length], device=dev), params, we, po)
    return {k: v[0].to(dtype) for k, v in luts.items()}


def _inside(codes, length: int, params: EnergyParams, L: dict, off: _Offsets):
    """Inside pass.  Returns span-layout tables (Qb, QbE, Qm1, Qm, Qm2), the
    external prefixes ql (n+1,) and logZ (0-d)."""
    dev = codes.device
    n = codes.shape[-1]  # codes may be (R, n) alignment rows
    dt = L["wpair"].dtype
    i_idx = torch.arange(n, device=dev)
    t_idx = torch.arange(n, device=dev)  # split offsets
    c_ml = float(params.ml_unpaired)
    negt = torch.full((), NEG, dtype=dt, device=dev)

    def ij_diag(mat, d):
        # mat is [i, j]-layout; return mat[i, i+d] as a vector over i
        return _span_gather(mat, i_idx, i_idx + d)

    # class tables: mm_out rows gathered per step; mm_in folded into shadow
    # copies of Qb (QbX[d, i] = Qb[d, i] + mm_in_cls[i, i+d])
    out_names, in_names = _class_lut_names(params)
    cls_out = [L[nm] for nm in out_names]
    cls_in = [L[nm] for nm in in_names]
    ncls = len(cls_out)

    full = lambda: torch.full((n, n), NEG, dtype=dt, device=dev)  # noqa: E731
    Qb, Qm1, Qm, Qm2 = full(), full(), full(), full()
    qb_cat = torch.full((ncls * n, n), NEG, dtype=dt, device=dev)  # class shadows
    ia, ib, ipen, icls = off.ia, off.ib, off.ipen, off.icls
    cols = i_idx[None, :] + ia[:, None]
    unp_w = c_ml * t_idx[:, None].to(dt)

    for d in range(1, n):
        w_row = ij_diag(L["wpair"], d)
        # hairpin (full lut: length + mismatch/terminal + specials + gates)
        acc = ij_diag(L["hairpin"], d)
        # stack (a=b=1)
        acc = torch.logaddexp(acc, ij_diag(L["stack"], d)
                              + _span_gather(Qb, torch.tensor(d - 2, device=dev), i_idx + 1))
        # explicit small-loop luts: (lut, inner span offset, inner start shift)
        for name, ds, sh in _explicit_terms(params):
            acc = torch.logaddexp(acc, ij_diag(L[name], d)
                                  + _span_gather(Qb, torch.tensor(d - ds, device=dev),
                                                 i_idx + sh))
        # class sweep over (a, b) offsets: gather the class-weighted Qb
        # shadow per offset from one concatenated (ncls*n, n) table
        r2 = (d - (ia + ib))[:, None]
        out_k = torch.stack([ij_diag(cls_out[c], d) for c in range(ncls)], dim=0)
        valid = (r2 >= 0) & (r2 < n) & (cols >= 0) & (cols < n)
        flat = (icls[:, None] * n + r2.clamp(0, n - 1)) * n + cols.clamp(0, n - 1)
        inner = torch.where(valid, qb_cat.reshape(-1)[flat], negt)
        it = ipen[:, None] + out_k[icls] + inner
        acc = torch.logaddexp(acc, torch.logsumexp(it, dim=0))
        # multiloop closing (lut includes a + b + terminal + mismatch + gate)
        ml = ij_diag(L["ml_close"], d) + _span_gather(
            Qm2, torch.tensor(d - 2, device=dev), i_idx + 1)
        acc = torch.logaddexp(acc, ml)

        qb_row = w_row + acc
        # Qm1 incremental; branch lut includes b + terminal + mismatch_m
        qm1_row = torch.logaddexp(Qm1[d - 1] + c_ml, ij_diag(L["ml_stem"], d) + qb_row)
        # split gathers: A[t, i] = Qm1[i+t, i+d] (span d-t)
        A = _span_gather(Qm1, (d - t_idx)[:, None], i_idx[None, :] + t_idx[:, None])
        A[0] = qm1_row  # t = 0 uses this step's fresh row
        # B[t, i] = Qm[i, i+t-1] (span t-1); t = 0 row invalid -> NEG
        B = _span_gather(Qm, (t_idx - 1)[:, None], i_idx[None, :])
        qm2_row = torch.logsumexp(torch.where(t_idx[:, None] >= 1, B + A, negt), dim=0)
        unp = torch.logsumexp(unp_w + A, dim=0)
        qm_row = torch.logaddexp(qm2_row, unp)

        Qb[d] = qb_row
        for c in range(ncls):
            qb_cat[c * n + d] = qb_row + ij_diag(cls_in[c], d)
        Qm1[d] = qm1_row
        Qm[d] = qm_row
        Qm2[d] = qm2_row

    # external chain over prefixes: Ql[j], with Ql[-1] = 0 at index 0
    QbE = Qb + _span_gather(L["ext_stem"], i_idx[None, :],
                            i_idx[None, :] + torch.arange(n, device=dev)[:, None])
    c_ext = float(params.ext_unpaired)
    ql = torch.cat([torch.zeros(1, dtype=dt, device=dev),
                    torch.full((n,), NEG, dtype=dt, device=dev)])
    for j in range(n):
        prev = ql[j]  # Ql[j-1]
        qb_col = _span_gather(QbE, j - i_idx, i_idx)  # QbE[k, j] over k
        paired = torch.logsumexp(ql[:n] + qb_col, dim=0)
        val = torch.logaddexp(prev + c_ext, paired)
        ql[j + 1] = val if j < length else prev
    logZ = ql[length]
    return Qb, QbE, Qm1, Qm, Qm2, ql, logZ


def _outside(codes, length: int, params: EnergyParams, L: dict, off: _Offsets,
             Qb, QbE, Qm1, Qm, Qm2, ql, logZ) -> torch.Tensor:
    """Outside pass: log outside values for Qb, then base-pair probabilities.

    Mirrors the inside recursions in reverse (span looped top-down); each
    outside table receives the derivative flow of every inside use site.
    Finally bpp[i,j] = exp(Qb[i,j] + Ob[i,j] - logZ).
    """
    dev = codes.device
    n = codes.shape[-1]
    dt = Qb.dtype
    i_idx = torch.arange(n, device=dev)
    u_idx = torch.arange(n, device=dev)
    c_ml = float(params.ml_unpaired)
    negt = torch.full((), NEG, dtype=dt, device=dev)

    out_names, in_names = _class_lut_names(params)
    cls_out = [L[nm] for nm in out_names]
    cls_in = [L[nm] for nm in in_names]
    ncls = len(cls_out)
    out_cat = torch.cat(cls_out, dim=0)  # (ncls*n, n) [i, j]
    ia, ib, ipen, icls = off.ia, off.ib, off.ipen, off.icls

    # --- outside of the external chain: OQl[j] over j ---
    c_ext = float(params.ext_unpaired)
    oql = torch.full((n,), NEG, dtype=dt, device=dev)
    for j in range(n - 1, -1, -1):
        unpaired = oql[min(j + 1, n - 1)] if j + 1 < length else negt
        # pairs (j+1, l): QbE[j+1, l] = QbE_span[l-(j+1), j+1]
        qb_vec = _span_gather(QbE, u_idx - (j + 1), torch.tensor(j + 1, device=dev))
        paired = torch.logsumexp(qb_vec + oql, dim=0)
        val = torch.logaddexp(unpaired + c_ext, paired)
        if j == length - 1:
            val = torch.zeros((), dtype=dt, device=dev)
        elif j > length - 1:
            val = negt
        oql[j] = val

    Ob, Om1, Om, Om2 = (torch.full((n, n), NEG, dtype=dt, device=dev) for _ in range(4))
    ql_i = ql[i_idx]
    uc = c_ml * u_idx[:, None].to(dt)
    for D in range(n - 1, 0, -1):
        j = i_idx + D  # right end per start i
        dD = torch.tensor(D, device=dev)

        # --- Om[D][i]: from Qm2 splits with left part Qm[i, i+D] ---
        A2 = (_span_gather(Qm1, (u_idx - D - 1)[:, None], (i_idx + D + 1)[None, :])
              + _span_gather(Om2, u_idx[:, None], i_idx[None, :]))
        om_row = torch.logsumexp(torch.where(u_idx[:, None] > D, A2, negt), dim=0)
        Om[D] = om_row

        # --- Om2[D][i]: multiloop closing by pair (i-1, j+1); plus Qm flow ---
        close = (_span_gather(Ob, dD + 2, i_idx - 1)  # Ob_span[D+2, i-1]
                 + _span_gather(L["wpair"], i_idx - 1, j + 1)
                 + _span_gather(L["ml_close"], i_idx - 1, j + 1))
        Om2[D] = torch.logaddexp(close, om_row)

        # --- Om1[D][i] ---
        inc = Om1[min(D + 1, n - 1)] + c_ml if D + 1 < n else negt.expand(n)
        # (b) split right part: t >= 1: Qm[t-1, i-t] + Om2[D+t, i-t]
        Tb = (_span_gather(Qm, (u_idx - 1)[:, None], i_idx[None, :] - u_idx[:, None])
              + _span_gather(Om2, (D + u_idx)[:, None], i_idx[None, :] - u_idx[:, None]))
        term_b = torch.logsumexp(torch.where(u_idx[:, None] >= 1, Tb, negt), dim=0)
        # (c) unpaired prefix: t >= 0: c*t + Om[D+t, i-t]
        Tc = uc + _span_gather(Om, (D + u_idx)[:, None], i_idx[None, :] - u_idx[:, None])
        term_c = torch.logsumexp(Tc, dim=0)
        om1_row = torch.logaddexp(torch.logaddexp(inc, term_b), term_c)
        Om1[D] = om1_row

        # --- Ob[D][i] ---
        # exterior: Ql[i-1] + OQl[j] + ext_stem[i, j]
        ext = (ql_i + torch.where(j < n, oql[j.clamp(0, n - 1)], negt)
               + _span_gather(L["ext_stem"], i_idx, j))
        # stack as inner pair of (i-1, j+1)
        stk = (_span_gather(Ob, dD + 2, i_idx - 1)
               + _span_gather(L["wpair"], i_idx - 1, j + 1)
               + _span_gather(L["stack"], i_idx - 1, j + 1))
        acc = torch.logaddexp(ext, stk)
        # explicit small-loop luts as inner pair of (i-sh, j+(ds-sh))
        for name, ds, sh in _explicit_terms(params):
            t = (_span_gather(Ob, dD + ds, i_idx - sh)
                 + _span_gather(L["wpair"], i_idx - sh, j + (ds - sh))
                 + _span_gather(L[name], i_idx - sh, j + (ds - sh)))
            acc = torch.logaddexp(acc, t)
        # class sweep as inner pair of (i-a, j+b); add this pair's mm_in after
        ro = i_idx[None, :] - ia[:, None]
        co = j[None, :] + ib[:, None]
        valid_o = (ro >= 0) & (ro < n) & (co >= 0) & (co < n)
        flat_o = (icls[:, None] * n + ro.clamp(0, n - 1)) * n + co.clamp(0, n - 1)
        out_lut = torch.where(valid_o, out_cat.reshape(-1)[flat_o], negt)
        it = (ipen[:, None] + _span_gather(Ob, (D + ia + ib)[:, None], ro)
              + _span_gather(L["wpair"], ro, co) + out_lut)
        in_sel = torch.stack([_span_gather(cls_in[c], i_idx, j) for c in range(ncls)], dim=0)
        acc = torch.logaddexp(acc, torch.logsumexp(it + in_sel[icls], dim=0))
        # multiloop branch entry (lut includes b + terminal + mismatch)
        acc = torch.logaddexp(acc, _span_gather(L["ml_stem"], i_idx, j) + om1_row)
        Ob[D] = acc

    # bpp in [i, j] layout
    dgrid = i_idx[None, :] - i_idx[:, None]  # j - i
    starts = i_idx[:, None].expand(n, n)
    qb_ij = _span_gather(Qb, dgrid, starts)
    ob_ij = _span_gather(Ob, dgrid, starts)
    return torch.where(dgrid > 0, torch.exp(qb_ij + ob_ij - logZ),
                       torch.zeros((), dtype=dt, device=dev))


def _prepare(seq_codes, length, params, w_extra, pt_override, dtype, device):
    params = params or default_params()
    codes = torch.as_tensor(np.asarray(seq_codes, np.int64), device=device)
    length = int(codes.shape[-1] if length is None else length)
    L = _luts(codes, length, params, w_extra, pt_override, dtype)
    return params, codes, length, L, _Offsets(params, dtype, device)


def mccaskill_logZ(
    seq_codes: np.ndarray,
    length: int | None = None,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    dtype=torch.float32,
    device,
) -> float:
    """Log partition function of one sequence (codes in A,C,G,U=0..3) or
    alignment-row matrix (R, n), computed on ``device`` in ``dtype``."""
    params, codes, length, L, off = _prepare(seq_codes, length, params, w_extra,
                                             pt_override, dtype, device)
    with torch.no_grad():
        *_, logZ = _inside(codes, length, params, L, off)
    return float(logZ)


def mccaskill_bpp(
    seq_codes: np.ndarray,
    length: int | None = None,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    dtype=torch.float32,
    device,
) -> tuple[np.ndarray, float]:
    """(bpp, logZ) for one sequence; bpp[i, j] = P(i pairs j), i < j, 0-based.

    The replacement for Vienna pf_fold + pr-matrix extraction
    (stem_kernel/common/bpmatrix.cpp:166-174, common/pf_wrapper.cpp:15-36),
    computed on ``device`` in ``dtype``; bpp comes back as a host array.
    """
    params, codes, length, L, off = _prepare(seq_codes, length, params, w_extra,
                                             pt_override, dtype, device)
    with torch.no_grad():
        ins = _inside(codes, length, params, L, off)
        bpp = _outside(codes, length, params, L, off, *ins)
    return bpp.cpu().numpy(), float(ins[-1])


def mccaskill_bpp_batch(
    codes_batch: np.ndarray,
    lengths: np.ndarray,
    params: EnergyParams | None = None,
    *,
    dtype=torch.float32,
    engine: str = "scaled",
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (bpp (B, n, n), logZ (B,)) tensors on ``device`` over padded
    code arrays (B, n).

    ``engine="scaled"`` (default) runs the whole batch through the scaled
    linear-domain engine (:mod:`.mccaskill_scaled`, always f32).
    ``engine="log"`` runs this exact log-space oracle example by example in
    ``dtype``.
    """
    params = params or default_params()
    if engine == "scaled":
        from .mccaskill_scaled import mccaskill_bpp_batch_scaled

        return mccaskill_bpp_batch_scaled(codes_batch, lengths, params, device=device)
    if engine != "log":
        raise ValueError(f"engine must be 'scaled' or 'log', got {engine!r}")
    codes_np = np.asarray(codes_batch)
    lengths = np.asarray(lengths)
    off = _Offsets(params, dtype, device)
    bpps, zs = [], []
    with torch.no_grad():
        for b in range(codes_np.shape[0]):
            c = torch.as_tensor(codes_np[b].astype(np.int64), device=device)
            ln = int(lengths[b])
            L = _luts(c, ln, params, None, None, dtype)
            ins = _inside(c, ln, params, L, off)
            bpps.append(_outside(c, ln, params, L, off, *ins))
            zs.append(ins[-1])
    return torch.stack(bpps), torch.stack(zs)
