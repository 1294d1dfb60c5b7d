"""Scaled linear-domain McCaskill engine, batched in torch (f32).

Port of ``stem_kernel_tpu/fold/mccaskill_scaled.py``: the same
Vienna-structured model and recursions, with the batch written out where
the JAX package used ``vmap`` and each ``lax.scan`` over spans written as a
Python loop over the span length d.

- **linear (exp) domain with per-span rescaling**: every DP row (one span
  length d across all starts i) is renormalized to max 1.0 and its log scale
  accumulated in ``mu[d]`` — Vienna's ``pf_scale`` done exactly, per row.
- **reversed row buffers**: rows are stored at ``n-1-d`` so "all spans below
  d" is one contiguous slab; with Python-int d every read is a view.
- **interior loops as one matmul per loop class**: the (a, b) offset double
  sum is an (A, C) @ (C, n) product against exp(penalty) kernels followed by
  a pad-reshape skew sum.  Stack / bulge-1 / int11 / int21 / int22 are
  explicit shifted-row terms with their own LUT rows.
- **multiloop split sums as slab reductions**.

State is updated in place (the JAX version is functional); each step reads
everything it needs before it writes its row.  All DP arithmetic is f32; the
LUTs are built in f64 and cast once.  Terms more than ~87 log units below a
row's dominant contribution underflow, as in the reference engine.

:func:`mccaskill_bpp_batch_scaled` routes by device: CPU tensors run these
loops (:func:`mccaskill_bpp_batch_scaled_reference`, the plain version);
on the card the whole DP of a batch is one launch of the fold DP kernel
(``ops/fold_dp.py``, ``csrc/fold_dp.cu``), which reads the same LUTs
(:func:`_kernel_tables`), gives these loops' bits on the card and raises
where it cannot run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fold_dp
from .params import EnergyParams, default_params, loop_len_score
from .tables import build_luts

NEG = -1e30
TINY = 1e-38
DT = torch.float32

# explicit small-loop terms: (lut name, inner span offset, inner start shift)
_EXPLICIT = (
    ("bulge1_l", 3, 2), ("bulge1_r", 3, 1),
    ("int11", 4, 2),
    ("int21_l", 5, 2), ("int21_r", 5, 3),
    ("int22", 6, 3),
)
_CLS_OUT = ("mm_i_out", "mm_1n_out", "mm_23_out", "term_out")
_CLS_IN = ("mm_i_in", "mm_1n_in", "mm_23_in", "term_in")
# fast tier: 2 classes (generic interior, bulge), no explicit small-loop luts
_CLS_OUT_FAST = ("mm_i_out", "term_out")
_CLS_IN_FAST = ("mm_i_in", "term_in")
_CLS_GEN, _CLS_1N, _CLS_23, _CLS_BUL = 0, 1, 2, 3


def _cls_names(params) -> tuple[tuple[str, ...], tuple[str, ...]]:
    if getattr(params, "fast", False):
        return _CLS_OUT_FAST, _CLS_IN_FAST
    return _CLS_OUT, _CLS_IN


def _expl_terms(params):
    return () if getattr(params, "fast", False) else _EXPLICIT


def _interior_offsets(params: EnergyParams):
    """Static (a, b, penalty, class) offset lists for the loop-class sweep.

    Covers every interior/bulge with a lut-free penalty: generic, 1xn, 2x3
    and bulges >= 2.  Stack/bulge-1/int11/int21/int22 are explicit lut terms.
    (Copy of ``stem_kernel_tpu/fold/mccaskill.py:_interior_offsets``.)
    """
    offs, pens, clss = [], [], []
    fast = getattr(params, "fast", False)
    for a in range(1, params.max_interior + 2):
        for b in range(1, params.max_interior + 2):
            n1, n2 = a - 1, b - 1
            if n1 + n2 > params.max_interior:
                continue
            ns, nl = min(n1, n2), max(n1, n2)
            if nl == 0:
                continue  # stack: always an explicit lut term
            if not fast and (ns >= 1 and nl <= 2 and ns <= 2 and (ns, nl) in (
                    (1, 1), (1, 2), (2, 2))):
                continue  # int11 / int21 / int22: explicit luts (full model)
            if ns == 0:
                if nl == 1 and not fast:
                    continue  # bulge-1: explicit lut (keeps stacking)
                # fast tier: bulge-1 rides the generic bulge length table
                pen = float(loop_len_score(params.bulge_len, params.lxc, nl))
                cls = 1 if fast else _CLS_BUL
            elif fast:
                # fast tier: ONE interior class (generic mismatch) with the
                # generic length + NINIO asymmetry formula for every loop
                asym = max(params.ninio * (nl - ns), params.ninio_max)
                if params.interior_asym_table is not None:
                    at = params.interior_asym_table
                    asym = float(at[min(nl - ns, len(at) - 1)])
                pen = float(
                    loop_len_score(params.interior_len, params.lxc, ns + nl)
                ) + asym
                cls = 0
            else:
                if params.interior_asym_table is not None:
                    at = params.interior_asym_table
                    asym = float(at[min(nl - ns, len(at) - 1)])
                else:
                    asym = max(params.ninio * (nl - ns), params.ninio_max)
                pen = float(
                    loop_len_score(params.interior_len, params.lxc, ns + nl)
                ) + asym
                if (params.interior_explicit is not None
                        and ns <= 4 and nl <= 4):
                    pen = float(params.interior_explicit[ns, nl])
                if ns == 1:  # nl >= 3 here
                    cls = _CLS_1N
                elif ns == 2 and nl == 3:
                    cls = _CLS_23
                else:
                    cls = _CLS_GEN
            offs.append((a, b))
            pens.append(pen)
            clss.append(cls)
    offs = np.asarray(offs, dtype=np.int32)
    return (offs[:, 0], offs[:, 1], np.asarray(pens),
            np.asarray(clss, dtype=np.int32))


def _class_kernels(params: EnergyParams) -> list[np.ndarray]:
    """One exp(penalty) kernel per loop class, K[c, a] with c = a + b."""
    cdim = params.max_interior + 3
    n_cls = 2 if getattr(params, "fast", False) else 4
    ks = [np.zeros((cdim, cdim), dtype=np.float64) for _ in range(n_cls)]
    ia, ib, ipen, icls = _interior_offsets(params)
    for a, b, pen, cls in zip(ia, ib, ipen, icls):
        ks[cls][a + b, a] = np.exp(pen)
    return ks


def _shift_left(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = v[..., i+k] with zero fill."""
    n = v.shape[-1]
    out = torch.zeros_like(v)
    if k < n:
        out[..., : n - k] = v[..., k:]
    return out


def _shift_right(v: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = v[..., i-k] with zero fill."""
    n = v.shape[-1]
    out = torch.zeros_like(v)
    if k < n:
        out[..., k:] = v[..., : n - k]
    return out


def _skew_sum(c: torch.Tensor) -> torch.Tensor:
    """(B, m, n) -> (B, n): out[i] = sum_t C[t, i - t] (zero outside)."""
    bsz, m, n = c.shape
    cp = torch.nn.functional.pad(c, (0, m))  # (B, m, n + m)
    flat = cp.reshape(bsz, -1)[:, : m * (n + m - 1)]
    sk = flat.reshape(bsz, m, n + m - 1)  # sk[t, y] = C[t, y - t]
    return sk.sum(dim=1)[:, :n]


def _conv_rows(slab: torch.Tensor, kernel: torch.Tensor, flip: bool) -> torch.Tensor:
    """out[i] = sum_{c,a} slab[c, i + a] K[c, a]   (flip=False)
       out[i] = sum_{c,a} slab[c, i - a] K[c, a]   (flip=True)
    slab: (B, C, n), kernel: (C, A) -> (B, n)."""
    w = torch.matmul(kernel.transpose(0, 1), slab)  # (B, A, n)
    if flip:
        return _skew_sum(w)
    return _skew_sum(w.flip(-1)).flip(-1)


def _skew_ij_to_span(m: torch.Tensor, fill: float) -> torch.Tensor:
    """[i, j]-layout (B, n, n) -> span layout S[d, i] = m[i, i+d]."""
    bsz, n, _ = m.shape
    mp = torch.nn.functional.pad(m, (0, n), value=fill)  # (B, n, 2n)
    flat = torch.cat([mp.reshape(bsz, -1),
                      torch.full((bsz, n), fill, dtype=m.dtype, device=m.device)], dim=1)
    sk = flat.reshape(bsz, n, 2 * n + 1)  # sk[i, d] = mp[i, i+d]
    return sk[:, :, :n].transpose(1, 2)


def _skew_span_to_ij(s: torch.Tensor, fill: float) -> torch.Tensor:
    """Span layout (B, n, n) -> [i, j]-layout M[i, j] = s[j-i, i]."""
    bsz, n, _ = s.shape
    st = s.transpose(1, 2)  # st[i, d]
    cp = torch.nn.functional.pad(st, (0, n), value=fill)  # (B, n, 2n)
    flat = cp.reshape(bsz, -1)[:, : n * (2 * n - 1)]
    sk = flat.reshape(bsz, n, 2 * n - 1)  # sk[i, j] = cp[i, j-i]
    return sk[:, :, :n]


def _span_tables(codes, length, params, w_extra=None, pt_override=None):
    """All LUTs in span layout ([b, d, i] = lut[b, i, i+d]), as (log, exp)."""
    luts = build_luts(codes, length, params, w_extra, pt_override)
    logs, exps = {}, {}
    for k, v in luts.items():
        s = _skew_ij_to_span(v.to(DT), NEG)
        logs[k] = s
        exps[k] = torch.exp(torch.clamp(s, max=60.0))
    return logs, exps


def _bmax(*ts: torch.Tensor) -> torch.Tensor:
    """Per-batch max over the trailing axes of several tensors -> (B,)."""
    return torch.stack([t.reshape(t.shape[0], -1).amax(dim=1) for t in ts]).amax(dim=0)


def _inside_scaled(codes, length, params, tabs):
    """Scaled inside pass over a batch.  Returns a dict of span-layout tables."""
    logs, exps = tabs
    bsz, n = codes.shape[0], codes.shape[-1]  # codes may be (B, R, n) alignment rows
    dev = codes.device
    wpairS = exps["wpair"]
    hairpinS = logs["hairpin"]  # log form: sets row scale
    i_idx = torch.arange(n, device=dev)

    kernels = [torch.as_tensor(k, dtype=DT, device=dev) for k in _class_kernels(params)]
    cls_out, cls_in = _cls_names(params)
    ncls = len(cls_out)
    cdim = kernels[0].shape[0]
    c_lin = float(np.float32(np.exp(params.ml_unpaired)))
    cpow = torch.as_tensor(np.exp(params.ml_unpaired * np.arange(n, dtype=np.float64)),
                           dtype=DT, device=dev)

    zeros = lambda *s: torch.zeros(s, dtype=DT, device=dev)  # noqa: E731
    nrev = n + max(n, cdim) + 1  # rev buffers must fit (start, cdim|n) slices
    rqb = zeros(bsz, nrev, n)  # rev span Qb rows at n-1-d
    rqbx = zeros(bsz, ncls, nrev, n)  # class-weighted Qb shadows
    rqm1e = zeros(bsz, nrev, n)  # rev end-layout Qm1 rows
    qm_tbl = zeros(bsz, n, n)  # start-layout Qm rows
    mu = torch.full((bsz, n), NEG, dtype=DT, device=dev)
    mu_rev = torch.full((bsz, nrev), NEG, dtype=DT, device=dev)
    qm1_prev, qm2_prev, qm2_prev2 = zeros(bsz, n), zeros(bsz, n), zeros(bsz, n)
    Qb, Qm1, Qm, Qm2 = zeros(bsz, n, n), zeros(bsz, n, n), zeros(bsz, n, n), zeros(bsz, n, n)
    neg_col = torch.full((bsz, 1), NEG, dtype=DT, device=dev)
    len_col = length[:, None]

    for d in range(1, n):
        start = n - 1 - d
        t_slab = rqb[:, start: start + cdim]  # (B, cdim, n)
        tx_slab = rqbx[:, :, start: start + cdim]  # (B, ncls, cdim, n)
        mu_t = mu_rev[:, start: start + cdim]  # (B, cdim)
        s_slab = rqm1e[:, start: start + n]  # (B, n, n)
        mu_s = mu_rev[:, start: start + n]  # (B, n)
        mu_sh = torch.cat([neg_col, mu[:, :-1]], dim=1)

        hp_row = hairpinS[:, d]
        p = _bmax(mu_sh + mu_s, mu_s, hp_row)
        p = torch.where(p < -1e29, torch.zeros_like(p), p)[:, None]

        f_t = torch.exp(mu_t - p)  # (B, cdim)
        f_s = torch.exp(mu_s - p)  # (B, n)
        f_w = torch.exp(mu_sh + mu_s - p)  # (B, n)

        # ---- Qb row ----
        tf = t_slab * f_t[:, :, None]
        txf = tx_slab * f_t[:, None, :, None]
        acc = torch.exp(hp_row - p)  # hairpin (full lut)
        acc = acc + exps["stack"][:, d] * _shift_left(tf[:, 2], 1)
        for (name, ds, sh) in _expl_terms(params):
            acc = acc + exps[name][:, d] * _shift_left(tf[:, ds], sh)
        for c in range(ncls):
            acc = acc + exps[cls_out[c]][:, d] * _conv_rows(txf[:, c], kernels[c], flip=False)
        acc = acc + exps["ml_close"][:, d] * _shift_left(qm2_prev2 * f_t[:, 2:3], 1)
        qb = wpairS[:, d] * acc

        # ---- Qm1 row (ml_stem lut includes b + terminal + mismatch) ----
        qm1 = c_lin * qm1_prev * f_s[:, 1:2] + exps["ml_stem"][:, d] * qb

        # ---- split slabs ----
        u_slab = _shift_left(s_slab, d)  # row t: Qm1E[d-t] at position i+d
        u_slab[:, 0] = qm1  # t = 0: fresh row (already at p)
        w_sh = torch.cat([zeros(bsz, 1, n), qm_tbl[:, :-1]], dim=1)  # row t = Qm[t-1]
        qm2 = (w_sh * u_slab * f_w[:, :, None]).sum(dim=1)
        f_unp = cpow * f_s
        f_unp[:, 0] = 1.0
        qm = qm2 + (u_slab * f_unp[:, :, None]).sum(dim=1)

        # keep junk in invalid lanes (i + d >= length) out of the row scale
        valid = (i_idx[None, :] + d < len_col).to(DT)
        qb, qm1, qm, qm2 = qb * valid, qm1 * valid, qm * valid, qm2 * valid

        # ---- joint rescale ----
        m = _bmax(qb, qm1, qm, qm2)[:, None]
        scale = torch.where(m > 0, m, torch.ones_like(m))
        inv = 1.0 / scale
        qb, qm1, qm, qm2 = qb * inv, qm1 * inv, qm * inv, qm2 * inv
        mu_d = torch.where(m > 0, p + torch.log(scale), torch.full_like(m, NEG))[:, 0]

        for c in range(ncls):
            rqbx[:, c, start] = qb * exps[cls_in[c]][:, d]
        rqb[:, start] = qb
        rqm1e[:, start] = _shift_right(qm1, d)
        qm_tbl[:, d] = qm
        mu[:, d] = mu_d
        mu_rev[:, start] = mu_d
        qm2_prev2, qm2_prev, qm1_prev = qm2_prev, qm2, qm1
        Qb[:, d], Qm1[:, d], Qm[:, d], Qm2[:, d] = qb, qm1, qm, qm2

    # ---- external chain (log domain) ----
    logQbS = torch.where(Qb > 0, torch.log(torch.clamp(Qb, min=TINY)) + mu[:, :, None],
                         torch.full_like(Qb, NEG))
    logQbE = torch.clamp(logQbS + logs["ext_stem"], min=NEG)  # exterior-weighted
    # end-layout transpose: qbe_T[j, t] = log QbE(span t, end j)
    sk = torch.nn.functional.pad(logQbE, (0, n), value=NEG)
    flat = sk.reshape(bsz, -1)[:, : n * (2 * n - 1)]
    qbe = flat.reshape(bsz, n, 2 * n - 1)[:, :, :n]  # qbe[t, j] = logQbE[t, j-t]
    qbe_T = qbe.transpose(1, 2)

    c_ext = float(np.float32(params.ext_unpaired))
    qlv = torch.full((bsz, n + 1), NEG, dtype=DT, device=dev)
    qlv[:, 0] = 0.0
    rev = torch.full((bsz, 3 * n + 2), NEG, dtype=DT, device=dev)
    rev[:, 2 * n] = 0.0
    for j in range(n):
        w = rev[:, 2 * n - j: 3 * n - j]  # w[t] = Ql[j-t-1]
        paired = torch.logsumexp(qbe_T[:, j] + w, dim=1)
        val = torch.logaddexp(qlv[:, j] + c_ext, paired)
        val = torch.where(j < length, val, qlv[:, j])
        qlv[:, j + 1] = val
        rev[:, 2 * n - (j + 1)] = val
    logZ = qlv.gather(1, length.long()[:, None])[:, 0]
    return dict(Qm1=Qm1, Qm=Qm, mu=mu, logQbS=logQbS, logQbE=logQbE, qlv=qlv, logZ=logZ)


def _outside_scaled(codes, length, params, tabs, ins):
    """Scaled outside pass over a batch -> bpp (B, n, n) in [i, j] layout."""
    logs, exps = tabs
    bsz, n = codes.shape[0], codes.shape[-1]  # codes may be (B, R, n) alignment rows
    dev = codes.device
    i_idx = torch.arange(n, device=dev)

    kernels = [torch.as_tensor(k, dtype=DT, device=dev) for k in _class_kernels(params)]
    cdim = kernels[0].shape[0]
    PAD = max(cdim, 8)  # row padding for span-(D+k) reads, k <= 6 or cdim

    def padded(name):
        return torch.nn.functional.pad(exps[name], (0, 0, 0, PAD))

    wpadS = padded("wpair")
    stkpadS = padded("stack")
    mlclosepadS = padded("ml_close")
    expl_pads = {name: padded(name) for (name, _, _) in _expl_terms(params)}
    cls_out, cls_in = _cls_names(params)
    ncls = len(cls_out)
    clsout_pads = [padded(nm) for nm in cls_out]

    c_lin = float(np.float32(np.exp(params.ml_unpaired)))
    cpow = torch.as_tensor(np.exp(params.ml_unpaired * np.arange(n, dtype=np.float64)),
                           dtype=DT, device=dev)
    c_ext = float(np.float32(params.ext_unpaired))

    Qm1, Qm, mu = ins["Qm1"], ins["Qm"], ins["mu"]
    logQbE, qlv, logZ = ins["logQbE"], ins["qlv"], ins["logZ"]
    zeros = lambda *s: torch.zeros(s, dtype=DT, device=dev)  # noqa: E731
    negs = lambda *s: torch.full(s, NEG, dtype=DT, device=dev)  # noqa: E731

    # ---- OQl chain (log domain, descending j) ----
    logQbE_T = logQbE.transpose(1, 2)  # [i, t]
    oql = negs(bsz, 2 * n)
    len_m1 = length - 1
    for j in range(n - 1, -1, -1):
        rowv = logQbE_T[:, min(j + 1, n - 1)]  # over t: QbE(start j+1, span t)
        win = oql[:, j + 1: j + 1 + n]  # oql[j+1+t]
        if j + 1 < n:
            paired = torch.logsumexp(rowv + win, dim=1)
        else:
            paired = negs(bsz)
        unp = torch.where(j + 1 < length, oql[:, j + 1] + c_ext, negs(bsz))
        val = torch.logaddexp(unp, paired)
        val = torch.where(len_m1 == j, torch.zeros_like(val), val)
        val = torch.where(len_m1 < j, negs(bsz), val)
        oql[:, j] = val
    ql_shift = torch.cat([zeros(bsz, 1), qlv[:, 1:n]], dim=1)  # Ql[i-1]

    nbuf = 2 * n + cdim + 8  # covers slices (D+k, n|cdim) for any D < n
    ob_pad = zeros(bsz, nbuf, n)
    om2_pad = zeros(bsz, nbuf, n)
    om_pad = zeros(bsz, nbuf, n)
    om_off = negs(bsz, nbuf)  # offsets, indexed by D
    om1_prev = zeros(bsz, n)
    mu_sh = torch.cat([negs(bsz, 1), mu[:, :-1]], dim=1)  # mu[t-1]
    qm_sh = torch.cat([zeros(bsz, 1, n), Qm[:, :-1]], dim=1)  # Qm[t-1]
    Ob = zeros(bsz, n, n)
    om_d_all = negs(bsz, n)

    for D in range(n - 1, 0, -1):
        om_up = om_off[:, D: D + n]  # om[D+t]
        om_up1 = om_off[:, D + 1: D + 1 + n]  # om[D+1+t]
        oql_sh = _shift_left(oql[:, :n], D)  # oql[i+D]
        oql_sh = torch.where(i_idx[None, :] + D < n, oql_sh, negs(1, 1))
        ext_log = ql_shift + oql_sh + logs["ext_stem"][:, D]

        p = _bmax(mu_sh + om_up1, om_up1, ext_log, mu + om_up)
        p = torch.where(p < -1e29, torch.zeros_like(p), p)[:, None]

        # ---- Om[D]: sum_{u>D} Qm1[u-D-1, i+D+1] * Om2[u, i] ----
        qm1_sh = _shift_left(Qm1, D + 1)  # row r at position i+D+1
        om2_slab = om2_pad[:, D + 1: D + 1 + n]  # row r = Om2[D+1+r]
        f = torch.exp(mu + om_up1 - p)  # mu[r] + om[D+1+r]
        om_row = (qm1_sh * om2_slab * f[:, :, None]).sum(dim=1)

        # ---- Om2[D]: multiloop close + Om flow ----
        ob2 = ob_pad[:, D + 2]
        wp2 = wpadS[:, D + 2]
        close = _shift_right(
            ob2 * wp2 * mlclosepadS[:, D + 2] * torch.exp(om_off[:, D + 2: D + 3] - p), 1)
        om2_row = close + om_row

        # ---- Om1[D] ----
        inc = c_lin * om1_prev * torch.exp(om_off[:, D + 1: D + 2] - p)
        om2_up = om2_pad[:, D: D + n]
        g_b = torch.exp(mu_sh + om_up - p)
        g_b[:, 0] = 0.0  # mu[t-1]+om[D+t], t>=1
        term_b = _skew_sum(qm_sh * om2_up * g_b[:, :, None])
        om_up_slab = om_pad[:, D: D + n]
        g_c = cpow * torch.exp(om_up - p)
        g_c[:, 0] = 0.0
        term_c = om_row + _skew_sum(om_up_slab * g_c[:, :, None])  # t=0: this step's Om row
        om1_row = inc + term_b + term_c

        # ---- Ob[D] ----
        ext = torch.exp(torch.clamp(ext_log - p, max=60.0))
        stack_term = _shift_right(
            ob2 * wp2 * stkpadS[:, D + 2] * torch.exp(om_off[:, D + 2: D + 3] - p), 1)
        acc = ext + stack_term
        for (name, ds, sh) in _expl_terms(params):
            obk = ob_pad[:, D + ds]
            wpk = wpadS[:, D + ds]
            lk = expl_pads[name][:, D + ds]
            acc = acc + _shift_right(
                obk * wpk * lk * torch.exp(om_off[:, D + ds: D + ds + 1] - p), sh)
        # interior classes: slab rows c = Ob[D+c]*wpair[D+c]*mm_out[D+c]
        ob_cslab = ob_pad[:, D: D + cdim]
        wp_cslab = wpadS[:, D: D + cdim]
        f_c = torch.exp(om_off[:, D: D + cdim] - p)
        for c in range(ncls):
            mo_cslab = clsout_pads[c][:, D: D + cdim]
            slab = ob_cslab * wp_cslab * mo_cslab * f_c[:, :, None]
            acc = acc + exps[cls_in[c]][:, D] * _conv_rows(slab, kernels[c], flip=True)
        # multiloop branch entry
        ob_row = acc + exps["ml_stem"][:, D] * om1_row

        # ---- joint rescale ----
        m = _bmax(ob_row, om1_row, om_row, om2_row)[:, None]
        scale = torch.where(m > 0, m, torch.ones_like(m))
        inv = 1.0 / scale
        ob_row, om1_row = ob_row * inv, om1_row * inv
        om_row, om2_row = om_row * inv, om2_row * inv
        om_d = torch.where(m > 0, p + torch.log(scale), torch.full_like(m, NEG))[:, 0]

        ob_pad[:, D] = ob_row
        om2_pad[:, D] = om2_row
        om_pad[:, D] = om_row
        om_off[:, D] = om_d
        om1_prev = om1_row
        Ob[:, D] = ob_row
        om_d_all[:, D] = om_d

    logOb = torch.where(Ob > 0, torch.log(torch.clamp(Ob, min=TINY)) + om_d_all[:, :, None],
                        torch.full_like(Ob, NEG))
    # bpp in [i, j] layout: inverse skew (no gather)
    djj = (i_idx[None, :] - i_idx[:, None])[None]
    lq = _skew_span_to_ij(ins["logQbS"], NEG)
    lo = _skew_span_to_ij(logOb, NEG)
    return torch.where(djj > 0,
                       torch.exp(torch.clamp(lq + lo - logZ[:, None, None], max=0.0)),
                       torch.zeros((), dtype=DT, device=dev))


def _kernel_tables(codes, length, params, w_extra=None, pt_override=None) -> dict:
    """The LUTs the fold DP kernel reads (``fold_dp.table_names``), each a
    contiguous (B, n, n) f32 view in span layout, with the values
    :func:`_span_tables` gives: log scores for ``fold_dp.LOG_TABLES``,
    exp(min(score, 60)) for the others.  One skew for all of them."""
    luts = build_luts(codes, length, params, w_extra, pt_override)
    names = fold_dp.table_names(params)
    stacked = torch.stack([luts[k] for k in names]).to(DT)  # (T, B, n, n)
    t, bsz, n, _ = stacked.shape
    span = _skew_ij_to_span(stacked.reshape(t * bsz, n, n), NEG).reshape(t, bsz, n, n)
    span = span.contiguous()
    n_log = len(fold_dp.LOG_TABLES)
    span[n_log:].clamp_(max=60.0).exp_()
    return dict(zip(names, span.unbind(0)))


def _inputs(codes_batch, lengths, w_extra, pt_override, device):
    codes = torch.as_tensor(np.asarray(codes_batch).astype(np.int64), device=device)
    lens = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
    we = (None if w_extra is None
          else torch.as_tensor(np.asarray(w_extra, np.float32), device=device))
    po = (None if pt_override is None
          else torch.as_tensor(np.asarray(pt_override, np.int64), device=device))
    return codes, lens, we, po


def mccaskill_bpp_batch_scaled_reference(
    codes_batch: np.ndarray,
    lengths: np.ndarray,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`mccaskill_bpp_batch_scaled` on any
    device: the Python loops over the span length above."""
    params = params or default_params()
    codes, lens, we, po = _inputs(codes_batch, lengths, w_extra, pt_override, device)
    with torch.no_grad():
        tabs = _span_tables(codes, lens, params, we, po)
        ins = _inside_scaled(codes, lens, params, tabs)
        bpp = _outside_scaled(codes, lens, params, tabs, ins)
    return bpp, ins["logZ"]


def mccaskill_bpp_batch_scaled(
    codes_batch: np.ndarray,
    lengths: np.ndarray,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (bpp (B, n, n), logZ (B,)) on ``device``, both f32.

    ``codes_batch``: (B, n) codes padded to a shared n, or (B, R, n)
    alignment rows (gap/other = 4) for the true-alifold averaged LUTs
    (tables._build_luts_averaged); ``lengths``: (B,).  ``w_extra``: optional
    (B, n, n) extra pair log-weights (taken as f32); ``pt_override``:
    optional (B, n, n) pair types, -1 = cannot pair (see tables.build_luts).
    All-gap rows and length 0 add no term to any sum.  Memory is
    O(B n^2) for the DP and O(B R n^2) for the LUTs: callers cut large
    batches (fold.bpmatrix does).  CPU tensors take the plain version
    (:func:`mccaskill_bpp_batch_scaled_reference`), any other device the
    fold DP kernel, which raises off a CUDA device.
    """
    params = params or default_params()
    if torch.device(device).type == "cpu":
        return mccaskill_bpp_batch_scaled_reference(
            codes_batch, lengths, params, w_extra=w_extra, pt_override=pt_override,
            device=device)
    codes, lens, we, po = _inputs(codes_batch, lengths, w_extra, pt_override, device)
    with torch.no_grad():
        tabs = _kernel_tables(codes, lens, params, we, po)
        return fold_dp.fold_dp(tabs, lens.to(torch.int32), params)
