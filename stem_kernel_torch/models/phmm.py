"""Pair HMM: log-space forward/backward/posterior + MAP alignment path.

Port of ``stem_kernel_tpu/models/phmm.py`` (the reference's 3-state M/IX/IY
pair HMM with RIBOSUM emissions, phmm.{h,cpp}):
unnormalized log transition weights ``TRANS`` (phmm.cpp:231-236), match
emissions RIBOSUM85-60 singles (phmm.cpp:238-244), gap states emit weight 1.

The row recursion is a Python loop over x positions with the batch written
out; the in-row IY chain is :func:`..ops.recurrence.logsumexp_recurrence`
with the scalar weight ``TRANS[IY, IY]``.  Codes past the RIBOSUM table (N,
gap) are clamped to its last row and column, as the JAX gather clamps them.

The MAP path and the per-position constraints of the reference are host-side
numpy (copied); :func:`posterior_windows` is their batched form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.recurrence import logsumexp_recurrence
from .ribosum_data import RIBOSUM_S

M, IX, IY = 0, 1, 2
NEG = -1e30

# log transition weights (phmm.cpp:229-236), [from][to]
TRANS = np.array(
    [
        [0.0, -5.0, -5.0],  # M ->
        [-10.0, -5.0, -15.0],  # IX ->
        [-10.0, -5.0, -15.0],  # IY ->
    ],
    dtype=np.float32,
)
_T = TRANS.tolist()  # Python floats (all exact in f32)


def _emit_matrix(x_codes: torch.Tensor, y_codes: torch.Tensor) -> torch.Tensor:
    """(B, n, m) match emission log-weights e(x_i, y_j)."""
    rib = torch.as_tensor(RIBOSUM_S, device=x_codes.device)
    top = rib.shape[0] - 1
    xi = x_codes.long().clamp(max=top)
    yj = y_codes.long().clamp(max=top)
    return rib[xi[:, :, None], yj[:, None, :]]


def _masked_emissions(x_codes, lx, y_codes, ly) -> torch.Tensor:
    """Emissions with out-of-length cells set to NEG, so padding never wins."""
    n, m = x_codes.shape[1], y_codes.shape[1]
    dev = x_codes.device
    e = _emit_matrix(x_codes, y_codes)
    mx = torch.arange(n, device=dev)[None, :] < lx[:, None]
    my = torch.arange(m, device=dev)[None, :] < ly[:, None]
    return torch.where(mx[:, :, None] & my[:, None, :], e, torch.full((), NEG, device=dev))


@torch.no_grad()
def phmm_forward(x_codes: torch.Tensor, lx: torch.Tensor, y_codes: torch.Tensor,
                 ly: torch.Tensor):
    """Log-space forward tables.  Returns (fw (3, B, n+1, m+1), logZ (B,)).

    Recursion (phmm.cpp:11-51): fw[M][i][j] = e(i,j) * sum_s fw[s][i-1][j-1]
    * t[s][M]; IX along i; IY along j (the in-row logsumexp recurrence).
    """
    bsz, n = x_codes.shape
    m = y_codes.shape[1]
    dev = x_codes.device
    e = _masked_emissions(x_codes, lx, y_codes, ly)
    neg_col = torch.full((bsz, 1), NEG, device=dev)
    t_m = torch.tensor([_T[s][M] for s in range(3)], device=dev)[:, None, None]
    t_ix = torch.tensor([_T[s][IX] for s in range(3)], device=dev)[:, None, None]

    m_row = torch.full((bsz, m + 1), NEG, device=dev)
    m_row[:, 0] = 0.0
    ix_row = torch.full((bsz, m + 1), NEG, device=dev)
    iy0 = torch.logaddexp(m_row[:, :-1] + _T[M][IY], torch.full((bsz, m), NEG, device=dev))
    iy_row = torch.cat([neg_col, logsumexp_recurrence(_T[IY][IY], iy0)], -1)
    iy_row = torch.where(torch.arange(m + 1, device=dev)[None, :] <= ly[:, None],
                         iy_row, torch.full((), NEG, device=dev))

    rows = [torch.stack([m_row, ix_row, iy_row])]
    for i in range(n):
        diag = torch.stack([m_row[:, :-1], ix_row[:, :-1], iy_row[:, :-1]])
        m_new = torch.cat([neg_col, e[:, i] + torch.logsumexp(diag + t_m, 0)], -1)
        ix_new = torch.logsumexp(torch.stack([m_row, ix_row, iy_row]) + t_ix, 0)
        q = torch.logaddexp(m_new[:, :-1] + _T[M][IY], ix_new[:, :-1] + _T[IX][IY])
        iy_new = torch.cat([neg_col, logsumexp_recurrence(_T[IY][IY], q)], -1)
        m_row, ix_row, iy_row = m_new, ix_new, iy_new
        rows.append(torch.stack([m_row, ix_row, iy_row]))
    fw = torch.stack(rows, 2)  # (3, B, n+1, m+1)
    logz = fw[M, torch.arange(bsz, device=dev), lx.long(), ly.long()]
    return fw, logz


@torch.no_grad()
def phmm_backward(x_codes: torch.Tensor, lx: torch.Tensor, y_codes: torch.Tensor,
                  ly: torch.Tensor) -> torch.Tensor:
    """Log-space backward tables (3, B, n+1, m+1) (phmm.cpp:53-93).

    bk[s][i][j] = sum over completions from state s at (i, j) to the end.
    """
    bsz, n = x_codes.shape
    m = y_codes.shape[1]
    dev = x_codes.device
    e = _masked_emissions(x_codes, lx, y_codes, ly)
    e_ext = torch.cat([e, torch.full((bsz, 1, m), NEG, device=dev)], 1)  # row n dummy
    neg_col = torch.full((bsz, 1), NEG, device=dev)
    # terminal: bk[M][lx][ly] = 0, seeded on the terminal row
    end_col = torch.arange(m + 1, device=dev)[None, :] == ly[:, None]
    zero = torch.zeros((), device=dev)

    m_next = torch.full((bsz, m + 1), NEG, device=dev)
    ix_next = torch.full_like(m_next, NEG)
    rows = [None] * (n + 1)
    for i in range(n, -1, -1):
        # bk[s][i][j] gets: e(i,j)*t[s][M]*bk[M][i+1][j+1]  (diag)
        #                  t[s][IX]*bk[IX][i+1][j]          (down)
        #                  t[s][IY]*bk[IY][i][j+1]          (right, in-row)
        diag = torch.cat([e_ext[:, i] + m_next[:, 1:], neg_col], -1)
        down = ix_next
        base_m = torch.logaddexp(diag + _T[M][M], down + _T[M][IX])
        base_ix = torch.logaddexp(diag + _T[IX][M], down + _T[IX][IX])
        base_iy = torch.logaddexp(diag + _T[IY][M], down + _T[IY][IX])
        is_end = (lx == i)[:, None] & end_col
        base_m = torch.where(is_end, torch.logaddexp(base_m, zero), base_m)
        iy_row = logsumexp_recurrence(_T[IY][IY], base_iy, reverse=True)
        shift_iy = torch.cat([iy_row[:, 1:], neg_col], -1)
        m_next = torch.logaddexp(base_m, shift_iy + _T[M][IY])
        ix_next = torch.logaddexp(base_ix, shift_iy + _T[IX][IY])
        rows[i] = torch.stack([m_next, ix_next, iy_row])
    return torch.stack(rows, 2)


def phmm_posterior(x_codes, lx, y_codes, ly):
    """Posterior state probabilities fb = fw*bk/Z (forward_backward), on the host."""
    fw, logz = phmm_forward(x_codes, lx, y_codes, ly)
    bk = phmm_backward(x_codes, lx, y_codes, ly)
    fb = torch.exp(fw + bk - logz[None, :, None, None])
    return fb.cpu().numpy(), logz.cpu().numpy()


def map_path(fb: np.ndarray, lx: int, ly: int) -> list[tuple[int, int, int]]:
    """Posterior-sum-maximizing path [(state, i, j), ...] (phmm.cpp:116-215)."""
    n, m = lx, ly
    fw = np.full((3, n + 1, m + 1), -np.inf)
    tr = np.full((3, n + 1, m + 1), -1, dtype=int)
    fw[:, 0, 0] = fb[:, 0, 0]
    for i in range(1, n + 1):
        v = fw[:, i - 1, 0] + fb[IX, i, 0]
        tr[IX, i, 0] = int(np.argmax(v))
        fw[IX, i, 0] = v[tr[IX, i, 0]]
    for j in range(1, m + 1):
        v = fw[:, 0, j - 1] + fb[IY, 0, j]
        tr[IY, 0, j] = int(np.argmax(v))
        fw[IY, 0, j] = v[tr[IY, 0, j]]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            for (s, pi, pj) in ((M, i - 1, j - 1), (IX, i - 1, j), (IY, i, j - 1)):
                v = fw[:, pi, pj] + fb[s, i, j]
                a = int(np.argmax(v))
                if v[a] > fw[s, i, j]:
                    fw[s, i, j] = v[a]
                    tr[s, i, j] = a
    path = []
    s, i, j = M, n, m
    path.append((s, i, j))
    while i != 0 and j != 0:
        ps = tr[s, i, j]
        if s == M:
            i, j = i - 1, j - 1
        elif s == IX:
            i -= 1
        else:
            j -= 1
        s = ps
        path.insert(0, (s, i, j))
    return path


def alignment_constraints(
    fb: np.ndarray, lx: int, ly: int, ali_bound: float, band: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Per-i column windows (c_low, c_high) from MAP-path anchors.

    Mirrors StemKernel::alignment_constraints
    (the reference's stem_kernel.cpp:13-81).
    """
    c_low = np.zeros(lx + 1, dtype=np.int64)
    c_high = np.full(lx + 1, ly, dtype=np.int64)
    if ali_bound > 0.0:
        path = map_path(fb, lx, ly)
        low_x = low_y = 0
        for (s, px, py) in path:
            if s == M and fb[s, px, py] >= ali_bound:
                c_low[low_x:px] = low_y
                c_high[low_x:px] = py
                c_low[px] = c_high[px] = py
                low_x = px + 1
                low_y = py
        c_low[low_x:] = low_y
        c_high[low_x:] = ly
        if band > 0:
            narrow = c_high - c_low < 2 * band
            mid = (c_high + c_low) // 2
            c_low = np.where(narrow, np.maximum(mid - band, 0), c_low)
            c_high = np.where(narrow, np.minimum(mid + band, ly), c_high)
    elif band > 0:
        j = np.round(np.arange(lx + 1) / max(lx, 1) * ly).astype(np.int64)
        c_low = np.maximum(j - band, 0)
        c_high = np.minimum(j + band, ly)
    return c_low, c_high


@torch.no_grad()
def posterior_windows(x_codes, lx, y_codes, ly, bound: float, band: int = 0):
    """Per-position y-windows (c_low, c_high), batched.

    The batched form of alignment_constraints: anchor rows are those whose
    match posterior reaches ``bound`` anywhere; window bounds interpolate
    between anchors by an exclusive running max (from below) and min (from
    above), since the alignment is monotone.  ``band`` widens windows
    narrower than 2*band, as the reference does.  Returns int32 (B, n+1)
    tensors over x indices 0..n in y coordinates 0..m.
    """
    fw, logz = phmm_forward(x_codes, lx, y_codes, ly)
    bk = phmm_backward(x_codes, lx, y_codes, ly)
    pm = torch.exp(fw[M] + bk[M] - logz[:, None, None])  # (B, n+1, m+1)
    bsz, np1, mp1 = pm.shape
    m = mp1 - 1
    dev = pm.device
    jj = torch.arange(mp1, device=dev)
    lx_, ly_ = lx.long(), ly.long()
    valid = ((torch.arange(np1, device=dev)[None, :, None] <= lx_[:, None, None])
             & (jj[None, None, :] <= ly_[:, None, None]))
    hit = (pm >= bound) & valid
    row_any = hit.any(-1)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    anchor_hi = torch.where(row_any, torch.where(hit, jj, zero).amax(-1), zero)
    top = torch.full((), m, dtype=torch.long, device=dev)
    anchor_lo = torch.where(row_any, torch.where(hit, jj, top).amin(-1), top)
    # exclusive running max of anchor highs (below i) / min of anchor lows (above i)
    c_low = torch.cat([torch.zeros((bsz, 1), dtype=torch.long, device=dev),
                       torch.cummax(anchor_hi, 1).values[:, :-1]], 1)
    c_high = torch.cat([torch.cummin(anchor_lo.flip(1), 1).values.flip(1)[:, 1:],
                        torch.full((bsz, 1), m, dtype=torch.long, device=dev)], 1)
    c_high = torch.minimum(torch.maximum(c_high, c_low), ly_[:, None])
    narrow = (c_high - c_low) < 2 * band  # band=0 makes the widening a no-op
    mid = torch.div(c_high + c_low, 2, rounding_mode="floor")
    c_low = torch.where(narrow, (mid - band).clamp(min=0), c_low)
    c_high = torch.where(narrow, torch.minimum(mid + band, ly_[:, None]), c_high)
    return c_low.to(torch.int32), c_high.to(torch.int32)
