"""The banded full stem kernel, plain: log K of the windowed-memory engine.

Frozen from ``stem_kernel_torch/models/full_stem.py`` (``pair_weights``,
``banded_inputs``, ``_banded_precompute``, ``banded_level0``,
``full_stem_kernel_banded_log``) and ``ops/recurrence.py``, the plain
version of K6, cut to the staircase anchors (``-a 0``); its two gap
recurrences take ``tf32`` (the control's products).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .products import round_tf32

RNA_A, RNA_C, RNA_G, RNA_U = 0, 1, 2, 3


def toeplitz_powers(a: float, n: int, *, device, dtype=torch.float32,
                    reverse: bool = False) -> torch.Tensor:
    """(n, n) T with T[s, t] = a^(t-s) for t >= s (t <= s when ``reverse``)."""
    idx = torch.arange(n, device=device, dtype=torch.float64)
    lag = idx[None, :] - idx[:, None]
    if reverse:
        lag = -lag
    t = torch.where(lag >= 0, torch.as_tensor(float(a), dtype=torch.float64,
                                              device=device) ** lag.clamp(min=0),
                    torch.zeros((), dtype=torch.float64, device=device))
    return t.to(dtype)


def linear_recurrence(a: float, b: torch.Tensor, *, matrix: torch.Tensor,
                      tf32: bool = False) -> torch.Tensor:
    """x[t] = a x[t-1] + b[t] along the last axis: one (1, n) @ (n, n)
    product a row with the Toeplitz matrix of gap powers."""
    n = b.shape[-1]
    rows = b.reshape(-1, 1, n)
    if tf32:  # round once, before the expand
        rows, matrix = round_tf32(rows), round_tf32(matrix)
    return torch.bmm(rows, matrix.reshape(-1, n, n).expand(rows.shape[0], n, n)
                     ).reshape(b.shape)


def pair_weights(
    codes: np.ndarray,
    length: int,
    *,
    use_GU: bool = True,
    min_loop: int = 3,
    bpp: np.ndarray | None = None,
    bp_bound: float = 0.0,
) -> np.ndarray:
    """(n, n) pair weight matrix w[i, j] for closing positions (i, j).

    Predicate variants give weight 1 to allowed pairs (NormalBasePair /
    WobbleBasePair, stem_kernel.cpp:353-390); with a BPP matrix the weight is
    the probability, zeroed below ``bp_bound`` (Vienna-backed BPMatrix,
    :392-421).  Pairs must enclose at least ``min_loop`` unpaired bases.
    """
    n = len(codes)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    if bpp is not None:
        w = np.where(bpp > bp_bound, bpp, 0.0)
    else:
        a, b = codes[ii], codes[jj]
        wc = ((a == RNA_A) & (b == RNA_U)) | ((a == RNA_U) & (b == RNA_A)) | (
            (a == RNA_C) & (b == RNA_G)
        ) | ((a == RNA_G) & (b == RNA_C))
        if use_GU:
            wc |= ((a == RNA_G) & (b == RNA_U)) | ((a == RNA_U) & (b == RNA_G))
        w = wc.astype(np.float64)
    w = np.where(jj - ii > min_loop, w, 0.0)
    w = np.where((ii < length) & (jj < length), w, 0.0)
    return w


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the JAX engines take their scalars."""
    return float(np.float32(v))


def _rev_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(t.flip(dim), dim).flip(dim)


def _shift_i(t: torch.Tensor) -> torch.Tensor:
    """The block at start i+1 (zeros past the end)."""
    return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1)


# ---------------------------------------------------------------- banded


def _pad_pair_to_common(x_codes, y_codes, bp_x, bp_y):
    """Pad both sides to one width: the window algebra indexes x and y
    through one block geometry, but the predict flow featurizes test chunks
    at their own pad widths (cli/app.py)."""
    nx, ny = x_codes.shape[1], y_codes.shape[1]
    n = max(nx, ny)
    if nx < n:
        x_codes = F.pad(x_codes, (0, n - nx))
        bp_x = F.pad(bp_x, (0, n - nx, 0, n - nx))
    if ny < n:
        y_codes = F.pad(y_codes, (0, n - ny))
        bp_y = F.pad(bp_y, (0, n - ny, 0, n - ny))
    return x_codes, y_codes, bp_x, bp_y


def _deltas(a: torch.Tensor) -> torch.Tensor:
    """delta[t] = a[t+1] - a[t], 0 at the last position."""
    return torch.cat([a[:, 1:] - a[:, :-1], torch.zeros_like(a[:, :1])], 1)


def _staircase_anchor(lx: torch.Tensor, ly: torch.Tensor, n: int):
    """Monotone window anchors a[t] = floor(min(t, lx) * ly / lx + 0.5).

    The reference's scaled-diagonal band center (stem_kernel.cpp:70-76),
    per pair, in f32 and in this order (multiply, then divide).  Requires
    ly <= lx, so consecutive anchors differ by 0 or 1; callers swap the pair
    otherwise.  Returns (a, delta_k), both (B, n+1) int32.
    """
    t = torch.arange(n + 1, device=lx.device)
    lx_ = torch.clamp(lx, min=1).to(torch.float32)
    a = torch.floor(
        torch.minimum(t[None, :], lx[:, None].long()).to(torch.float32)
        * ly[:, None].to(torch.float32) / lx_[:, None] + 0.5
    ).to(torch.int32)
    return a, _deltas(a)


def banded_inputs(x_codes, y_codes, lx, ly, bp_x, bp_y, ali_bound: float = 0.0):
    """Common pad width, pairs swapped so lx >= ly (the kernel is symmetric,
    and the anchor steps stay in {0, 1}), and the window anchors.

    Returns (x_codes, y_codes, lx, ly, bp_x, bp_y, a, delta_k) with a and
    delta_k (B, n+1) int32: the scaled diagonal, or with ``ali_bound > 0``
    the PHMM alignment (partial_dp's -a mode, stem_kernel.cpp:13-69).
    """
    x_codes, y_codes, bp_x, bp_y = _pad_pair_to_common(x_codes, y_codes, bp_x, bp_y)
    swap = ly > lx
    x_codes, y_codes = (torch.where(swap[:, None], y_codes, x_codes),
                        torch.where(swap[:, None], x_codes, y_codes))
    bp_x, bp_y = (torch.where(swap[:, None, None], bp_y, bp_x),
                  torch.where(swap[:, None, None], bp_x, bp_y))
    lx, ly = torch.where(swap, ly, lx), torch.where(swap, lx, ly)
    if ali_bound > 0.0:
        raise ValueError("the reference runs the staircase anchors only (-a 0)")
    a, delta_k = _staircase_anchor(lx, ly, x_codes.shape[1])
    return x_codes, y_codes, lx, ly, bp_x, bp_y, a, delta_k


def _banded_precompute(x_codes, y_codes, lx, ly, bp_x, bp_y, band: int, a, delta_k):
    """Once-per-batch ingredients of the banded level loop (gathers).

    Returns a_pad (a[min(t, n)]), dk_pad, eq1_win (B, n+1, W), E2pad
    (B, 2n+1, W), SXT (B, n+1 levels, n+1 blocks) = bp_x[i, i+d-1], EG
    (B, n, n+1, W), the bp_y column entering the window at each level, and
    BW0 (B, n+1, W, W), the bp_y window at level 0.
    """
    bsz, n = x_codes.shape
    dev = x_codes.device
    W = 2 * band + 1
    i_idx = torch.arange(n + 1, device=dev)
    w_idx = torch.arange(W, device=dev)
    a = a.long()
    lx_, ly_ = lx.long(), ly.long()
    zero = torch.zeros((), dtype=bp_x.dtype, device=dev)

    a_pad = torch.cat([a, a[:, -1:].expand(bsz, n)], 1)
    dk_pad = torch.cat([delta_k.long(), torch.zeros((bsz, n), dtype=torch.long, device=dev)], 1)

    # absolute k of (block i, slot wk): a[i] - band + wk
    k_abs = a[:, :, None] - band + w_idx[None, None, :]  # (B, n+1, W)
    k_ok = (k_abs >= 0) & (k_abs < ly_[:, None, None])
    kk = torch.clamp(k_abs, 0, n - 1)
    yc = y_codes.long()

    # x[i] (255 past lx), compared with y at absolute k
    xi = torch.where(i_idx[None, :] < lx_[:, None],
                     x_codes.long()[:, torch.clamp(i_idx, max=n - 1)], 255)
    yk = yc.gather(1, kk.reshape(bsz, -1)).reshape(bsz, n + 1, W)
    eq1_win = (xi[:, :, None] == yk) & k_ok

    # E2[b, r, wl] = (x[r] == y[a[r+1] - band + wl - 1]), read at r = i + d - 1
    l_abs = a_pad[:, 1:n + 2][:, :, None] - band + w_idx[None, None, :] - 1
    l_ok = (l_abs >= 0) & (l_abs < ly_[:, None, None])
    yl = yc.gather(1, torch.clamp(l_abs, 0, n - 1).reshape(bsz, -1)).reshape(bsz, n + 1, W)
    E2 = (xi[:, :, None] == yl) & l_ok
    E2pad = torch.cat([E2, torch.zeros((bsz, n, W), dtype=torch.bool, device=dev)], 1)

    # SXT[b, d, i] = bp_x[i, i + d - 1] (zero out of range)
    col = i_idx[None, None, :] + i_idx[None, :, None] - 1  # (1, n+1 levels, n+1 blocks)
    col_ok = ((col >= 0) & (col < lx_[:, None, None])
              & (i_idx[None, None, :] < lx_[:, None, None]))
    flat = torch.clamp(i_idx, max=n - 1)[None, None, :] * n + torch.clamp(col, 0, n - 1)
    SXT = torch.where(
        col_ok,
        bp_x.reshape(bsz, -1).gather(1, flat.reshape(1, -1).expand(bsz, -1))
        .reshape(bsz, n + 1, n + 1),
        zero)

    # EG[b, d-1, i, wk] = bp_y[k_abs(i, wk), a[i+d] + band - 1]: the entering
    # slot wl = W-1 of the bp_y window when the l-window slides at level d
    idx_id = i_idx[None, 1:, None] + i_idx[None, None, :]  # (1, n, n+1): i + d
    a_at = a_pad.gather(1, idx_id.reshape(1, -1).expand(bsz, -1)).reshape(bsz, n, n + 1)
    c_eg = a_at + band - 1
    c_ok = (c_eg >= 0) & (c_eg < ly_[:, None, None])
    flat_eg = kk[:, None, :, :] * n + torch.clamp(c_eg, 0, n - 1)[:, :, :, None]
    EG = torch.where(
        c_ok[:, :, :, None] & k_ok[:, None, :, :],
        bp_y.reshape(bsz, -1).gather(1, flat_eg.reshape(bsz, -1)).reshape(bsz, n, n + 1, W),
        zero)

    # bp_y window at level 0: BW0[i, wk, wl] = bp_y[k_abs, a[i] - 1 - band + wl]
    l0 = a[:, :, None] - 1 - band + w_idx[None, None, :]
    l0_ok = (l0 >= 0) & (l0 < ly_[:, None, None])
    flat0 = kk[:, :, :, None] * n + torch.clamp(l0, 0, n - 1)[:, :, None, :]
    BW0 = torch.where(
        l0_ok[:, :, None, :] & k_ok[:, :, :, None],
        bp_y.reshape(bsz, -1).gather(1, flat0.reshape(bsz, -1)).reshape(bsz, n + 1, W, W),
        zero)
    return a_pad, dk_pad, eq1_win, E2pad, SXT, EG, BW0


def banded_level0(gap: float, band: int, *, device):
    """(W, W) level-0 windows: K0 = 1, G0[wk, wl] = gap^(wl - wk) on wl >= wk."""
    w_idx = torch.arange(2 * band + 1, device=device)
    rel = (w_idx[None, :] - w_idx[:, None]).to(torch.float32)
    gap_t = torch.tensor(_f32(gap), device=device)
    return torch.ones_like(rel), gap_t ** rel * (rel >= 0).to(torch.float32)


@torch.no_grad()
def full_stem_kernel_banded_log(
    x_codes: torch.Tensor,  # (B, nx) uint8
    y_codes: torch.Tensor,  # (B, ny) uint8
    lx: torch.Tensor,
    ly: torch.Tensor,
    bp_x: torch.Tensor,  # (B, nx, nx) float32
    bp_y: torch.Tensor,  # (B, ny, ny) float32
    gap: float,
    stack: float,
    subst: float,
    band: int = 16,
    precision: str = "highest",
    ali_bound: float = 0.0,
    tf32: bool = False,
) -> torch.Tensor:
    """Windowed-memory full stem kernel, log K (B,): O(B n W^2) live state.

    Each block (i, j=i+d) keeps only a (W, W) window of the (k, l) plane,
    k in a(i) +- band and l in a(j) +- band, on the staircase anchors of
    :func:`banded_inputs` (the reference's banded partial_dp with row
    recycling, stem_kernel.cpp:165-246).  Between levels a window
    re-anchors by a conditional one-slot shift: K-states are constant beyond
    the band, so the entering edge repeats the edge; G-states decay by
    ``gap`` per step, so it is gap * edge.  The diagonal k == l sits at
    wk - wl == a(j) - a(i).

    Every level rescales all states by the per-pair max |K0| over all blocks
    and keeps the log-scale, so values of any length stay in f32; diagonal
    seeds enter at the current scale, exp(-logS).  The value is log K0 of
    block (0, lx) at (k=0, l=ly), plus the log-scale; 0 where lx = 0.
    """
    if precision != "highest":
        raise ValueError(
            f"precision {precision!r}: the port computes in full f32 (\"highest\") only")
    (x_codes, y_codes, lx, ly, bp_x, bp_y, a, delta_k) = banded_inputs(
        x_codes, y_codes, lx, ly, bp_x, bp_y, ali_bound)
    bsz, n = x_codes.shape
    dev, dt = bp_x.device, bp_x.dtype
    gap, stack, subst = _f32(gap), _f32(stack), _f32(subst)
    W = 2 * band + 1
    a_pad, dk_pad, eq1_win, E2pad, SXT, EG, BW = _banded_precompute(
        x_codes, y_codes, lx, ly, bp_x, bp_y, band, a, delta_k)
    a = a.long()
    w_idx = torch.arange(W, device=dev)
    dk_m = (dk_pad[:, :n + 1] > 0)[:, :, None, None]

    k0_win, g0_win = banded_level0(gap, band, device=dev)
    shape = (bsz, n + 1, W, W)
    K0p = k0_win.to(dt).expand(shape).clone()
    G0p = g0_win.to(dt).expand(shape).clone()
    K1p = torch.zeros(shape, dtype=dt, device=dev)
    G1p = torch.zeros_like(K1p)
    G0pp = torch.zeros_like(K1p)
    logS = torch.zeros(bsz, dtype=dt, device=dev)
    tpow = toeplitz_powers(gap, W, device=dev, dtype=dt)
    tpow_rev = toeplitz_powers(gap, W, device=dev, dtype=dt, reverse=True)
    gap_t = torch.tensor(gap, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    sub_t = torch.full((), subst, dtype=dt, device=dev)
    lx_ = lx.long()
    result = torch.zeros(bsz, dtype=dt, device=dev)  # lx = 0: log K = 0

    for d in range(1, int(lx_.max()) + 1 if bsz else 1):
        off = a_pad[:, d:d + n + 1] - a  # anchor offset a(i+d) - a(i)
        dj_m = (dk_pad[:, d - 1:d + n] > 0)[:, :, None, None]  # a(i+d) - a(i+d-1)
        e2 = E2pad[:, d - 1:d + n]
        bpx_d = SXT[:, d]

        # the bp_y window slides with the l-anchor
        BW = torch.where(dj_m, torch.cat([BW[..., 1:], EG[:, d - 1, :, :, None]], -1), BW)

        # re-anchoring: K1(i+1, j) and G1 by a conditional wk-shift, K0(i, j-1)
        # and G0 by a conditional wl-shift, with the edge fills
        t = _shift_i(K1p)
        K1_base = torch.where(dk_m, torch.cat([t[:, :, :1], t[:, :, :-1]], 2), t)
        t = _shift_i(G1p)
        G1_base = torch.where(dk_m, torch.cat([gap * t[:, :, :1], t[:, :, :-1]], 2), t)
        K0_base = torch.where(dj_m, torch.cat([K0p[..., 1:], K0p[..., -1:]], -1), K0p)
        G0_base = torch.where(dj_m, torch.cat([G0p[..., 1:], gap * G0p[..., -1:]], -1), G0p)
        # G0(i+1, j-1) read at (k+1, l-1), clamp-filled
        t = _shift_i(G0pp)
        base = torch.where(dk_m, t, torch.cat([t[:, :, 1:], t[:, :, -1:]], 2))
        base = torch.where(dj_m, base, torch.cat([base[..., :1], base[..., :-1]], -1))

        # injection, masked to absolute k <= l, i.e. wk <= off + wl
        both_eq = eq1_win[:, :, :, None] & e2[:, :, None, :]
        wfac = bpx_d[:, :, None, None] * BW
        inj_k3 = base * stack * wfac * torch.where(both_eq, one, sub_t)
        inj_g3 = base * both_eq.to(dt) * torch.where(wfac > 0, one, zero)
        tri = w_idx[None, None, :, None] <= off[:, :, None, None] + w_idx[None, None, None, :]
        tri_w = tri.to(dt)
        inj_k3 = inj_k3 * tri_w
        inj_g3 = inj_g3 * tri_w

        # within-window recursions
        K3 = _rev_cumsum(inj_k3, 2)
        G3 = linear_recurrence(gap, inj_g3.transpose(2, 3).contiguous(),
                               matrix=tpow_rev, tf32=tf32).transpose(2, 3)
        K2 = torch.cumsum(K3, 3)
        G2 = linear_recurrence(gap, G3.contiguous(), matrix=tpow, tf32=tf32)
        K1 = K1_base + K2
        G1 = G1_base * gap + G2
        K0 = K0_base + K1
        G0 = G0_base * gap + G1

        # diagonal k == l at wk - wl == off: seeds at the current scale
        diag_w = (w_idx[None, None, :, None] - w_idx[None, None, None, :]
                  == off[:, :, None, None])
        s_inv = torch.exp(-logS)[:, None, None, None]
        K0 = torch.where(diag_w, s_inv, K0 * tri_w)
        G0 = torch.where(diag_w, gap_t ** float(d) * s_inv, G0 * tri_w)
        ndiag = one - diag_w.to(dt)
        K1 = K1 * tri_w * ndiag
        G1 = G1 * tri_w * ndiag

        out = K0[:, 0, band, band]  # block (0, d) at k = 0, l = a(d)
        out_log = torch.where(out > 0, torch.log(torch.clamp(out, min=1e-38)),
                              torch.full((), -torch.inf, dtype=dt, device=dev)) + logS
        result = torch.where(lx_ == d, out_log, result)

        # per-level rescale (pf_scale trick)
        m = torch.clamp(K0.abs().amax((1, 2, 3)), min=1e-30)[:, None, None, None]
        K0, G0, K1, G1 = K0 / m, G0 / m, K1 / m, G1 / m
        G0pp = G0p / m
        logS = logS + torch.log(m[:, 0, 0, 0])
        K0p, G0p, K1p, G1p = K0, G0, K1, G1
    return result
