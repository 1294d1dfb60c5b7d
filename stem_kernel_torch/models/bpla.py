"""BPLA — base-pair local-alignment kernels, batched, in torch.

Port of ``stem_kernel_tpu/models/bpla.py``:

- match score s(i,j) = alpha * (p_right_x[i]*p_right_y[j]
  + p_left_x[i]*p_left_y[j]) + p_unpair_x[i]*p_unpair_y[j] * la_score(i,j),
  where la_score is the profile-expected substitution score with a 0.0
  empty-column fallback, and the structural profiles are square roots of
  summed base-pairing probabilities;
- the sum over local alignments (5 states M/X/Y/X2/Y2, whose value
  telescopes to 1 + sum M), as the plain row-loop scans
  :func:`local_alignment_exp` and :func:`local_alignment_log`, and the
  Smith-Waterman maximum :func:`local_alignment_max`;
- the optimizer's 7-state kernel :func:`local_alignment_exp_flank` and
  :func:`bpla_kernel_batch`, values and per-pair dK/d(alpha, beta, gap,
  ext) by autograd through the plain scan (the reference hand-writes the
  backward sweep, bpla_kernel.cpp:244-401);
- :class:`BPLAKernel`, which evaluates the first two through the LA kernels
  of ``ops/la.py`` (factored for score tables of rank <= 6, materialised
  above) and the maximum through its scan on every device.

Batch invariance: every product whose rows are not one pair's (the x-side
score-table product, the substitution scores) is a ``bmm`` over the pair
axis, and each row recurrence is elementwise, so a pair's value does not
depend on the pairs beside it in its batch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.la import (
    la_exp_affine_auto, la_exp_factored, la_log_affine_auto, la_log_factored,
)
from ..ops.recurrence import (
    linear_recurrence, logsumexp_recurrence, maxplus_recurrence, toeplitz_powers_rows,
)
from ..utils.tracing import span

NEG_LARGE = -1e30


def _table_product(p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """p @ table for (B, L, N) profiles, one GEMM per pair."""
    return torch.bmm(p, table.expand(p.shape[0], *table.shape))


def la_score_matrix(px: torch.Tensor, py: torch.Tensor,
                    score_table: torch.Tensor) -> torch.Tensor:
    """Profile-expected substitution scores (B, Lx, Ly), 0.0 where a column
    is empty.  px: (B, Lx, N), py: (B, Ly, N), score_table: (N, N).

    num = sum_ab px[a] S[a,b] py[b]; den = sum_a px[a] * sum_b py[b]."""
    num = torch.bmm(_table_product(px, score_table), py.transpose(1, 2))
    den = px.sum(-1)[:, :, None] * py.sum(-1)[:, None, :]
    empty = den == 0
    return torch.where(empty, torch.zeros((), device=px.device),
                       num / torch.where(empty, torch.ones((), device=px.device), den))


def bpla_score_parts(px, plx, prx, pux, py, ply, pry, puy, score_table):
    """(w_pair, w_unpair) so that s = alpha*w_pair + w_unpair.

    w_pair[i,j]   = p_right_x[i]*p_right_y[j] + p_left_x[i]*p_left_y[j]
    w_unpair[i,j] = p_unpair_x[i]*p_unpair_y[j] * la_score(i,j)
    """
    w_pair = prx[:, :, None] * pry[:, None, :] + plx[:, :, None] * ply[:, None, :]
    w_unpair = pux[:, :, None] * puy[:, None, :] * la_score_matrix(px, py, score_table)
    return w_pair, w_unpair


def bpla_factors(prof, pl, pr, pu, score_table, *, side: str) -> torch.Tensor:
    """Low-rank score factors f (B, L, 2 + N).

    With u = p_unpair / sum(prof) (0 where the column is empty),

        s[i,j] = alpha*(f_x[i,0]f_y[j,0] + f_x[i,1]f_y[j,1])
                 + sum_k f_x[i,2+k] f_y[j,2+k]

    where f = [p_right, p_left, u*prof (@ score_table on the x side)].
    """
    tot = prof.sum(-1)
    pos = tot > 0
    u = torch.where(pos, pu / torch.where(pos, tot, torch.ones((), device=tot.device)),
                    torch.zeros((), device=tot.device))
    unp = prof * u[..., None]
    if side == "x":
        unp = _table_product(unp, score_table)
    return torch.cat([pr[..., None], pl[..., None], unp], dim=-1)


def pair_mask(lx: torch.Tensor, max_lx: int, ly: torch.Tensor, max_ly: int) -> torch.Tensor:
    """(B, Lx, Ly) validity mask from true lengths."""
    mx = torch.arange(max_lx, device=lx.device)[None, :] < lx[:, None]
    my = torch.arange(max_ly, device=ly.device)[None, :] < ly[:, None]
    return mx[:, :, None] & my[:, None, :]


def _f32(x: float) -> float:
    return torch.tensor(float(x), dtype=torch.float32).item()


def _per_pair(v, dt, device) -> torch.Tensor:
    """A scalar or (B,) parameter as a (1, 1) or (B, 1) tensor."""
    return torch.as_tensor(v, dtype=dt, device=device).reshape(-1, 1)


def _exp_scan(scores: torch.Tensor, mask: torch.Tensor, beta, gap, ext, *,
              flank: bool) -> torch.Tensor:
    """The exp-space LA row scan with tensor parameters (differentiable).

    ``flank=False``: the 5-state kernel, M = e * (1 + M + X + Y) on the
    diagonal.  ``flank=True``: the 7-state kernel, whose flanking states
    feed M position-dependent counts instead of the 1, and whose M[0][0] = 1
    start unit enters row 1 through the diagonal.
    """
    bsz, lx, ly = scores.shape
    dt, dev = scores.dtype, scores.device
    beta = _per_pair(beta, dt, dev)  # (1, 1) or (B, 1)
    bg = torch.exp(beta * _per_pair(gap, dt, dev))
    be = torch.exp(beta * _per_pair(ext, dt, dev))
    e = torch.exp(beta[..., None] * scores) * mask.to(dt)
    zero_col = torch.zeros(bsz, 1, dtype=dt, device=dev)
    zeros = torch.zeros(bsz, ly + 1, dtype=dt, device=dev)
    tpow = toeplitz_powers_rows(be, ly, dtype=dt)
    if flank:
        # flank counts LX[i-1][j-1] + LY[i-1][j-1] feeding M at row i,
        # column j: [2, 1, 1, ...] from row 0, [1, 2, 3, ...] after it
        j_idx = torch.arange(1, ly + 1, dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        flank_row0 = torch.where(j_idx == 1, 2.0 * one, one)
        flank_rest = torch.where(j_idx == 1, one, j_idx)
        m_prev = torch.cat([torch.ones(bsz, 1, dtype=dt, device=dev), zeros[:, 1:]], -1)
    else:
        m_prev = zeros
    x_prev, y_prev = zeros, zeros
    acc = torch.zeros(bsz, dtype=dt, device=dev)
    for i in range(lx):
        if flank:
            diag = (m_prev[:, :-1] + x_prev[:, :-1] + y_prev[:, :-1]
                    + (flank_row0 if i == 0 else flank_rest))
        else:
            diag = 1.0 + m_prev[:, :-1] + x_prev[:, :-1] + y_prev[:, :-1]
        m_row = torch.cat([zero_col, e[:, i] * diag], dim=-1)
        # column 0 of X is never filled (in the 7-state kernel it would read
        # the M[0][0] start unit), so it is pinned to 0
        x_row = torch.cat([zero_col, (bg * m_prev + be * x_prev)[:, 1:]], dim=-1)
        q = bg * (m_row[:, :-1] + x_row[:, :-1])
        y_row = torch.cat([zero_col, linear_recurrence(be, q, matrix=tpow)], dim=-1)
        acc = acc + m_row.sum(-1)
        m_prev, x_prev, y_prev = m_row, x_row, y_row
    return 1.0 + acc


def local_alignment_exp(scores: torch.Tensor, mask: torch.Tensor, beta, gap,
                        ext) -> torch.Tensor:
    """Sum-over-alignments kernel values (B,) from scores (B, Lx, Ly): the
    plain 5-state row scan.  beta, gap and ext are scalars or (B,) tensors;
    the value is differentiable in them and in ``scores``."""
    return _exp_scan(scores, mask, beta, gap, ext, flank=False)


def local_alignment_exp_flank(scores: torch.Tensor, mask: torch.Tensor, beta, gap,
                              ext) -> torch.Tensor:
    """The optimizer's 7-state LA kernel (M/IX/IY/LX/LY/RX/RY), batched.

    A different kernel from :func:`local_alignment_exp`: the reference's
    BPLA_Forward (bpla_kernel.cpp:179-244) enters M from explicit flanking
    states whose counts depend on the position (LX[i][j] = 1, LY[i][j] = j
    for i >= 1; row 0 has LX = [1, 0, ...], LY = 1), and bpla_optimizer
    fits its parameters against this value, 1 + sum_{i,j} M[i][j].  beta,
    gap and ext are scalars or (B,) tensors; the value is differentiable in
    them and in ``scores``.
    """
    return _exp_scan(scores, mask, beta, gap, ext, flank=True)


def bpla_kernel_batch(w_pair: torch.Tensor, w_unpair: torch.Tensor, mask: torch.Tensor,
                      params, *, with_grads: bool = False, flank: bool = True):
    """BPLA kernel values (B,), and with ``with_grads`` also dK/dparams (B, 4).

    params = (alpha, beta, gap, ext), scores = alpha*w_pair + w_unpair;
    ``flank`` picks the 7-state kernel (the optimizer's) or the 5-state one.
    The parameters are tiled to (B, 4), so each pair's value depends only on
    its own row, and one backward pass of the summed values gives every
    pair's gradient.
    """
    bsz = w_pair.shape[0]
    p_tiled = torch.as_tensor(params, dtype=w_pair.dtype, device=w_pair.device
                              ).reshape(1, 4).expand(bsz, 4).clone()

    la = local_alignment_exp_flank if flank else local_alignment_exp

    def values(p):
        return la(p[:, 0, None, None] * w_pair + w_unpair, mask, p[:, 1], p[:, 2], p[:, 3])

    if not with_grads:
        with torch.no_grad():
            return values(p_tiled)
    p_tiled.requires_grad_(True)
    with torch.enable_grad():
        vals = values(p_tiled)
        (grads,) = torch.autograd.grad(vals.sum(), p_tiled)
    return vals.detach(), grads


def local_alignment_log(scores: torch.Tensor, mask: torch.Tensor, beta: float,
                        gap: float, ext: float) -> torch.Tensor:
    """log of :func:`local_alignment_exp`, overflow-safe for long sequences:
    the same recursion with (logaddexp, +) in place of (+, *)."""
    bsz, lx, ly = scores.shape
    b = torch.tensor(float(beta), dtype=torch.float32)
    lbg = (b * _f32(gap)).item()
    lbe = (b * _f32(ext)).item()
    ls = torch.where(mask, b.item() * scores,
                     torch.full((), NEG_LARGE, dtype=scores.dtype, device=scores.device))
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    neg_col = torch.full((bsz, 1), NEG_LARGE, dtype=scores.dtype, device=scores.device)
    m_prev = torch.full((bsz, ly + 1), NEG_LARGE, dtype=scores.dtype, device=scores.device)
    x_prev = m_prev.clone()
    y_prev = m_prev.clone()
    acc = torch.full((bsz,), NEG_LARGE, dtype=scores.dtype, device=scores.device)
    for i in range(lx):
        diag = torch.logaddexp(zero, torch.logaddexp(
            m_prev[:, :-1], torch.logaddexp(x_prev[:, :-1], y_prev[:, :-1])))
        m_row = torch.cat([neg_col, ls[:, i] + diag], dim=-1)
        x_row = torch.logaddexp(lbg + m_prev, lbe + x_prev)
        q = lbg + torch.logaddexp(m_row[:, :-1], x_row[:, :-1])
        y_row = torch.cat([neg_col, logsumexp_recurrence(lbe, q)], dim=-1)
        acc = torch.logaddexp(acc, torch.logsumexp(m_row, dim=-1))
        m_prev, x_prev, y_prev = m_row, x_row, y_row
    return torch.logaddexp(zero, acc)


def local_alignment_max(scores: torch.Tensor, mask: torch.Tensor, gap: float,
                        ext: float) -> torch.Tensor:
    """Smith-Waterman maximum local-alignment score (B,)."""
    bsz, lx, ly = scores.shape
    gap, ext = _f32(gap), _f32(ext)
    zero_col = torch.zeros(bsz, 1, dtype=scores.dtype, device=scores.device)
    m_prev = torch.zeros(bsz, ly + 1, dtype=scores.dtype, device=scores.device)
    x_prev = torch.zeros_like(m_prev)
    y_prev = torch.zeros_like(m_prev)
    best = torch.zeros(bsz, dtype=scores.dtype, device=scores.device)
    maskf = mask.to(scores.dtype)
    for i in range(lx):
        diag = torch.clamp(torch.maximum(m_prev[:, :-1], torch.maximum(
            x_prev[:, :-1], y_prev[:, :-1])), min=0.0)
        m_row = torch.cat([zero_col, diag + scores[:, i]], dim=-1)
        x_row = torch.maximum(m_prev + gap, x_prev + ext)
        q = torch.maximum(m_row[:, :-1], x_row[:, :-1]) + gap
        y_row = torch.cat([zero_col, maxplus_recurrence(ext, q)], dim=-1)
        mrow = maskf[:, i]
        best = torch.maximum(best, (m_row[:, 1:] * mrow + NEG_LARGE * (1 - mrow)).amax(-1))
        m_prev, x_prev, y_prev = m_row, x_row, y_row
    return torch.clamp(best, min=0.0)


def bpla_profiles(bpp: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p_left, p_right, p_unpair) from a base-pair probability matrix.

    bpp is upper-triangular with bpp[i, j] = P(i pairs j), i < j, 0-based.
    p_left[i] = sqrt(sum_{j>i} bpp[i,j]); p_right[i] = sqrt(sum_{j<i} bpp[j,i]);
    p_unpair[i] = sqrt(max(0, 1 - p_left^2 - p_right^2)).
    """
    left = np.triu(bpp, 1).sum(axis=1)
    right = np.triu(bpp, 1).sum(axis=0)
    unpair = np.clip(1.0 - left - right, 0.0, None)
    return (
        np.sqrt(left).astype(np.float32),
        np.sqrt(right).astype(np.float32),
        np.sqrt(unpair).astype(np.float32),
    )


# Default tuned score table of the bpla_kernel CLI.
DEFAULT_BPLA_SCORE_TABLE = np.array(
    [
        [5.846613, -1.860000, -1.460000, -1.390000],
        [-1.860000, 4.786613, -2.480000, -1.050000],
        [-1.460000, -2.480000, 4.656613, -1.740000],
        [-1.390000, -1.050000, -1.740000, 5.276613],
    ],
    dtype=np.float32,
)


class BPLAKernel(nn.Module):
    """Configured BPLA kernel mirroring the reference CLI surface.

    Flags: ``no_bp`` (plain LA kernel), ``sw`` (max variant); defaults
    gap=-8.0, ext=-0.75, alpha=4.5, beta=0.11.  ``forward`` is K(x, y),
    ``log_value`` log K(x, y); x and y are dicts of gathered feature tensors
    (``profile``, ``p_left``, ``p_right``, ``p_unpair``, int32 ``length``).
    The score table is a buffer, so ``.to(device)`` moves it.
    """

    def __init__(self, score_table: np.ndarray | None = None, *, no_bp: bool = False,
                 sw: bool = False, gap: float = -8.0, ext: float = -0.75,
                 alpha: float = 4.5, beta: float = 0.11) -> None:
        super().__init__()
        table = DEFAULT_BPLA_SCORE_TABLE if score_table is None else score_table
        self.register_buffer("score_table", torch.as_tensor(np.asarray(table, np.float32)))
        self.no_bp = no_bp
        self.sw = sw
        self.gap = gap
        self.ext = ext
        self.alpha = alpha
        self.beta = beta

    @property
    def _factored_ok(self) -> bool:
        """The factored kernels hold 2 pair + N substitution factor slots,
        at most 6; larger score tables take the materialised kernels."""
        return 2 + self.score_table.shape[1] <= 6

    def score_parts(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        """(w_pair, w_unpair) so scores = alpha*w_pair + w_unpair."""
        if self.no_bp:
            px, py = x["profile"], y["profile"]
            zero = torch.zeros(px.shape[0], px.shape[1], py.shape[1], device=px.device)
            return zero, la_score_matrix(px, py, self.score_table)
        return bpla_score_parts(
            x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
            y["profile"], y["p_left"], y["p_right"], y["p_unpair"],
            self.score_table,
        )

    def scores(self, x, y) -> torch.Tensor:
        """Score tensor (B, Lx, Ly) for batches of BPLA features."""
        w_pair, w_unpair = self.score_parts(x, y)
        return _f32(self.alpha) * w_pair + w_unpair

    def factors(self, d, side: str) -> torch.Tensor:
        """(B, L, 2+N) low-rank score factors for one side, the span
        ``bpla.factors``."""
        prof = d["profile"]
        with span("bpla.factors"):
            if self.no_bp:
                zero = torch.zeros_like(prof[..., 0])
                return bpla_factors(prof, zero, zero, torch.ones_like(zero),
                                    self.score_table, side=side)
            return bpla_factors(prof, d["p_left"], d["p_right"], d["p_unpair"],
                                self.score_table, side=side)

    def _max(self, x, y) -> torch.Tensor:
        s = self.scores(x, y)
        mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
        return local_alignment_max(s, mask, self.gap, self.ext)

    def forward(self, x, y) -> torch.Tensor:
        if self.sw:
            return self._max(x, y)
        if self._factored_ok:
            return la_exp_factored(self.factors(x, "x"), self.factors(y, "y"),
                                   x["length"], y["length"],
                                   self.alpha, self.beta, self.gap, self.ext)
        wp, wu = self.score_parts(x, y)
        return la_exp_affine_auto(wp, wu, x["length"], y["length"],
                                  self.alpha, self.beta, self.gap, self.ext)

    def log_value(self, x, y) -> torch.Tensor:
        """log K(x, y): the overflow-safe path for long sequences."""
        if self.sw:
            return torch.log(torch.clamp(self._max(x, y), min=1e-300))
        if self._factored_ok:
            return la_log_factored(self.factors(x, "x"), self.factors(y, "y"),
                                   x["length"], y["length"],
                                   self.alpha, self.beta, self.gap, self.ext)
        wp, wu = self.score_parts(x, y)
        return la_log_affine_auto(wp, wu, x["length"], y["length"],
                                  self.alpha, self.beta, self.gap, self.ext)
