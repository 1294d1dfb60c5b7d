"""Gap-weighted profile string kernel, batched in torch.

Port of ``stem_kernel_tpu/models/string_kernel.py`` (profile string kernel
of stem_kernel/stem_kernel_lite/string_kernel.cpp:66-132):

    v        = G0[i-1][j-1] * w_x[i-1] * w_y[j-1] * subst(x[i-1], y[j-1])
    K1[j]    = v + K1[j-1]
    G1[j]    = v + G1[j-1]*gap
    K0[i][j] = K1[j] + K0[i-1][j]
    G0[i][j] = G1[j] + G0[i-1][j]*gap

with K0[*][0] = K0[0][*] = 1 and the G0 boundary gap^i / gap^j; the result
is K0[|x|][|y|].

Routing: a CPU tensor takes the plain version: the per-cell scores as one
(B, Lx, Ly) tensor and the row recursion as a Python loop over rows, each
row's G1 recurrence a product with the (Ly, Ly) Toeplitz matrix of gap
powers (:mod:`..ops.recurrence`), exact at any length
(:func:`gap_weighted_string_kernel_reference`, :meth:`StringKernel.reference`).
A CUDA tensor launches the hand-written kernel of :mod:`..ops.string_dp`,
one launch a call, or raises: ``StringKernel`` builds the scores in the
kernel, :func:`gap_weighted_string_kernel` hands it its score tensor.
Nothing falls back, and the kernel has no backward.  The counters
(utils.tracing): ``string.calls`` every call, ``string.rows`` the plain
loop's trips, ``string.calls.kernel`` and ``string.pairs.kernel`` the
kernel's launches and pairs.

The plain exact-match string kernel (string_kernel/string_kernel.cpp:11-51)
is the same recursion with v = G0[i-1][j-1] * gap^2 * [x_i == y_j]
(:func:`exact_match_scores`, :func:`plain_string_kernel`).

Padding contract: with the score tensor zero outside each pair's valid
region, the value at the padded corner equals the value at the true corner.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..io.alphabet import N_RNA
from ..ops.recurrence import linear_recurrence, toeplitz_powers
from ..ops.string_dp import string_dp_profile, string_dp_scores
from ..utils.tracing import count
from .ribosum_data import RIBOSUM_S


def ribosum_subst_table(alpha: float) -> np.ndarray:
    """exp(RIBOSUM_S * alpha) — StringKernel ctor, string_kernel.cpp:11-21."""
    return np.exp(RIBOSUM_S * alpha).astype(np.float32)


def match_mismatch_table(match: float, mismatch: float) -> np.ndarray:
    """match on the diagonal, mismatch elsewhere (string_kernel.cpp:23-34)."""
    t = np.full((N_RNA, N_RNA), mismatch, dtype=np.float32)
    np.fill_diagonal(t, match)
    return t


def profile_subst_scores(px: torch.Tensor, py: torch.Tensor,
                         subst: torch.Tensor) -> torch.Tensor:
    """Expected substitution score between profile columns, (B, Lx, Ly).

    Entry [b, i, j] is sum_ab subst[a,b] px[i,a] py[j,b] / sum_ab px[i,a]
    py[j,b], and 1.0 where the normalizer is zero (all-gap column), as
    subst_score at stem_kernel/stem_kernel_lite/string_kernel.cpp:44-64.
    """
    num = torch.einsum("nia,ab,njb->nij", px, subst, py)
    den = torch.einsum("nia,njb->nij", px, py)
    zero = den == 0
    return torch.where(zero, torch.ones_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


def masked_profile_scores(px, lx, py, ly, wx, wy, subst: torch.Tensor) -> torch.Tensor:
    """StringKernel's (B, Lx, Ly) scores: :func:`profile_subst_scores` times
    wx[i] wy[j], zero outside either length."""
    scores = profile_subst_scores(px, py, subst)
    scores = scores * (wx[:, :, None] * wy[:, None, :])
    mask_x = torch.arange(px.shape[1], device=px.device)[None, :] < lx[:, None]
    mask_y = torch.arange(py.shape[1], device=py.device)[None, :] < ly[:, None]
    return scores * (mask_x[:, :, None] & mask_y[:, None, :])


def gap_weighted_string_kernel(scores: torch.Tensor, gap: float) -> torch.Tensor:
    """K0[Lx][Ly] for a (B, Lx, Ly) score tensor (already zero-masked): the
    plain row loop on the CPU, the kernel on the card."""
    count("string.calls")
    if scores.device.type == "cpu":
        return gap_weighted_string_kernel_reference(scores, gap)
    return string_dp_scores(scores, gap)


def gap_weighted_string_kernel_reference(scores: torch.Tensor, gap: float) -> torch.Tensor:
    """The plain version of :func:`gap_weighted_string_kernel`, on any device."""
    bsz, lx, ly = scores.shape
    count("string.rows", lx)  # the row loop's trips
    dt, dev = scores.dtype, scores.device
    gap = float(gap)
    tmat = toeplitz_powers(gap, ly, dtype=dt, device=dev)
    k0 = torch.ones((bsz, ly + 1), dtype=dt, device=dev)
    g0 = (torch.tensor(gap, dtype=dt, device=dev)
          ** torch.arange(ly + 1, dtype=dt, device=dev)).expand(bsz, ly + 1)
    ones_col = torch.ones((bsz, 1), dtype=dt, device=dev)
    for i in range(lx):
        v = g0[:, :-1] * scores[:, i, :]  # v[j] uses G0[i-1][j-1]
        k1 = torch.cumsum(v, dim=-1)
        g1 = linear_recurrence(gap, v, matrix=tmat)
        k0 = torch.cat([ones_col, k1 + k0[:, 1:]], dim=-1)
        g0 = torch.cat([g0[:, :1] * gap, g1 + gap * g0[:, 1:]], dim=-1)
    return k0[:, -1]


class StringKernel(nn.Module):
    """Profile string kernel with RIBOSUM or match/mismatch substitution.

    ``subst`` is a buffer, so ``.to(device)`` moves it with the module.
    """

    def __init__(self, gap: float, *, alpha: float | None = None,
                 match: float | None = None, mismatch: float | None = None,
                 subst: np.ndarray | None = None) -> None:
        super().__init__()
        if subst is None:
            if alpha is not None:
                subst = ribosum_subst_table(alpha)
            elif match is not None and mismatch is not None:
                subst = match_mismatch_table(match, mismatch)
            else:
                raise ValueError("need alpha, (match, mismatch) or subst")
        self.register_buffer("subst", torch.tensor(np.asarray(subst, np.float32)))
        self.gap = float(gap)

    def forward(self, px, lx, py, ly, wx=None, wy=None) -> torch.Tensor:
        """Kernel values for a batch of pairs.

        px, py: (B, L, N_RNA) profiles; lx, ly: (B,) true lengths;
        wx, wy: (B, L) position weights or None (treated as 1).
        """
        wx, wy = _weights(px, wx), _weights(py, wy)
        if px.device.type == "cpu":
            return gap_weighted_string_kernel(
                masked_profile_scores(px, lx, py, ly, wx, wy, self.subst), self.gap)
        count("string.calls")
        return string_dp_profile(px, py, self.subst, wx, wy, lx, ly, self.gap)

    def reference(self, px, lx, py, ly, wx=None, wy=None) -> torch.Tensor:
        """The plain version of :meth:`forward`, on any device."""
        wx, wy = _weights(px, wx), _weights(py, wy)
        return gap_weighted_string_kernel_reference(
            masked_profile_scores(px, lx, py, ly, wx, wy, self.subst), self.gap)


def _weights(p: torch.Tensor, w):
    """Position weights (B, L): ``w``, or ones where it is None."""
    return torch.ones(p.shape[:2], dtype=p.dtype, device=p.device) if w is None else w


def exact_match_scores(x: torch.Tensor, lx: torch.Tensor, y: torch.Tensor,
                       ly: torch.Tensor, gap: float) -> torch.Tensor:
    """Score tensor (B, Lx, Ly) of the plain string kernel: gap^2 where the
    codes match inside both lengths, 0 elsewhere.

    x, y: (B, L) uint8 codes of ungapped padded sequences; the gap^2 factor
    folds the two matched characters' gap weights
    (string_kernel/string_kernel.cpp:42-44) into the scores.
    """
    eq = (x[:, :, None] == y[:, None, :]).to(torch.float32)
    mask_x = torch.arange(x.shape[1], device=x.device)[None, :] < lx[:, None]
    mask_y = torch.arange(y.shape[1], device=y.device)[None, :] < ly[:, None]
    valid = (mask_x[:, :, None] & mask_y[:, None, :]).to(torch.float32)
    return eq * valid * torch.tensor(float(gap), dtype=torch.float32, device=x.device) ** 2


def plain_string_kernel(x, lx, y, ly, gap: float) -> torch.Tensor:
    """The string_kernel binary's kernel (B,) on encoded sequences."""
    return gap_weighted_string_kernel(exact_match_scores(x, lx, y, ly, gap), gap)
